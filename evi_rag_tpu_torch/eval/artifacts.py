"""Stage hand-off artifacts: g_agent store, top-k edges, rollout records.

Counterpart of ``evi_rag_tpu/eval/artifacts.py`` (numpy and JSON only):

* ``save_agent_store`` / ``load_agent_store`` -- the ``<split>_g_agent``
  artifact as a ``SampleStore`` of ``AgentSample`` records;
* ``write_topk_edges`` -- ``eval_retriever/<split>.jsonl`` of per-sample
  ``triplets_by_k`` records with fwd/bwd logits;
* ``write_rollout_records`` -- ``eval_gflownet/<split>.jsonl`` rollout +
  candidate-chain records.

Each artifact ships a ``<split>.manifest.json`` with artifact /
schema_version / file, validated by consumers.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from datetime import datetime, timezone
from typing import Any, Iterable, Sequence

import numpy as np

from evi_rag_tpu_torch.data.chains import chains_from_rollouts, textualize_chain
from evi_rag_tpu_torch.data.g_agent import AgentSample
from evi_rag_tpu_torch.data.store import SampleStore, SampleStoreWriter

AGENT_ARTIFACT = "g_agent"
TOPK_ARTIFACT = "eval_retriever_topk"
ROLLOUT_ARTIFACT = "eval_gflownet_rollouts"
SCHEMA_VERSION = 1


def write_manifest(
    dir_path: pathlib.Path, *, artifact: str, filename: str, split: str, extra: dict | None = None
) -> None:
    manifest = {
        "artifact": artifact,
        "schema_version": SCHEMA_VERSION,
        "file": filename,
        "split": split,
        "created_at": datetime.now(timezone.utc).isoformat(timespec="seconds"),
        "producer": "evi_rag_tpu_torch",
        **(extra or {}),
    }
    (pathlib.Path(dir_path) / f"{split}.manifest.json").write_text(json.dumps(manifest, indent=2))


def validate_manifest(
    dir_path: pathlib.Path, *, artifact: str, split: str
) -> dict[str, Any]:
    path = pathlib.Path(dir_path) / f"{split}.manifest.json"
    if not path.exists():
        raise FileNotFoundError(f"manifest missing: {path}")
    m = json.loads(path.read_text())
    if m.get("artifact") != artifact:
        raise ValueError(f"manifest artifact {m.get('artifact')!r} != {artifact!r}")
    if int(m.get("schema_version", -1)) != SCHEMA_VERSION:
        raise ValueError(f"manifest schema_version {m.get('schema_version')} != {SCHEMA_VERSION}")
    if not (pathlib.Path(dir_path) / m["file"]).exists():
        raise FileNotFoundError(f"manifest points at missing file: {m['file']}")
    return m


def save_agent_store(
    samples: Sequence[AgentSample], path: str | pathlib.Path, *, split: str, settings_meta: dict | None = None
) -> pathlib.Path:
    w = SampleStoreWriter(path)
    for s in samples:
        w.add(
            s.sample_id,
            {
                "question_id": s.question_id,
                "num_nodes": s.num_nodes,
                "edge_head_locals": s.edge_head_locals.astype(np.int32),
                "edge_tail_locals": s.edge_tail_locals.astype(np.int32),
                "edge_relations": s.edge_relations.astype(np.int64),
                "edge_scores": s.edge_scores.astype(np.float32),
                "edge_labels": s.edge_labels.astype(np.float32),
                "node_entity_ids": s.node_entity_ids.astype(np.int64),
                "node_embedding_ids": s.node_embedding_ids.astype(np.int64),
                "start_entity_ids": s.start_entity_ids.astype(np.int64),
                "answer_entity_ids": s.answer_entity_ids.astype(np.int64),
                "start_node_locals": s.start_node_locals.astype(np.int32),
                "answer_node_locals": s.answer_node_locals.astype(np.int32),
                "pair_start_local": s.pair_start_local.astype(np.int32),
                "pair_answer_local": s.pair_answer_local.astype(np.int32),
                "pair_shortest_len": s.pair_shortest_len.astype(np.int32),
                "is_answer_reachable": bool(s.is_answer_reachable),
                "is_dummy_agent": bool(s.is_dummy_agent),
            },
        )
    return w.finalize(
        artifact=AGENT_ARTIFACT, schema_version=SCHEMA_VERSION,
        extra={"split": split, "settings": settings_meta or {}},
    )


def load_agent_store(
    path: str | pathlib.Path, *, drop_unreachable: bool = False
) -> list[AgentSample]:
    """Strictly-validated agent sample load (reference ``_parse_sample``,
    ``g_agent_dataset.py:96-297``); train always drops unreachable
    (``g_agent_datamodule.py:127-129``)."""
    store = SampleStore(path, expected_artifact=AGENT_ARTIFACT, expected_schema_version=SCHEMA_VERSION)
    out: list[AgentSample] = []
    for sid, rec in store.iter_records():
        s = AgentSample(
            sample_id=sid,
            question_id=int(rec["question_id"]),
            num_nodes=int(rec["num_nodes"]),
            edge_head_locals=rec["edge_head_locals"].astype(np.int64),
            edge_tail_locals=rec["edge_tail_locals"].astype(np.int64),
            edge_relations=rec["edge_relations"],
            edge_scores=rec["edge_scores"],
            edge_labels=rec["edge_labels"],
            node_entity_ids=rec["node_entity_ids"],
            node_embedding_ids=rec["node_embedding_ids"],
            start_entity_ids=rec["start_entity_ids"],
            answer_entity_ids=rec["answer_entity_ids"],
            start_node_locals=rec["start_node_locals"].astype(np.int64),
            answer_node_locals=rec["answer_node_locals"].astype(np.int64),
            pair_start_local=rec["pair_start_local"].astype(np.int64),
            pair_answer_local=rec["pair_answer_local"].astype(np.int64),
            pair_shortest_len=rec["pair_shortest_len"].astype(np.int64),
            is_answer_reachable=bool(rec["is_answer_reachable"]),
            is_dummy_agent=bool(rec["is_dummy_agent"]),
        )
        _validate_agent_sample(s)
        if drop_unreachable and not s.is_answer_reachable:
            continue
        out.append(s)
    return out


def _validate_agent_sample(s: AgentSample) -> None:
    # Single source of truth: the dataclass's strict validator
    # (reference ``_parse_sample`` depth, ``g_agent_dataset.py:96-297``).
    s.validate()


def write_topk_edges(
    records: Iterable[dict[str, Any]],
    out_dir: str | pathlib.Path,
    *,
    split: str,
    k_values: Sequence[int],
) -> pathlib.Path:
    """Stream per-sample ``triplets_by_k`` records to jsonl + manifest.

    Each record: sample_id, and per k the top-k (head, rel, tail, score,
    logit_fwd, logit_bwd) tuples (reference ``retriever_topk_edge_writer``).
    """
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{split}.jsonl"
    n = 0
    with path.open("w") as f:
        for rec in records:
            f.write(json.dumps(rec, default=_json_default) + "\n")
            n += 1
    write_manifest(
        out_dir, artifact=TOPK_ARTIFACT, filename=path.name, split=split,
        extra={"k_values": list(map(int, k_values)), "num_samples": n},
    )
    return path


def topk_record_for_sample(
    *,
    sample_id: str,
    scores: np.ndarray,
    logits_fwd: np.ndarray,
    logits_bwd: np.ndarray,
    heads_global: np.ndarray,
    rels: np.ndarray,
    tails_global: np.ndarray,
    k_values: Sequence[int],
    labels: np.ndarray | None = None,
    answer_entity_ids: np.ndarray | None = None,
    question: str | None = None,
    id2entity: dict[int, str] | None = None,
    id2relation: dict[int, str] | None = None,
) -> dict[str, Any]:
    """Per-edge records use the reference writer's schema
    (``retriever_topk_edge_writer.py:332-350``): head/relation/tail entity
    ids + optional vocab texts, score, label, 1-based rank, fwd/bwd logits.
    ``edge_idx`` (the sample-local edge id) and ``num_edges`` are additive
    extras a reference consumer can ignore."""
    order = np.argsort(-scores, kind="stable")

    def text(mapping: dict[int, str] | None, key: int) -> str | None:
        return None if mapping is None else mapping.get(key)

    out: dict[str, Any] = {
        "sample_id": sample_id,
        "question": question,
        "num_edges": int(scores.shape[0]),
        "triplets_by_k": {},
        "answer_entity_ids": (
            [int(a) for a in answer_entity_ids] if answer_entity_ids is not None else []
        ),
    }
    for k in k_values:
        kk = min(int(k), order.size)
        idx = order[:kk]
        out["triplets_by_k"][str(int(k))] = [
            {
                "edge_idx": int(i),
                "head_entity_id": int(heads_global[i]),
                "relation_id": int(rels[i]),
                "tail_entity_id": int(tails_global[i]),
                "head_text": text(id2entity, int(heads_global[i])),
                "relation_text": text(id2relation, int(rels[i])),
                "tail_text": text(id2entity, int(tails_global[i])),
                "score": float(scores[i]),
                "label": float(labels[i]) if labels is not None else None,
                "rank": int(rank + 1),
                "logit_fwd": float(logits_fwd[i]),
                "logit_bwd": float(logits_bwd[i]),
            }
            for rank, i in enumerate(idx)
        ]
    return out


def write_rollout_records(
    records: Iterable[dict[str, Any]],
    out_dir: str | pathlib.Path,
    *,
    split: str,
    num_rollouts: int,
) -> pathlib.Path:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{split}.jsonl"
    n = 0
    with path.open("w") as f:
        for rec in records:
            f.write(json.dumps(rec, default=_json_default) + "\n")
            n += 1
    write_manifest(
        out_dir, artifact=ROLLOUT_ARTIFACT, filename=path.name, split=split,
        extra={"num_rollouts": int(num_rollouts), "num_samples": n},
    )
    return path


def rollout_record_for_sample(
    sample: AgentSample,
    *,
    actions_local: np.ndarray,     # [R, T] sample-local edge ids (-1 STOP)
    directions: np.ndarray,        # [R, T]
    answer_hits: np.ndarray,       # [R]
    id2entity: dict[int, str] | None = None,
    id2relation: dict[int, str] | None = None,
    max_chains: int = 100,
) -> dict[str, Any]:
    """One eval_gflownet jsonl record: rollouts + aggregated candidate chains."""
    chains = chains_from_rollouts(
        actions_seqs=actions_local,
        directions_seqs=directions,
        heads=sample.edge_head_locals,
        tails=sample.edge_tail_locals,
        relations=sample.edge_relations,
        scores=sample.edge_scores,
        node_entity_ids=sample.node_entity_ids,
        max_chains=max_chains,
    )
    if id2entity is not None and id2relation is not None:
        for c in chains:
            c["chain_text"] = textualize_chain(c, id2entity=id2entity, id2relation=id2relation)
    return {
        "sample_id": sample.sample_id,
        "num_rollouts": int(actions_local.shape[0]),
        "answer_hit_rate": float(np.mean(answer_hits.astype(np.float32))),
        "rollouts": [
            {
                "actions": [int(a) for a in actions_local[r] if a >= 0],
                "directions": [int(d) for a, d in zip(actions_local[r], directions[r]) if a >= 0],
                "answer_hit": bool(answer_hits[r]),
            }
            for r in range(actions_local.shape[0])
        ],
        "candidate_chains": [
            {k: v for k, v in c.items() if k != "signature"} for c in chains
        ],
    }


def _json_default(o: Any):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    return str(o)
