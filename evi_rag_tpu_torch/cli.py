"""Command line of the port: the ``serve`` task.

Usage::

    python -m evi_rag_tpu_torch.cli serve [--configs-dir configs] [key=value ...]

Counterpart of ``evi_rag_tpu/cli.py``'s ``serve`` task with the same
``serve.*`` keys, the same ``configs/`` directory, and the same outputs in
the run dir: ``<split>_serve.jsonl``, ``<split>.manifest.json`` and
``metrics.json``.  ``retriever.ckpt`` names a checkpoint in the port's format
(``train/checkpoint.py``).  ``dataset.source`` is ``synthetic`` or
``normalized`` (a materialized split from the JAX package's ``build``).
``device=cpu`` runs on the CPU; the default is the GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Any, Callable

import numpy as np
import torch

from evi_rag_tpu_torch.utils.config import ConfigError, get_dotted, load_config
from evi_rag_tpu_torch.utils.logging import get_logger, save_metrics_json
from evi_rag_tpu_torch.utils.run_context import make_run_dir, task_wrapper

log = get_logger("evi_rag_tpu_torch.cli")

DEFAULT_K_GRID = (1, 10, 25, 50, 100, 200, 300, 400, 500)


def _load_split(cfg: dict, split: str):
    """-> (samples, entity_emb, relation_emb, question_emb)."""
    ds = cfg.get("dataset", {})
    source = ds.get("source", "synthetic")
    if source == "synthetic":
        from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset

        seed = {"train": 0, "validation": 1, "test": 2}.get(split, 3) + int(ds.get("seed", 0))
        synth = make_synthetic_dataset(
            num_samples=int(ds.get("num_samples", 64)),
            emb_dim=int(ds.get("emb_dim", 64)),
            max_nodes=int(ds.get("max_nodes", 24)),
            seed=seed,
        )
        return synth.samples, synth.entity_emb, synth.relation_emb, synth.question_emb
    if source == "normalized":
        from evi_rag_tpu_torch.data.pipeline import load_retrieval_split

        root = pathlib.Path(ds["normalized_dir"])
        filter_ids = None
        if ds.get("filter"):
            payload = json.loads((root / ds["filter"]).read_text())
            filter_ids = set(payload["sample_ids"])
        samples, q_emb = load_retrieval_split(
            root, split, filter_ids=filter_ids,
            sample_limit=ds.get("sample_limit"), seed=int(ds.get("seed", 0)),
        )
        # Memory-map the embedding tables (dataset.mmap=false opts out).
        mode = "r" if ds.get("mmap", True) else None
        entity_emb = np.load(root / "embeddings" / "entity_embeddings.npy", mmap_mode=mode)
        relation_emb = np.load(root / "embeddings" / "relation_embeddings.npy", mmap_mode=mode)
        return samples, entity_emb, relation_emb, q_emb
    raise ConfigError(f"unknown dataset.source {source!r}")


def _vocab_maps(cfg: dict) -> tuple[dict[int, str], dict[int, str]]:
    """entity_id->label, relation_id->label from the normalized vocab parquet."""
    ds = cfg.get("dataset", {})
    if ds.get("source") != "normalized":
        return {}, {}
    import pyarrow.parquet as pq

    root = pathlib.Path(ds["normalized_dir"])
    ents = pq.read_table(root / "entity_vocab.parquet").to_pylist()
    rels = pq.read_table(root / "relation_vocab.parquet").to_pylist()
    return (
        {int(e["entity_id"]): str(e["label"]) for e in ents},
        {int(r["relation_id"]): str(r["label"]) for r in rels},
    )


def _parity_meta(cfg: dict) -> dict[str, int]:
    """The retriever's feature-geometry contract, from ``retriever.model``."""
    m = cfg.get("retriever", {}).get("model", {})
    return {
        "use_topic_pe": 1,
        "num_topics": 2,
        "dde_rounds": int(m.get("dde_rounds", 2)),
        "dde_reverse_rounds": int(m.get("dde_reverse_rounds", 2)),
    }


def _load_retriever_ckpt(cfg: dict) -> tuple[Any, dict]:
    from evi_rag_tpu_torch.train.checkpoint import load_checkpoint

    ckpt = get_dotted(cfg, "retriever.ckpt")
    if not ckpt:
        raise ConfigError("retriever.ckpt is required")
    tree, meta = load_checkpoint(ckpt)
    return tree["params"], meta


@task_wrapper
def task_serve(cfg: dict, *, run_dir: pathlib.Path) -> dict[str, Any]:
    """Checkpoint -> pre-projected index -> batched per-question top-k over
    each split, with measured q/s and triple recall@k."""
    from evi_rag_tpu_torch.eval.artifacts import write_manifest
    from evi_rag_tpu_torch.serving import project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, export_retriever_features
    from evi_rag_tpu_torch.utils.device import resolve_device

    device = resolve_device(cfg.get("device"))
    sv = cfg.get("serve", {})
    splits = list(sv.get("splits", ["test"]))
    k = int(sv.get("k", 100))
    group_size = int(sv.get("group_size", 16))
    dtype = torch.bfloat16 if str(sv.get("compute_dtype", "bfloat16")) == "bfloat16" else torch.float32
    k_grid = [int(v) for v in sv.get("k_values", DEFAULT_K_GRID) if int(v) <= k]
    if bool(sv.get("data_parallel", False)):
        raise NotImplementedError("serve.data_parallel is not ported yet")

    first_samples, ent, rel, q = _load_split(cfg, splits[0])
    params, _meta = _load_retriever_ckpt(cfg)
    exported = export_retriever_features(params, _parity_meta(cfg))
    bundle = {"features": bundle_from_numpy(exported["features"], device=device),
              "parity_meta": exported["parity_meta"]}
    pm = bundle["parity_meta"]

    t_proj = time.perf_counter()
    tables = project_tables(bundle, ent, rel, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    proj_s = round(time.perf_counter() - t_proj, 4)
    ent2label, rel2label = _vocab_maps(cfg)

    out: dict[str, Any] = {}
    for si, split in enumerate(splits):
        samples, ent_s, rel_s, q_emb = (
            (first_samples, ent, rel, q) if si == 0 else _load_split(cfg, split)
        )
        if not samples:
            continue
        # Normalized datasets share one table file across splits; synthetic
        # splits regenerate their tables per split.
        shares_tables = (
            cfg.get("dataset", {}).get("source") == "normalized"
            or (ent_s is ent and rel_s is rel)
        )
        split_tables = tables if shares_tables else None
        results, stats = serve_split(
            bundle, samples,
            entity_emb=ent_s, relation_emb=rel_s, question_emb=q_emb,
            k=k, num_rounds=int(pm["dde_rounds"]),
            num_reverse_rounds=int(pm["dde_reverse_rounds"]),
            group_size=group_size, dtype=dtype, projected=split_tables,
            fused_threshold=int(sv.get("fused_threshold", 256)),
            warmup=sv.get("warmup"), device=device,
        )
        out[f"{split}/num_questions"] = stats.num_questions
        out[f"{split}/queries_per_s"] = stats.queries_per_s
        out[f"{split}/scoring_s"] = stats.scoring_s
        out[f"{split}/index_build_s"] = (
            proj_s if split_tables is not None else stats.index_build_s
        )
        out[f"{split}/pack_s"] = stats.pack_s
        out[f"{split}/dispatch_s"] = stats.dispatch_s
        out[f"{split}/drain_s"] = stats.drain_s
        out[f"{split}/compile_s"] = stats.compile_s
        out.update({f"{split}/{m}": v for m, v in
                    serve_recall_at_k(samples, results, k_grid).items()})

        if bool(sv.get("write_jsonl", True)):
            by_id = {s.sample_id: s for s in samples}
            path = run_dir / f"{split}_serve.jsonl"
            with path.open("w") as f:
                for r in results:
                    s = by_id[r.sample_id]
                    ent_ids = (
                        s.node_entity_ids
                        if s.node_entity_ids is not None
                        else np.arange(s.num_nodes, dtype=np.int64)
                    )
                    triples = []
                    for e in r.edge_ids.tolist():
                        h = int(ent_ids[s.edge_index[0][e]])
                        rr = int(s.edge_relations[e])
                        t = int(ent_ids[s.edge_index[1][e]])
                        if ent2label:
                            triples.append([ent2label.get(h, str(h)), rel2label.get(rr, str(rr)),
                                            ent2label.get(t, str(t))])
                        else:
                            triples.append([h, rr, t])
                    f.write(json.dumps({
                        "sample_id": r.sample_id,
                        "scores": [round(float(v), 5) for v in r.scores.tolist()],
                        "triples": triples,
                    }) + "\n")
            write_manifest(
                run_dir, artifact="serve_topk", filename=path.name, split=split,
                extra={"k": k, "num_questions": stats.num_questions},
            )
            out[f"{split}/serve_jsonl"] = str(path)
    save_metrics_json(run_dir / "metrics.json", out)
    return out


TASKS: dict[str, Callable] = {
    "serve": task_serve,
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="evi-rag-tpu-torch")
    parser.add_argument("task", choices=sorted(TASKS))
    parser.add_argument("--configs-dir", default="configs")
    parser.add_argument("--config", default=None, help="base config name (defaults to the task name)")
    parser.add_argument("overrides", nargs="*", help="key=value overrides")
    # Intermixed: overrides may come before or after --configs-dir on every
    # Python 3 version (plain parse_args leaves them unrecognised on some).
    args = parser.parse_intermixed_args(argv)

    cfg = load_config(args.configs_dir, args.config or args.task, args.overrides)
    cfg.setdefault("task_name", args.task)
    cfg["_configs_dir"] = args.configs_dir
    run_dir = make_run_dir(cfg)
    log.info("task=%s run_dir=%s", args.task, run_dir)
    TASKS[args.task](cfg, run_dir=run_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
