"""Reasoner stage: evidence windows -> LLM/oracle answers -> metrics.

Copy of ``evi_rag_tpu/eval/reasoner.py`` on the port's ``AgentSample``
(the reference's ``reasoner_triplet_datamodule.py`` and
``reasoner_module.py:71-288``):

* ``build_triplet_records`` turns an agent sample into per-window-k prompt
  records: edges ranked by retriever score, k-window cut, token-budget
  binary-search truncation, and the semantic-dissipation flags --
  ``hit_set``/``hit_vis`` are True iff the (retrieved / visible) edge-id set
  is non-empty and contained in the shortest-path DAG edge set;
* ``build_path_records`` does the same over candidate chains (GFlowNet
  rollouts or the BFS baseline); a chain hits iff it is one of the per-pair
  shortest chains;
* ``run_reasoner`` executes llm|oracle mode, writes predictions ``.jsonl``
  and ``.metrics.json`` next to it; a backend with ``batch`` (the
  in-process ``local`` one) gets each chunk of ``max_batch`` records as one
  call, every other backend one record a call.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from evi_rag_tpu_torch.data.g_agent import AgentSample
from evi_rag_tpu_torch.eval.llm_client import ChatBackend, run_chat
from evi_rag_tpu_torch.eval.llm_metrics import evaluate_predictions
from evi_rag_tpu_torch.eval.oracle import aggregate_oracle_metrics, oracle_metrics_for_sample
from evi_rag_tpu_torch.eval.prompting import build_path_prompt, build_triplet_prompt, count_tokens

SYSTEM_PROMPT = (
    "You answer knowledge-graph questions strictly from the given evidence."
)


@dataclasses.dataclass(frozen=True)
class ReasonerSettings:
    window_k: tuple[int, ...] = (1, 10, 25, 50, 100, 200, 300, 400, 500)
    token_budget: int | None = None
    token_model: str = "gpt-4o-mini"
    path_limit: int = 10
    include_chain_meta: bool = False


def select_visible_prefix_by_budget(
    lines: Sequence[str], *, token_budget: int, token_model: str
) -> tuple[int, int, bool]:
    """Longest prefix of lines fitting the budget (binary search)."""
    if not lines:
        return 0, 0, False
    if token_budget <= 0:
        return 0, 0, True
    lo, hi, best, best_tokens = 0, len(lines), 0, 0
    while lo <= hi:
        mid = (lo + hi) // 2
        tokens = count_tokens("\n".join(lines[:mid]), model=token_model)
        if tokens <= token_budget:
            best, best_tokens = mid, tokens
            lo = mid + 1
        else:
            hi = mid - 1
    return best, best_tokens, best < len(lines)


def build_triplet_records(
    sample: AgentSample,
    *,
    question_text: str,
    gold_answers: list[str],
    id2entity: Mapping[int, str],
    id2relation: Mapping[int, str],
    settings: ReasonerSettings,
) -> list[dict[str, Any]]:
    """Per-window-k prompt records from score-ranked agent edges."""
    order = np.argsort(-sample.edge_scores, kind="stable")
    heads_txt = [id2entity[int(sample.node_entity_ids[h])] for h in sample.edge_head_locals[order]]
    tails_txt = [id2entity[int(sample.node_entity_ids[t])] for t in sample.edge_tail_locals[order]]
    rels_txt = [id2relation[int(r)] for r in sample.edge_relations[order]]
    dag_ids = {int(i) for i in np.nonzero(sample.edge_labels > 0.5)[0]}
    ranked_ids = [int(i) for i in order]

    records = []
    for k in settings.window_k:
        kk = min(int(k), len(ranked_ids))
        retrieved = ranked_ids[:kk]
        lines = [f"({heads_txt[i]}, {rels_txt[i]}, {tails_txt[i]})" for i in range(kk)]
        if settings.token_budget is None:
            visible_count = kk
            visible_tokens = count_tokens("\n".join(lines), model=settings.token_model)
            truncated = False
        else:
            visible_count, visible_tokens, truncated = select_visible_prefix_by_budget(
                lines, token_budget=settings.token_budget, token_model=settings.token_model
            )
        visible = retrieved[:visible_count]
        hit_set = bool(retrieved) and set(retrieved).issubset(dag_ids) if dag_ids else False
        hit_vis = bool(visible) and set(visible).issubset(dag_ids) if dag_ids else False
        triplets = [
            (heads_txt[i], rels_txt[i], tails_txt[i]) for i in range(visible_count)
        ]
        prompt = build_triplet_prompt(question_text, triplets, visible_count)
        records.append(
            {
                "id": sample.sample_id,
                "window_k": int(k),
                "question": question_text,
                "answers": gold_answers,
                "prompt": prompt,
                "visible_edge_ids": visible,
                "retrieved_edge_ids": retrieved,
                "hit_set": hit_set,
                "hit_vis": hit_vis,
                "evidence_token_count": visible_tokens,
                "prompt_token_count": count_tokens(prompt, model=settings.token_model),
                "token_budget": settings.token_budget or 0,
                "evidence_truncated": truncated,
            }
        )
    return records


def chain_is_shortest_hit(
    chain: Mapping[str, Any],
    *,
    pair_start_local: Sequence[int],
    pair_answer_local: Sequence[int],
    pair_shortest_len: Sequence[int],
) -> bool:
    """Does this chain realize some (start, answer) pair at its BFS-shortest
    length?  (Reference shortest-chain hit via the pair map,
    ``reasoner_path_dataset.py:349-406``.)"""
    edges = chain.get("chain_edges") or []
    if not edges:
        return False
    src = int(edges[0]["src_node_local"])
    dst = int(edges[-1]["dst_node_local"])
    length = len(edges)
    for s, a, l in zip(pair_start_local, pair_answer_local, pair_shortest_len):
        if int(s) == src and int(a) == dst and int(l) == length:
            return True
    return False


def build_path_records(
    *,
    sample_id: str,
    question_text: str,
    gold_answers: list[str],
    chains: Sequence[Mapping[str, Any]],
    settings: ReasonerSettings,
    pair_start_local: Sequence[int] = (),
    pair_answer_local: Sequence[int] = (),
    pair_shortest_len: Sequence[int] = (),
) -> dict[str, Any]:
    """One prompt record from ranked candidate chains.

    ``chains`` carry chain_text/frequency/length/edge ids; a chain "hits"
    when it realizes a (start, answer) pair at the BFS-shortest length.
    """
    kept = list(chains[: settings.path_limit])
    visible_edge_ids = sorted({int(e) for c in kept for e in c.get("edge_local_ids", [])})
    hit = any(
        chain_is_shortest_hit(
            c,
            pair_start_local=pair_start_local,
            pair_answer_local=pair_answer_local,
            pair_shortest_len=pair_shortest_len,
        )
        for c in kept
    )
    prompt = build_path_prompt(
        question=question_text,
        chains=kept,
        limit=settings.path_limit,
        include_meta=settings.include_chain_meta,
    )
    evidence_text = "\n".join(str(c.get("chain_text", "")) for c in kept)
    return {
        "id": sample_id,
        "window_k": settings.path_limit,
        "question": question_text,
        "answers": gold_answers,
        "prompt": prompt,
        "visible_edge_ids": visible_edge_ids,
        "retrieved_edge_ids": visible_edge_ids,
        "hit_set": hit,
        "hit_vis": hit,
        "evidence_token_count": count_tokens(evidence_text, model=settings.token_model),
        "prompt_token_count": count_tokens(prompt, model=settings.token_model),
        "token_budget": settings.token_budget or 0,
        "evidence_truncated": False,
    }


def chat_messages(rec: Mapping[str, Any]) -> list[dict[str, str]]:
    """The chat a record asks: the system prompt, then its prompt."""
    return [
        {"role": "system", "content": SYSTEM_PROMPT},
        {"role": "user", "content": rec["prompt"]},
    ]


def run_reasoner(
    records: Iterable[dict[str, Any]],
    *,
    mode: str,
    llm: ChatBackend | None = None,
    output_path: str | pathlib.Path | None = None,
    oracle_inputs: list[dict[str, Any]] | None = None,
    k_values: Sequence[int] = (1, 10, 25, 50, 100),
) -> dict[str, float]:
    """Execute the reasoner; returns metrics (and persists artifacts)."""
    if mode == "oracle":
        if oracle_inputs is None:
            raise ValueError("oracle mode requires oracle_inputs")
        per_sample = [
            oracle_metrics_for_sample(
                head_entity_ids=x["head_entity_ids"],
                tail_entity_ids=x["tail_entity_ids"],
                answer_entity_ids=x["answer_entity_ids"],
                k_values=k_values,
            )
            for x in oracle_inputs
        ]
        metrics = aggregate_oracle_metrics(per_sample)
    elif mode == "llm":
        if llm is None:
            raise ValueError("llm mode requires a chat backend")
        predictions = []
        batch = getattr(llm, "batch", None)
        if batch is None:
            for rec in records:
                out = run_chat(llm, chat_messages(rec))
                predictions.append({**rec, "prediction": out})
        else:  # a backend that batches gets each chunk of records at once
            records = list(records)
            for i in range(0, len(records), llm.max_batch):
                chunk = records[i:i + llm.max_batch]
                outs = batch([chat_messages(rec) for rec in chunk])
                predictions.extend({**rec, "prediction": out} for rec, out in zip(chunk, outs))
        # Dedup by (id, window_k), latest wins (reference dedup after gather).
        seen: dict[tuple, dict] = {}
        for p in predictions:
            seen[(p["id"], p.get("window_k"))] = p
        predictions = list(seen.values())
        if output_path is not None:
            path = pathlib.Path(output_path)
            path.parent.mkdir(parents=True, exist_ok=True)
            with path.open("w") as f:
                for p in predictions:
                    f.write(json.dumps(p, default=str) + "\n")
        metrics = evaluate_predictions(predictions)
        if output_path is not None:
            metrics_path = pathlib.Path(str(output_path) + ".metrics.json")
            metrics_path.write_text(json.dumps(metrics, indent=2))
    else:
        raise ValueError(f"mode must be 'llm' or 'oracle', got {mode!r}")
    return metrics
