"""Oracle upper-bound reasoner: answer hit/recall@k over ranked edges.

Copy of ``evi_rag_tpu/eval/oracle.py``.  Edges are pre-ranked (descending
retriever score); at cutoff k an answer entity counts as found if it is the
head or tail of any edge in the top k; recall@k = |found distinct answers| /
|answers|.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def oracle_metrics_for_sample(
    *,
    head_entity_ids: np.ndarray,
    tail_entity_ids: np.ndarray,
    answer_entity_ids: np.ndarray,
    k_values: Sequence[int],
) -> dict[str, float]:
    ks = [int(k) for k in k_values]
    answers = np.unique(np.asarray(answer_entity_ids, dtype=np.int64))
    heads = np.asarray(head_entity_ids, dtype=np.int64)
    tails = np.asarray(tail_entity_ids, dtype=np.int64)
    n_edges = heads.shape[0]
    if answers.size == 0 or n_edges == 0:
        out = {f"answer_hit@{k}": 0.0 for k in ks}
        out.update({f"answer_recall@{k}": 0.0 for k in ks})
        return out

    # Per answer, the first rank (1-based) at which it appears; inf if never.
    first_rank = np.full(answers.size, np.inf)
    for endpoint in (heads, tails):
        pos = np.searchsorted(answers, endpoint)
        ok = (pos < answers.size) & (answers[np.clip(pos, 0, answers.size - 1)] == endpoint)
        ranks = np.nonzero(ok)[0]
        if ranks.size:
            np.minimum.at(first_rank, pos[ok], ranks + 1.0)

    out: dict[str, float] = {}
    for k in ks:
        kk = min(k, n_edges)
        found = first_rank <= kk
        out[f"answer_hit@{k}"] = 1.0 if found.any() else 0.0
        out[f"answer_recall@{k}"] = float(found.sum() / answers.size)
    return out


def aggregate_oracle_metrics(per_sample: list[dict[str, float]]) -> dict[str, float]:
    if not per_sample:
        return {}
    keys = per_sample[0].keys()
    return {k: float(np.mean([m[k] for m in per_sample])) for k in keys}
