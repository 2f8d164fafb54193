"""Copy of ``evi_rag_tpu/eval/ranking.py`` (numpy).

Generic offline ranking metrics: P/R/F1/nDCG@k and MRR, plus
answer recall@k / hit@k over ranked edges.

Host-side numpy counterparts of the reference's ``src/utils/metrics.py``
(``compute_ranking_metrics`` 112-169, ``compute_answer_recall`` 172-209,
``compute_answer_hit`` 212-238, ``normalize_k_values`` 25-40).  These run
over per-sample score/label arrays after eval — they are aggregation, not
hot-path compute, so they stay numpy (the device-side recall/reachability
kernels live in ``eval/metrics.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Mapping, Sequence

import numpy as np


def normalize_k_values(
    k_values: Sequence[int] | None, *, default: Sequence[int] = ()
) -> tuple[int, ...]:
    """Sorted unique positive ks (reference ``metrics.py:25-40``)."""
    ks = sorted({int(k) for k in (k_values or []) if int(k) > 0})
    if not ks:
        ks = sorted({int(k) for k in default if int(k) > 0})
    return tuple(ks)


@dataclasses.dataclass
class RankingStats:
    precision_at_k: Dict[int, float]
    recall_at_k: Dict[int, float]
    f1_at_k: Dict[int, float]
    ndcg_at_k: Dict[int, float]
    mrr: float

    def as_flat_dict(self, prefix: str = "") -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, d in (
            ("precision", self.precision_at_k),
            ("recall", self.recall_at_k),
            ("f1", self.f1_at_k),
            ("ndcg", self.ndcg_at_k),
        ):
            for k, v in d.items():
                out[f"{prefix}{name}@{k}"] = v
        out[f"{prefix}mrr"] = self.mrr
        return out


def _ndcg(ranked_labels: np.ndarray, k: int) -> float:
    trunc = ranked_labels[:k]
    if trunc.size == 0:
        return 0.0
    discounts = 1.0 / np.log2(np.arange(1, trunc.size + 1) + 1.0)
    dcg = float((trunc * discounts).sum())
    ideal = np.sort(ranked_labels)[::-1][:k]
    ideal_dcg = float((ideal * discounts[: ideal.size]).sum())
    if ideal_dcg <= 0:
        return 0.0
    return dcg / ideal_dcg


def compute_ranking_metrics(
    samples: Iterable[Mapping[str, np.ndarray]], k_values: Sequence[int]
) -> RankingStats:
    """Macro-averaged P/R/F1/nDCG@k + MRR over per-sample rankings.

    Each sample is ``{"scores": [E], "labels": [E]}``; samples with no
    positive labels are skipped (reference ``metrics.py:119-121``).
    Ties broken by descending-stable argsort like torch.argsort.
    """
    ks = normalize_k_values(k_values, default=[1])
    totals = {k: np.zeros(4) for k in ks}  # precision, recall, f1, ndcg
    counts = {k: 0 for k in ks}
    mrr_sum = 0.0
    mrr_count = 0
    for sample in samples:
        scores = np.asarray(sample["scores"], dtype=np.float64)
        labels = np.asarray(sample["labels"], dtype=np.float64)
        positives = float(labels.sum())
        if positives <= 0:
            continue
        order = np.argsort(-scores, kind="stable")
        ranked = labels[order]
        pos_idx = np.nonzero(ranked > 0.5)[0]
        if pos_idx.size > 0:
            mrr_sum += 1.0 / float(pos_idx[0] + 1)
            mrr_count += 1
        for k in ks:
            hits = float(ranked[:k].sum())
            precision = hits / float(k)
            recall = hits / positives
            f1 = 0.0 if (precision + recall) == 0 else 2 * precision * recall / (precision + recall)
            totals[k] += (precision, recall, f1, _ndcg(ranked, k))
            counts[k] += 1
    p, r, f, n = {}, {}, {}, {}
    for k in ks:
        c = counts[k] or 1
        p[k], r[k], f[k], n[k] = (totals[k] / c).tolist()
    mrr = mrr_sum / mrr_count if mrr_count else 0.0
    return RankingStats(p, r, f, n, mrr)


def _ranked_endpoint_sweep(
    samples: Iterable[Mapping[str, np.ndarray]],
    k_values: Sequence[int],
    *,
    hit_only: bool,
) -> Dict[int, list[float]]:
    """Shared sweep: walk ranked edges, track answers seen at each k cut."""
    ks = normalize_k_values(k_values)
    out: Dict[int, list[float]] = {k: [] for k in ks}
    if not ks:
        return out
    max_k = max(ks)
    for sample in samples:
        answer_ids = np.asarray(sample.get("answer_ids", ()), dtype=np.int64)
        if answer_ids.size == 0:
            continue
        answers = set(answer_ids.tolist())
        scores = np.asarray(sample["scores"], dtype=np.float64)
        order = np.argsort(-scores, kind="stable")[:max_k]
        heads = np.asarray(sample["head_ids"], dtype=np.int64)
        tails = np.asarray(sample["tail_ids"], dtype=np.int64)
        found: set[int] = set()
        k_ptr = 0
        for rank, edge in enumerate(order.tolist(), start=1):
            if heads[edge] in answers:
                found.add(int(heads[edge]))
            if tails[edge] in answers:
                found.add(int(tails[edge]))
            while k_ptr < len(ks) and rank == ks[k_ptr]:
                val = (1.0 if found else 0.0) if hit_only else len(found) / len(answers)
                out[ks[k_ptr]].append(val)
                k_ptr += 1
        last = (1.0 if found else 0.0) if hit_only else len(found) / len(answers)
        while k_ptr < len(ks):
            out[ks[k_ptr]].append(last)
            k_ptr += 1
    return out


def compute_answer_recall(
    samples: Iterable[Mapping[str, np.ndarray]], k_values: Sequence[int]
) -> Dict[str, float]:
    """Fraction of answer entities appearing as an endpoint of a top-k edge
    (reference ``metrics.py:172-209``)."""
    vals = _ranked_endpoint_sweep(samples, k_values, hit_only=False)
    return {
        f"answer_recall@{k}": float(np.mean(v)) if v else 0.0 for k, v in vals.items()
    }


def compute_answer_hit(
    samples: Iterable[Mapping[str, np.ndarray]], k_values: Sequence[int]
) -> Dict[str, float]:
    """Whether ANY answer entity is an endpoint of a top-k edge
    (reference ``metrics.py:212-238``)."""
    vals = _ranked_endpoint_sweep(samples, k_values, hit_only=True)
    return {f"answer_hit@{k}": float(np.mean(v)) if v else 0.0 for k, v in vals.items()}


class FeatureMonitor:
    """Score-separation + feature-norm tracker (reference
    ``src/metrics/feature_monitor.py``): running sums of sigmoid scores for
    positive vs negative edges and of feature L2 norms; sums are plain
    floats, so cross-process reduction is a psum/allgather of six scalars.
    """

    def __init__(self) -> None:
        self.pos_score_sum = 0.0
        self.pos_count = 0.0
        self.neg_score_sum = 0.0
        self.neg_count = 0.0
        self.feat_norm_sum = 0.0
        self.feat_count = 0.0

    def update(
        self,
        preds: np.ndarray,
        target: np.ndarray,
        features: np.ndarray | None = None,
        mask: np.ndarray | None = None,
    ) -> None:
        preds = 1.0 / (1.0 + np.exp(-np.asarray(preds, dtype=np.float64)))
        target = np.asarray(target, dtype=np.float64)
        valid = np.ones(target.shape, dtype=bool) if mask is None else np.asarray(mask, bool)
        pos = (target > 0.5) & valid
        neg = (target <= 0.5) & valid
        self.pos_score_sum += float(preds[pos].sum())
        self.pos_count += float(pos.sum())
        self.neg_score_sum += float(preds[neg].sum())
        self.neg_count += float(neg.sum())
        if features is not None:
            feats = np.asarray(features, dtype=np.float64)
            norms = np.linalg.norm(feats, axis=-1)
            if mask is not None:
                norms = norms[np.asarray(mask, bool)]
            self.feat_norm_sum += float(norms.sum())
            self.feat_count += float(norms.size)

    def compute(self) -> Dict[str, float]:
        pos_avg = self.pos_score_sum / max(self.pos_count, 1.0)
        neg_avg = self.neg_score_sum / max(self.neg_count, 1.0)
        return {
            "features/pos_prob_avg": pos_avg,
            "features/neg_prob_avg": neg_avg,
            "features/separation_gap": pos_avg - neg_avg,
            "features/norm_avg": self.feat_norm_sum / max(self.feat_count, 1.0),
        }
