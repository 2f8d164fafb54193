"""Retrieval metrics on padded batches, computed on the batch's device.

Counterpart of ``evi_rag_tpu/eval/metrics.py``:

* per-graph top-k membership comes from an **in-graph rank**: the JAX
  package sorts once on (graph, -score, index); torch has no multi-key sort,
  so a stable sort on -score followed by a stable sort on the graph id gives
  the same permutation, and the same ranks exactly;
* ``answer_reachability_at_k`` (the model-selection metric) compacts each
  graph to its top-max(k) edges, then labels connected components by
  min-label propagation with pointer jumping, all k of the grid at once.
  Each sweep ends in a host sync (``while changed``);
  ``answer_reachability_sweeps`` also returns how many sweeps it took.

Per-batch functions return per-graph values and validity masks;
``MetricAccumulator`` sums them on the host across batches.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from evi_rag_tpu_torch.models.batches import RetrieverBatch
from evi_rag_tpu_torch.ops.segment import segment_max, segment_min, segment_sum

_COUNT_EPS = 1e-8


def normalize_k_values(k_values: Sequence[int] | None) -> tuple[int, ...]:
    """Sorted unique positive ints."""
    if not k_values:
        return ()
    return tuple(sorted({int(k) for k in k_values if int(k) > 0}))


def _graph_major_order(edge_batch: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts edges by (graph, -score, index)."""
    by_score = torch.argsort(-s, stable=True)
    return by_score[torch.argsort(edge_batch[by_score], stable=True)]


def edge_ranks_in_graph(
    scores: torch.Tensor,      # [E]
    edge_batch: torch.Tensor,  # [E]
    edge_ptr: torch.Tensor,    # [G+1]
    *,
    subset_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """0-based rank of each edge among its graph's edges, descending score;
    non-subset edges rank behind every subset edge; ties go to the lower
    edge index."""
    e = scores.shape[0]
    s = scores.float()
    if subset_mask is not None:
        s = torch.where(subset_mask, s, torch.full_like(s, float("-inf")))
    perm = _graph_major_order(edge_batch.long(), s)
    pos = torch.arange(e, dtype=torch.int32, device=s.device)
    rank_sorted = pos - edge_ptr.long()[edge_batch.long()[perm]].to(torch.int32)
    return torch.zeros(e, dtype=torch.int32, device=s.device).scatter_(0, perm, rank_sorted)


def edge_recall_at_k(
    scores: torch.Tensor,
    labels: torch.Tensor,
    batch: RetrieverBatch,
    k_values: Sequence[int],
    *,
    subset_mask: torch.Tensor | None = None,
    require_positive: bool = False,
) -> dict[str, torch.Tensor]:
    """Per-graph recall@k (+ ``graph_valid``): hits in top-k / #positives;
    ``subset_mask`` restricts ranking and positives; ``require_positive``
    drops graphs without (subset) positives."""
    gb = batch.graph
    emask = gb.edge_mask if subset_mask is None else (gb.edge_mask & subset_mask)
    ranks = edge_ranks_in_graph(scores, gb.edge_batch, gb.edge_ptr, subset_mask=emask)
    pos = (labels > 0.5) & emask
    pos_count = segment_sum(pos.float(), gb.edge_batch, gb.num_graphs)
    edge_count = segment_sum(emask.float(), gb.edge_batch, gb.num_graphs)
    out: dict[str, torch.Tensor] = {}
    for k in normalize_k_values(k_values):
        hits = segment_sum((pos & (ranks < k)).float(), gb.edge_batch, gb.num_graphs)
        out[f"recall@{k}"] = hits / pos_count.clamp(min=_COUNT_EPS)
    valid = gb.graph_mask & (edge_count > 0)
    if require_positive:
        valid = valid & (pos_count > 0)
    out["graph_valid"] = valid
    return out


def score_margin(scores: torch.Tensor, labels: torch.Tensor, batch: RetrieverBatch) -> dict[str, torch.Tensor]:
    """min(pos score) - max(neg score) per graph."""
    gb = batch.graph
    pos = (labels > 0.5) & gb.edge_mask
    neg = (labels <= 0.5) & gb.edge_mask
    s = scores.float()
    min_pos = segment_min(s, gb.edge_batch, gb.num_graphs, mask=pos)
    max_neg = segment_max(s, gb.edge_batch, gb.num_graphs, mask=neg)
    has_pos = segment_sum(pos.float(), gb.edge_batch, gb.num_graphs) > 0
    has_neg = segment_sum(neg.float(), gb.edge_batch, gb.num_graphs) > 0
    valid = has_pos & has_neg & gb.graph_mask
    return {"margin": torch.where(valid, min_pos - max_neg, torch.zeros_like(min_pos)), "graph_valid": valid}


def prob_quality(
    scores: torch.Tensor,
    labels: torch.Tensor,
    batch: RetrieverBatch,
    *,
    subset_mask: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """Per-graph mean sigmoid prob of positives / negatives and separation."""
    gb = batch.graph
    emask = gb.edge_mask if subset_mask is None else (gb.edge_mask & subset_mask)
    pos = (labels > 0.5) & emask
    neg = (labels <= 0.5) & emask
    probs = torch.sigmoid(scores.float())
    pos_n = segment_sum(pos.float(), gb.edge_batch, gb.num_graphs)
    neg_n = segment_sum(neg.float(), gb.edge_batch, gb.num_graphs)
    pos_mean = segment_sum(probs, gb.edge_batch, gb.num_graphs, mask=pos) / pos_n.clamp(min=1.0)
    neg_mean = segment_sum(probs, gb.edge_batch, gb.num_graphs, mask=neg) / neg_n.clamp(min=1.0)
    valid = (pos_n > 0) & (neg_n > 0) & gb.graph_mask
    zero = torch.zeros_like(pos_mean)
    return {
        "pos_prob": torch.where(valid, pos_mean, zero),
        "neg_prob": torch.where(valid, neg_mean, zero),
        "separation": torch.where(valid, pos_mean - neg_mean, zero),
        "graph_valid": valid,
    }


def bridge_positive_coverage(labels: torch.Tensor, batch: RetrieverBatch) -> dict[str, torch.Tensor]:
    """Bridge-positive counts (summed over the batch)."""
    gb = batch.graph
    bridge = ~batch.edge_is_near & gb.edge_mask
    pos = (labels > 0.5) & gb.edge_mask
    pos_counts = segment_sum(pos.float(), gb.edge_batch, gb.num_graphs)
    bpos_counts = segment_sum((pos & bridge).float(), gb.edge_batch, gb.num_graphs)
    return {
        "bridge_pos_edges": bpos_counts.sum(),
        "total_pos_edges": pos_counts.sum(),
        "graphs_with_pos": ((pos_counts > 0) & gb.graph_mask).sum(),
        "graphs_with_bridge_pos": ((pos_counts > 0) & (bpos_counts > 0) & gb.graph_mask).sum(),
    }


def connected_component_labels(
    edge_index: torch.Tensor,        # [2, E]
    edge_in_subgraph: torch.Tensor,  # [E] or [K, E] bool
    num_nodes: int,
) -> torch.Tensor:
    """Min-label connected components over the masked edge set ([N], or
    [K, N] for K edge subsets at once): min exchange along edges and two
    pointer-jumping shortcuts per sweep, until a sweep changes nothing."""
    return _component_labels(edge_index, edge_in_subgraph, num_nodes)[0]


def _component_labels(edge_index, edge_in_subgraph, num_nodes) -> tuple[torch.Tensor, int]:
    """(``connected_component_labels``, the sweeps it took)."""
    heads, tails = edge_index[0].long(), edge_index[1].long()
    sub = edge_in_subgraph.reshape(-1, heads.shape[0])
    k = sub.shape[0]
    dev = heads.device
    labels = torch.arange(num_nodes, dtype=torch.int32, device=dev).repeat(k, 1)
    off = torch.arange(k, device=dev)[:, None] * num_nodes
    seg_h, seg_t = (heads[None, :] + off).reshape(-1), (tails[None, :] + off).reshape(-1)
    big = torch.tensor(num_nodes, dtype=torch.int32, device=dev)
    sweeps = 0
    while True:
        lh = labels.gather(1, heads.expand(k, -1))
        lt = labels.gather(1, tails.expand(k, -1))
        mn = torch.where(sub, torch.minimum(lh, lt), big).reshape(-1)
        upd_h = segment_min(mn, seg_h, k * num_nodes, fill=num_nodes).reshape(k, num_nodes)
        upd_t = segment_min(mn, seg_t, k * num_nodes, fill=num_nodes).reshape(k, num_nodes)
        new = torch.minimum(labels, torch.minimum(upd_h, upd_t))
        new = new.gather(1, new.long())
        new = new.gather(1, new.long())
        sweeps += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return (labels if edge_in_subgraph.ndim > 1 else labels[0]), sweeps


def answer_reachability_at_k(
    scores: torch.Tensor,
    batch: RetrieverBatch,
    k_values: Sequence[int],
) -> dict[str, torch.Tensor]:
    """Per-graph bool: does the top-k edge set connect seeds to answers?"""
    return answer_reachability_sweeps(scores, batch, k_values)[0]


def answer_reachability_sweeps(
    scores: torch.Tensor,
    batch: RetrieverBatch,
    k_values: Sequence[int],
) -> tuple[dict[str, torch.Tensor], int]:
    """(``answer_reachability_at_k``, the component sweeps it took: each
    one ends in a host sync)."""
    gb = batch.graph
    ks = normalize_k_values(k_values)
    if not ks:
        return {"graph_valid": gb.graph_mask}, 0
    dev = scores.device
    e, n, g = gb.num_edges, gb.num_nodes, gb.num_graphs
    edge_ptr = gb.edge_ptr.long()
    # Edges ranked past max(k) never enter any k's subset: keep each graph's
    # top max(k), laid out rank-contiguously by the (graph, -score) sort.
    kk = int(min(max(ks), e))
    s = torch.where(gb.edge_mask, scores.float(), torch.full_like(scores, float("-inf"), dtype=torch.float32))
    perm = _graph_major_order(gb.edge_batch.long(), s)
    slot = torch.arange(kk, device=dev)
    counts = edge_ptr[1:] - edge_ptr[:-1]
    src_pos = torch.clamp(edge_ptr[:-1][:, None] + slot[None, :], max=e - 1)  # [G, kk]
    sel_valid = slot[None, :] < torch.clamp(counts, max=kk)[:, None]
    eidx = perm[src_pos]
    sel_mask = (gb.edge_mask[eidx] & sel_valid).reshape(-1)
    sel_rank = slot[None, :].expand(g, kk).reshape(-1)
    sel_edge_index = torch.stack([gb.heads.long()[eidx].reshape(-1), gb.tails.long()[eidx].reshape(-1)])

    karr = torch.tensor(ks, device=dev)
    sub = sel_mask[None, :] & (sel_rank[None, :] < karr[:, None])            # [K, G*kk]
    labels, sweeps = _component_labels(sel_edge_index, sub, n)
    labels = labels.long()                                                     # [K, N]
    start_roots = torch.where(batch.node_is_q[None, :], labels, torch.full_like(labels, n))
    reached = torch.zeros(len(ks), n + 1, dtype=torch.bool, device=dev)
    reached = reached.scatter(1, start_roots, True)[:, :-1]
    ans_reached = batch.node_is_a[None, :] & reached.gather(1, labels)         # [K, N]
    hits = segment_max(ans_reached.T.float(), gb.node_batch, g).T > 0.5        # [K, G]
    has_start = segment_sum(batch.node_is_q.float(), gb.node_batch, g) > 0
    has_answer = segment_sum(batch.node_is_a.float(), gb.node_batch, g) > 0
    has_edges = segment_sum(gb.edge_mask.float(), gb.edge_batch, g) > 0
    valid = has_start & has_answer & has_edges & gb.graph_mask
    out = {f"reachability@{k}": hits[i] & valid for i, k in enumerate(ks)}
    out["graph_valid"] = valid
    return out, sweeps


def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class MetricAccumulator:
    """Host-side streaming mean over per-graph metric values."""

    def __init__(self) -> None:
        self._sums: dict[str, float] = {}
        self._counts: dict[str, float] = {}

    def update(self, values: dict, valid) -> None:
        valid_np = _numpy(valid).astype(bool)
        n = float(valid_np.sum())
        for name, v in values.items():
            if name == "graph_valid":
                continue
            v_np = _numpy(v).astype(np.float64)
            if v_np.ndim == 0:
                self._sums[name] = self._sums.get(name, 0.0) + float(v_np)
                self._counts[name] = self._counts.get(name, 0.0) + 1.0
            else:
                self._sums[name] = self._sums.get(name, 0.0) + float(v_np[valid_np].sum())
                self._counts[name] = self._counts.get(name, 0.0) + n

    def update_sums(self, values: dict) -> None:
        """Accumulate raw sums (for ratio metrics computed at the end)."""
        for name, v in values.items():
            self._sums[name] = self._sums.get(name, 0.0) + float(_numpy(v))
            self._counts[name] = 1.0

    def compute(self) -> dict[str, float]:
        return {k: self._sums[k] / max(self._counts.get(k, 1.0), _COUNT_EPS) for k in self._sums}

    def merge_from(self, other: "MetricAccumulator") -> None:
        for k, v in other._sums.items():
            self._sums[k] = self._sums.get(k, 0.0) + v
        for k, v in other._counts.items():
            self._counts[k] = self._counts.get(k, 0.0) + v
