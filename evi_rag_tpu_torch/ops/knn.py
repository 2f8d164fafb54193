"""Exact and approximate k-nearest-neighbour search over an embedding table.

Counterpart of ``evi_rag_tpu/ops/knn.py``, which XLA runs: a ``[B, D] x
[D, V]`` product and a top-k.  Here the product is a library matmul (bf16
operands widened to f32, so the products are exact and the sums f32, as
``preferred_element_type=f32`` gives them) and the selection
``torch.topk``.  When the ``[B, V]`` f32 scores and the selection's
temporaries fit ``_ONESHOT_BYTES`` it is one product and one top-k; beyond
that the table is scanned in ``chunk``-row slices with a running top-k
merge, so live memory stays O(chunk + k).

Metrics: ``dot`` (MIPS), ``cosine`` and ``l2`` (``-||q - t||^2`` up to the
per-query ``||q||^2``).  ``method="approx"`` is TPU-KNN's PartialReduce
(arXiv 2206.14286), for which torch has no operator: the candidates fall
into L bins (column j into bin j mod L), each bin keeps its maximum, and an
exact top-k runs over the L maxima.  With the top k spread at random over
the bins, the expected recall is ``L / k (1 - (1 - 1/L)^k) ~ 1 - (k - 1) /
(2 L)``, so L is sized for ``recall_target = 0.95`` as
``lax.approx_max_k`` sizes it.  The chunked scan approximates only each
chunk's selection; the 2k merge across chunks stays exact.

``knn_topk_sharded`` splits the table's rows over a mesh: each entry keeps
a local top-k, its ids offset by ``entry * V / n``, and one top-k over the
gathered ``[B, n k]`` rows on the first entry's device merges them.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

_METRICS = ("dot", "cosine", "l2")
RECALL_TARGET = 0.95
# The [B, V] f32 scores plus the selection's value and index temporaries
# (~3x the scores) must fit for the one-shot path.
_ONESHOT_BYTES = 512 * 1024 * 1024
_MATMUL_ROWS = 65536  # rows widened to f32 at a time for the product


def _prep(table: torch.Tensor, metric: str, dtype: torch.dtype) -> torch.Tensor:
    table = table.float()
    if metric == "cosine":
        table = table / torch.clamp(torch.linalg.vector_norm(table, dim=-1, keepdim=True), min=1e-12)
    return table.to(dtype)


def _scores(q: torch.Tensor, tbl: torch.Tensor, metric: str) -> torch.Tensor:
    """[B, C] f32 scores of ``q`` against the rows of ``tbl``."""
    q32 = q.float()
    parts = []
    for blk in tbl.split(_MATMUL_ROWS):
        blk = blk.float()
        s = q32 @ blk.T
        if metric == "l2":
            # -||q - c||^2 = 2 q.c - ||c||^2 (- ||q||^2, constant per query).
            s = 2.0 * s - (blk * blk).sum(-1)[None, :]
        parts.append(s)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def partial_reduce_bins(k: int, recall_target: float = RECALL_TARGET) -> int:
    """The smallest bin count L >= k whose expected recall
    ``L / k (1 - (1 - 1/L)^k)`` reaches ``recall_target``."""
    if k <= 1:
        return 1
    lo = max(k, math.ceil((k - 1) / (2.0 * (1.0 - recall_target))) - k)
    while lo / k * (1.0 - (1.0 - 1.0 / lo) ** k) < recall_target:
        lo += 1
    return lo


def partial_reduce_topk(s: torch.Tensor, k: int, recall_target: float = RECALL_TARGET):
    """Approximate top-k of each row of ``s`` [B, n]: (values [B, k], column
    ids [B, k] int64), values descending."""
    b, n = s.shape
    bins = partial_reduce_bins(k, recall_target)
    if bins >= n:
        return torch.topk(s, k)
    rows = -(-n // bins)
    grid = F.pad(s, (0, rows * bins - n), value=float("-inf")).view(b, rows, bins)
    best, row = grid.max(dim=1)                   # [B, L]: each bin's maximum and its row
    vals, pos = torch.topk(best, k)
    return vals, torch.gather(row, 1, pos) * bins + pos


def _select(s: torch.Tensor, k: int, method: str):
    return partial_reduce_topk(s, k) if method == "approx" else torch.topk(s, k)


@torch.inference_mode()
def knn_topk(
    queries: Any,           # [B, D]
    table: Any,             # [V, D]
    *,
    k: int,
    chunk: int = 65536,
    metric: str = "dot",
    dtype: torch.dtype = torch.bfloat16,
    method: str = "exact",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k: ([B, k] f32 scores, [B, k] int32 table row ids), on the
    table's device.  ``chunk`` only affects the chunked scan."""
    if metric not in _METRICS:
        raise ValueError(f"metric must be one of {_METRICS}")
    if method not in ("exact", "approx"):
        raise ValueError(f"method must be exact|approx, got {method!r}")
    table = torch.as_tensor(table)
    v = table.shape[0]
    b = queries.shape[0]
    tbl = _prep(table, metric, dtype)
    q = torch.as_tensor(queries).to(table.device).float()
    if metric == "cosine":
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
    q = q.to(dtype)

    if 3 * b * v * 4 <= _ONESHOT_BYTES:  # 3x: scores + the selection's value / index temporaries
        top_v, top_i = _select(_scores(q, tbl, metric), k, method)
        return top_v, top_i.to(torch.int32)

    top_v = torch.full((b, k), float("-inf"), device=tbl.device)
    top_i = torch.full((b, k), -1, dtype=torch.int64, device=tbl.device)
    for c0 in range(0, v, chunk):
        s = _scores(q, tbl[c0:c0 + chunk], metric)
        cv, cp = _select(s, min(k, s.shape[1]), method)
        all_v = torch.cat([top_v, cv], dim=1)
        all_i = torch.cat([top_i, cp + c0], dim=1)
        top_v, pos = torch.topk(all_v, k)
        top_i = torch.gather(all_i, 1, pos)
    return top_v, top_i.to(torch.int32)


def knn_topk_sharded(
    queries: Any,
    table: Any,             # [V, D] (on the host when it fits no device)
    *,
    mesh,
    k: int,
    chunk: int = 8192,
    metric: str = "dot",
    dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mesh-sharded exact kNN: a local top-k on each entry's row block (ids
    offset to global rows), then one top-k over the gathered ``[B, n k]``
    rows on ``mesh.devices[0]``."""
    from evi_rag_tpu_torch.parallel.mesh import shard_batch

    table = torch.as_tensor(table)
    v, n = table.shape[0], mesh.size
    if v % n:
        raise ValueError(f"table rows {v} must divide evenly over {n} devices")
    local_v = v // n
    home = mesh.devices[0]
    vals, ids = [], []
    for i, (t, dev) in enumerate(zip(shard_batch(table, mesh), mesh.devices)):
        val, idx = knn_topk(torch.as_tensor(queries).to(dev), t, k=k, chunk=min(chunk, local_v),
                            metric=metric, dtype=dtype)
        vals.append(val.to(home))
        ids.append(idx.to(home) + i * local_v)
    top_v, pos = torch.topk(torch.cat(vals, dim=1), k)
    return top_v, torch.gather(torch.cat(ids, dim=1), 1, pos)
