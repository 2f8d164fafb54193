"""Segment reductions over a flat element axis.

Counterpart of ``evi_rag_tpu/ops/segment.py``, with its rules: masked
elements contribute the reduction's identity (0 for sum, -inf for max and
logsumexp, +inf for min); an empty segment gives the identity (``NEG_INF``
for max and logsumexp, 0 for sum and mean), never NaN; ``segment_argmax``
breaks ties toward the lowest element index.  Segment ids must lie in
``[0, num_segments)``.

The sum runs in a fixed order: a stable sort by segment id
(``segment_layout``), then two passes of ``torch.segment_reduce``.  Pass 1
cuts every segment into chunks of at most ``CHUNK_ROWS`` consecutive rows
and sums each chunk; pass 2 adds each segment's chunk sums in chunk order.
So a segment of at most ``CHUNK_ROWS`` rows sums exactly as one pass would
(its one chunk sum is added to 0), and a longer one in a fixed
association.  A thread of pass 1 walks at most ``CHUNK_ROWS`` rows, one of
pass 2 at most ceil(L / ``CHUNK_ROWS``) + 1 chunk sums of a segment of L
rows: CUDA's kernel for data with a row width gives one thread to each
(segment, column), so in one pass the padding graph's ~100k rows would
hold up a whole reduction.  The same inputs give bitwise the same result from run to
run (an ``index_add_`` on CUDA adds with atomics, in an order that changes
between runs).  Data with a row width gives the same bits on the card as
on the CPU, whose kernels both add a chunk's rows one after another; 1-D
data does not, as the card sums a 1-D chunk in a tree (CUB's segmented
reduce) and the CPU still one row after another.
A caller that reduces several tensors over the same segments (DDE's rounds)
computes the layout, chunks included, once.  Max and min give the same
result in any order, so they scatter directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from evi_rag_tpu_torch.utils import profiling

NEG_INF = float(torch.finfo(torch.float32).min)

CHUNK_ROWS = 256  # the most rows a thread of a sum's first pass adds


class SegmentLayout(NamedTuple):
    """A sum's plan over elements sorted by segment id: ``lengths``
    ``[num_segments + 1]`` (the last segment holds the masked elements and
    is dropped), ``chunk_lengths`` ``[K]`` (pass 1's chunks in sorted
    order) and ``chunk_counts`` ``[num_segments + 1]`` (pass 2's chunks a
    segment)."""

    lengths: torch.Tensor
    chunk_lengths: torch.Tensor
    chunk_counts: torch.Tensor


def _keys(segment_ids: torch.Tensor, num_segments: int, mask: torch.Tensor | None) -> torch.Tensor:
    """int32 sort keys: the segment ids, masked elements moved to segment
    ``num_segments``."""
    ids = segment_ids.to(torch.int32)  # 32-bit sort keys: half the radix passes of int64
    if mask is None:
        return ids
    return torch.where(mask.bool(), ids, num_segments)


def _lengths(keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    # Integer adds give the same counts in any order; torch.bincount would
    # read its maximum back to the host, a sync per call on the card.
    lengths = torch.zeros(num_segments + 1, dtype=torch.long, device=keys.device)
    return lengths.index_add_(0, keys, torch.ones_like(keys, dtype=torch.long))


def _chunks(lengths: torch.Tensor, num_elements: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(chunk_lengths, chunk_counts) of ``lengths``, on their device with no
    read back: segment s is cut into ceil(L_s / CHUNK_ROWS) chunks, all full
    but its last.  Their number T lies between ceil(num_elements /
    CHUNK_ROWS) and K = that + S (S = len(lengths)), so a static K chunks
    leave K - T <= S empty ones over: one each for the first K - T
    segments, after their own (a sum plus 0 is that sum), so that pass 2
    walks no long run of them."""
    s = lengths.shape[0]
    k = -(-num_elements // CHUNK_ROWS) + s
    counts = (lengths + (CHUNK_ROWS - 1)) // CHUNK_ROWS
    seg_ids = torch.arange(s, device=lengths.device)
    counts = counts + (seg_ids < k - counts.sum())
    ends = counts.cumsum(0)
    chunk = torch.arange(k, device=lengths.device)
    seg = torch.searchsorted(ends, chunk, right=True)
    first_row = (chunk - (ends - counts)[seg]) * CHUNK_ROWS  # of the chunk within its segment
    return (lengths[seg] - first_row).clamp_(0, CHUNK_ROWS), counts


def segment_layout(
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, SegmentLayout]:
    """(order, layout): the stable permutation that sorts the elements by
    segment id, and the sums' ``SegmentLayout`` of the sorted elements.
    Masked elements go to the last segment, which the sums drop."""
    keys = _keys(segment_ids, num_segments, mask)
    lengths = _lengths(keys, num_segments)
    return torch.argsort(keys, stable=True), SegmentLayout(lengths, *_chunks(lengths, keys.shape[0]))


def sorted_segment_sum(sorted_data: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Per-segment sum over the leading axis of data already in
    ``segment_layout`` order: chunk sums, then each segment's chunk sums."""
    profiling.count("segment.sum.chunks", layout.chunk_lengths.shape[0])
    partial = torch.segment_reduce(sorted_data, "sum", lengths=layout.chunk_lengths, axis=0, unsafe=True)
    out = torch.segment_reduce(partial, "sum", lengths=layout.chunk_counts, axis=0, unsafe=True)
    return out[:-1]


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment sum over the leading axis; masked elements contribute 0."""
    order, layout = segment_layout(segment_ids, num_segments, mask=mask)
    return sorted_segment_sum(data[order], layout)


def sorted_segment_mean(sorted_data: torch.Tensor, layout: SegmentLayout) -> torch.Tensor:
    """Per-segment mean of data already in ``segment_layout`` order; empty
    segments give 0."""
    total = sorted_segment_sum(sorted_data, layout)
    count = layout.lengths[: total.shape[0]].clamp(min=1).to(total.dtype)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Number of (valid) elements per segment."""
    return _lengths(_keys(segment_ids, num_segments, mask), num_segments)[:num_segments].to(dtype)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment mean; empty segments give 0."""
    order, layout = segment_layout(segment_ids, num_segments, mask=mask)
    return sorted_segment_mean(data[order], layout)


def _expand_mask(mask: torch.Tensor | None, data: torch.Tensor) -> torch.Tensor | None:
    if mask is None:
        return None
    mask = mask.bool()
    return mask.reshape(mask.shape + (1,) * (data.ndim - mask.ndim))


def _scatter_extreme(data, segment_ids, num_segments, mask, fill, reduce: str) -> torch.Tensor:
    m = _expand_mask(mask, data)
    if m is not None:
        data = torch.where(m, data, torch.full_like(data, fill))
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), fill, dtype=data.dtype, device=data.device)
    # include_self: the fill takes part, so the result is max(fill, segment max).
    return out.scatter_reduce(0, idx, data, reduce, include_self=True)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    fill: float = NEG_INF,
) -> torch.Tensor:
    """Per-segment max; empty or fully masked segments give ``fill``."""
    return _scatter_extreme(data, segment_ids, num_segments, mask, fill, "amax")


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    fill: float | int | None = None,
) -> torch.Tensor:
    """Per-segment min; empty or fully masked segments give ``fill`` (the
    dtype's largest value by default, float32's for floating data)."""
    if fill is None:
        fill = (float(torch.finfo(torch.float32).max) if data.is_floating_point()
                else int(torch.iinfo(data.dtype).max))
    return _scatter_extreme(data, segment_ids, num_segments, mask, fill, "amin")


def segment_logsumexp(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Numerically stable per-segment logsumexp over a 1-D data axis; empty
    or fully masked segments give ``NEG_INF``.  Differentiable, with
    NaN-free gradients: masked lanes are set to -inf before ``exp``, so exp
    and its derivative are exactly 0 there."""
    if data.ndim != 1:
        raise ValueError(f"segment_logsumexp expects 1D data, got shape {tuple(data.shape)}")
    # The shift cancels in the value and in the gradient; holding it
    # constant drops its (zero) gradient terms.
    seg_max = segment_max(data.detach(), segment_ids, num_segments, mask=mask)
    shifted = data - seg_max[segment_ids.long()]
    if mask is not None:
        shifted = torch.where(mask.bool(), shifted, torch.full_like(shifted, float("-inf")))
    seg_sum = segment_sum(torch.exp(shifted), segment_ids, num_segments)
    out = seg_max + torch.log(seg_sum.clamp(min=torch.finfo(data.dtype).tiny))
    return torch.where(seg_sum > 0, out, torch.full_like(out, NEG_INF))


def segment_softmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment softmax over a 1-D data axis; masked lanes get 0."""
    if data.ndim != 1:
        raise ValueError(f"segment_softmax expects 1D data, got shape {tuple(data.shape)}")
    ids = segment_ids.long()
    seg_max = segment_max(data.detach(), segment_ids, num_segments, mask=mask)
    shifted = data - seg_max[ids]
    if mask is not None:
        shifted = torch.where(mask.bool(), shifted, torch.full_like(shifted, float("-inf")))
    expv = torch.exp(shifted)
    denom = segment_sum(expv, segment_ids, num_segments).clamp(min=torch.finfo(data.dtype).tiny)
    return expv / denom[ids]


def segment_argmax(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (max, argmax), ties to the lowest element index; empty
    segments give (``NEG_INF``, 0)."""
    if data.ndim != 1:
        raise ValueError(f"segment_argmax expects 1D data, got shape {tuple(data.shape)}")
    n = data.shape[0]
    seg_max = segment_max(data, segment_ids, num_segments, mask=mask)
    is_max = data == seg_max[segment_ids.long()]
    if mask is not None:
        is_max = is_max & mask.bool()
    idx = torch.arange(n, dtype=torch.int32, device=data.device)
    packed = torch.where(is_max, idx, torch.full_like(idx, n))  # n: no candidate
    arg = segment_min(packed, segment_ids, num_segments)
    return seg_max, torch.where(arg >= n, torch.zeros_like(arg), arg)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(idx)
        ctx.num_rows = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (idx,) = ctx.saved_tensors
        return segment_sum(grad.contiguous(), idx, ctx.num_rows), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` over the leading axis, differentiable, whose backward adds
    the gradients of repeated rows with ``segment_sum`` (fixed order, all
    segments in parallel).  The backward of ``x[idx]`` sorts the indices and
    then walks each run of duplicates serially on CUDA, which takes ~28 ms
    for [65536, 1024] rows gathered from 17 question rows."""
    return _GatherRows.apply(x, idx.long())
