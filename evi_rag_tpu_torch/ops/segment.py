"""Segment reductions over a flat element axis (sum, count, mean).

Counterpart of the part of ``evi_rag_tpu/ops/segment.py`` that DDE uses.  The
rules are the reference's: masked elements contribute nothing, and an empty
segment gives 0.  Segment ids must lie in ``[0, num_segments)``.

The sum runs in a fixed order: a stable sort by segment id
(``segment_layout``), then ``torch.segment_reduce`` adds each segment's
elements in their original order.  So the same inputs give bitwise the same
result from run to run on the card as on the CPU (an ``index_add_`` on CUDA
adds with atomics, in an order that changes between runs).  A caller that
reduces several tensors over the same segments (DDE's rounds) computes the
layout once.
"""

from __future__ import annotations

import torch


SPARE_SEGMENTS = 1024  # past num_segments: they take the masked elements, spread so none is long


def _keys(segment_ids: torch.Tensor, num_segments: int, mask: torch.Tensor | None) -> torch.Tensor:
    """int32 sort keys: the segment ids, with masked element i moved to spare
    segment ``num_segments + i % SPARE_SEGMENTS`` (a segment's sum runs in one
    thread, so one long segment of padding would hold up the whole
    reduction)."""
    ids = segment_ids.to(torch.int32)  # 32-bit sort keys: half the radix passes of int64
    if mask is None:
        return ids
    spare = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device) % SPARE_SEGMENTS
    return torch.where(mask.bool(), ids, num_segments + spare)


def _lengths(keys: torch.Tensor, num_segments: int) -> torch.Tensor:
    # Integer adds give the same counts in any order; torch.bincount would
    # read its maximum back to the host, a sync per call on the card.
    lengths = torch.zeros(num_segments + SPARE_SEGMENTS, dtype=torch.long, device=keys.device)
    return lengths.index_add_(0, keys, torch.ones_like(keys, dtype=torch.long))


def segment_layout(
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(order, lengths): the stable permutation that sorts the elements by
    segment id, and the ``[num_segments + SPARE_SEGMENTS]`` segment lengths
    in that order.  Masked elements go to the spare segments, which the sums
    drop."""
    keys = _keys(segment_ids, num_segments, mask)
    return torch.argsort(keys, stable=True), _lengths(keys, num_segments)


def sorted_segment_sum(sorted_data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-segment sum over the leading axis of data already in
    ``segment_layout`` order."""
    out = torch.segment_reduce(sorted_data, "sum", lengths=lengths, axis=0, unsafe=True)
    return out[: lengths.shape[0] - SPARE_SEGMENTS]


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment sum over the leading axis; masked elements contribute 0."""
    order, lengths = segment_layout(segment_ids, num_segments, mask=mask)
    return sorted_segment_sum(data[order], lengths)


def sorted_segment_mean(sorted_data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-segment mean of data already in ``segment_layout`` order; empty
    segments give 0."""
    total = sorted_segment_sum(sorted_data, lengths)
    count = lengths[: total.shape[0]].clamp(min=1).to(total.dtype)
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
    order, lengths = segment_layout(segment_ids, num_segments, mask=mask)
    return sorted_segment_mean(data[order], lengths)
