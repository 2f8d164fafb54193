"""Segment reductions over a flat element axis (sum, count, mean).

Counterpart of the part of ``evi_rag_tpu/ops/segment.py`` that DDE uses,
built on ``index_add_``.  The rules are the reference's: masked elements
contribute nothing, and an empty segment gives 0.  Segment ids must lie in
``[0, num_segments)``.  On CUDA ``index_add_`` adds with atomics, so the
order of a float sum, and its last bits, can change from run to run.
"""

from __future__ import annotations

import torch


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment sum over the leading axis; masked elements contribute 0."""
    if mask is not None:
        m = mask.bool().reshape(mask.shape + (1,) * (data.ndim - mask.ndim))
        data = torch.where(m, data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_count(
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Number of (valid) elements per segment."""
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask=mask)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    *,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-segment mean; empty segments give 0."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    count = segment_count(segment_ids, num_segments, mask=mask, dtype=total.dtype)
    count = count.clamp(min=1.0)
    return total / count.reshape(count.shape + (1,) * (total.ndim - 1))
