"""The comparisons that decide ``correct``: each gives a number that the
cell's limit (``limits/<cell>.json``) bounds.  Nothing here imports the
program."""

from __future__ import annotations

import math

import numpy as np
import torch


def topk_readings(ids, scores, ref: torch.Tensor, k: int) -> tuple[float, float]:
    """(score error, top-k gap) of one answer against the reference's
    scores ``ref`` [E] of all its candidates.

    The answer must hold min(k, E) distinct candidates; otherwise, or when
    it never came (``ids`` None), both read infinity.  Score error: the
    largest |answered score - reference score| over the answered ids.
    Top-k gap: the widest margin by which an answered candidate's reference
    score lies below the reference's k-th best (0 when the answer is the
    reference's top k)."""
    if ids is None:
        return math.inf, math.inf
    ref = ref.float()
    n = min(k, ref.shape[0])
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=ref.device)
    got = torch.as_tensor(np.asarray(scores, dtype=np.float32), device=ref.device)
    if ids.numel() != n or got.numel() != n or (n and (ids.min() < 0 or ids.max() >= ref.shape[0])):
        return math.inf, math.inf
    if torch.unique(ids).numel() != n:
        return math.inf, math.inf
    if n == 0:
        return 0.0, 0.0
    mine = ref[ids]
    kth = torch.topk(ref, n).values[-1]
    return float((got - mine).abs().max()), float(torch.clamp(kth - mine, min=0).max())


def worst_leaf_gap(prog: dict[str, torch.Tensor], ref: dict[str, torch.Tensor],
                   keep: set[str] | None = None) -> tuple[float, str]:
    """The worst leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's (the leaves of
    ``keep``, or all), with its path."""
    paths = sorted(ref if keep is None else keep)
    r_norms = {p: float(ref[p].float().norm()) for p in paths}
    med = float(np.median(list(r_norms.values()))) if r_norms else 0.0
    worst, where = 0.0, ""
    for p in paths:
        if p not in prog:
            return math.inf, p
        gap = abs(float(prog[p].float().norm()) - r_norms[p]) / max(r_norms[p], med, 1e-30)
        if not math.isfinite(gap):
            return math.inf, p
        if gap > worst:
            worst, where = gap, p
    return worst, where
