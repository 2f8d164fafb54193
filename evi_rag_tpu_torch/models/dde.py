"""Directional Diffusion Encoding (DDE) as segment-mean message passing.

Counterpart of ``evi_rag_tpu/models/dde.py``: K rounds of mean aggregation
over the directed edge list, forward (head -> tail) then reverse
(tail -> head).  Parameter-free; at most 4 rounds per direction.
"""

from __future__ import annotations

import torch

from evi_rag_tpu_torch.ops.segment import segment_layout, sorted_segment_mean

MAX_DDE_ROUNDS = 4


def dde_diffuse(
    x: torch.Tensor,            # [N, C] node features (e.g. topic one-hot)
    edge_index: torch.Tensor,   # [2, E]
    *,
    num_rounds: int,
    num_reverse_rounds: int,
    edge_mask: torch.Tensor | None = None,
) -> list[torch.Tensor]:
    """Return ``num_rounds + num_reverse_rounds`` diffused feature maps, all
    forward rounds first, then all reverse rounds."""
    if num_rounds > MAX_DDE_ROUNDS or num_reverse_rounds > MAX_DDE_ROUNDS:
        raise ValueError(
            f"DDE supports at most {MAX_DDE_ROUNDS} rounds per direction; "
            f"got {num_rounds}/{num_reverse_rounds}"
        )
    heads, tails = edge_index[0].long(), edge_index[1].long()
    n = x.shape[0]
    # Both directions as one segment mean over 2N segments, whose layout is
    # planned once: forward messages (head -> tail) land on segments
    # [0, N) from the forward half of h, reverse ones on [N, 2N) from its
    # reverse half.  Each segment holds the same elements in the same order
    # as a direction of its own would.
    dst, src = torch.cat([tails, heads + n]), torch.cat([heads, tails + n])
    order, sums = segment_layout(dst, 2 * n, mask=None if edge_mask is None else edge_mask.repeat(2))
    src_sorted = src[order]
    h = torch.cat([x, x])
    fwd: list[torch.Tensor] = []
    rev: list[torch.Tensor] = []
    for _ in range(max(num_rounds, num_reverse_rounds)):
        h = sorted_segment_mean(h[src_sorted], sums)
        fwd.append(h[:n])
        rev.append(h[n:])
    return fwd[:num_rounds] + rev[:num_reverse_rounds]


def build_node_struct_features(
    topic_one_hot: torch.Tensor,  # [N, C]
    edge_index: torch.Tensor,     # [2, E]
    *,
    num_rounds: int,
    num_reverse_rounds: int,
    edge_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Stack raw + diffused topic features into ``[N, C*(1+R+Rr)]`` in the
    reference's interleaved layout ``[c0@raw, c0@f1, ..., c0@rK, c1@raw, ...]``."""
    feats = [topic_one_hot] + dde_diffuse(
        topic_one_hot,
        edge_index,
        num_rounds=num_rounds,
        num_reverse_rounds=num_reverse_rounds,
        edge_mask=edge_mask,
    )
    stacked = torch.stack(feats, dim=-1)  # [N, C, 1+R+Rr]
    return stacked.reshape(stacked.shape[0], -1)
