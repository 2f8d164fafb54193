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
    num_nodes = x.shape[0]

    def direction(src: torch.Tensor, dst: torch.Tensor):
        """The segment layout of one direction's messages, shared by its
        rounds: (sources in sum order, lengths)."""
        order, lengths = segment_layout(dst, num_nodes, mask=edge_mask)
        return src[order], lengths

    def one_round(h: torch.Tensor, layout) -> torch.Tensor:
        src_sorted, lengths = layout
        return sorted_segment_mean(h[src_sorted], lengths)

    outs: list[torch.Tensor] = []
    for rounds, layout in ((num_rounds, direction(heads, tails)), (num_reverse_rounds, direction(tails, heads))):
        h = x
        for _ in range(rounds):
            h = one_round(h, layout)
            outs.append(h)
    return outs


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
