"""Terminal reward for sampled evidence-edge sets.

Counterpart of ``evi_rag_tpu/models/gflownet/reward.py``:

    log R = log(success_reward) + semantic_coef * mean(sigmoid(score_e) over
            selected edges) - length_coef * max(0, path_len - shortest_len)
    on answer hit; log(failure_reward) otherwise; -inf for dummy graphs.

The shortest length of the realised (start, answer) pair is matched from the
padded pair supervision with one masked ``segment_min``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from evi_rag_tpu_torch.models.batches import AgentBatch
from evi_rag_tpu_torch.ops.segment import segment_min, segment_sum


@dataclasses.dataclass(frozen=True)
class RewardOutput:
    reward: torch.Tensor
    log_reward: torch.Tensor
    success: torch.Tensor
    semantic_score: torch.Tensor
    length_cost: torch.Tensor
    path_len: torch.Tensor
    shortest_len: torch.Tensor


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    success_reward: float = 1.0
    failure_reward: float = 1e-4
    semantic_coef: float = 1.0
    length_coef: float = 1.0

    def __post_init__(self) -> None:
        if self.success_reward <= 0 or self.failure_reward <= 0:
            raise ValueError("rewards must be positive")
        if self.success_reward <= self.failure_reward:
            raise ValueError("success_reward must exceed failure_reward")
        if self.semantic_coef < 0 or self.length_coef < 0:
            raise ValueError("coefficients must be >= 0")


def match_shortest_lengths(
    batch: AgentBatch,
    start_node_hit: torch.Tensor,   # [G] graph-local
    answer_node_hit: torch.Tensor,  # [G] graph-local
) -> torch.Tensor:
    """Shortest BFS length of the realised (start, answer) pair; -1 if unknown."""
    p = batch.pairs
    pb = p.pair_batch.long()
    match = (p.pair_mask & (p.pair_start_local == start_node_hit[pb])
             & (p.pair_answer_local == answer_node_hit[pb]))
    big = 1 << 30
    lengths = torch.where(match, p.pair_shortest_len.to(torch.int32), torch.full_like(p.pair_shortest_len, big,
                                                                                       dtype=torch.int32))
    shortest = segment_min(lengths, pb, batch.graph.num_graphs, fill=big)
    return torch.where(shortest >= big, torch.full_like(shortest, -1), shortest)


def compute_reward(
    batch: AgentBatch,
    *,
    selected_mask: torch.Tensor,    # [E] bool
    answer_hit: torch.Tensor,       # [G] bool
    start_node_hit: torch.Tensor,   # [G]
    answer_node_hit: torch.Tensor,  # [G]
    config: RewardConfig,
) -> RewardOutput:
    gb = batch.graph
    g = gb.num_graphs
    sel = (selected_mask & gb.edge_mask).to(torch.float32)
    path_len = segment_sum(sel, gb.edge_batch, g)
    weights = torch.sigmoid(batch.edge_scores.to(torch.float32))
    semantic = segment_sum(sel * weights, gb.edge_batch, g) / torch.clamp(path_len, min=1.0)

    shortest = match_shortest_lengths(batch, start_node_hit, answer_node_hit)
    hit = answer_hit.bool()
    zero = torch.zeros_like(path_len)
    length_cost = torch.where(hit & (shortest >= 0), torch.clamp(path_len - shortest.to(torch.float32), min=0.0),
                              zero)
    semantic = torch.where(hit, semantic, zero)
    log_r = torch.where(
        hit,
        math.log(config.success_reward) + config.semantic_coef * semantic - config.length_coef * length_cost,
        torch.full_like(path_len, math.log(config.failure_reward)),
    )
    dummy = batch.is_dummy | (~gb.graph_mask)
    log_r = torch.where(dummy, torch.full_like(log_r, float("-inf")), log_r)
    return RewardOutput(
        reward=torch.where(dummy, zero, torch.exp(log_r)),
        log_reward=log_r,
        success=torch.where(dummy, zero, hit.to(torch.float32)),
        semantic_score=torch.where(dummy, zero, semantic),
        length_cost=torch.where(dummy, zero, length_cost),
        path_len=torch.where(dummy, zero, path_len),
        shortest_len=torch.where(dummy, torch.full_like(shortest, -1), shortest).to(torch.float32),
    )
