"""Closed-form Sub-Trajectory Balance (lambda = 1) with deterministic P_B.

Counterpart of ``evi_rag_tpu/models/gflownet/subtb.py``.  With a unique
predecessor for every state (log P_B = 0), the residual of sub-trajectory
i -> j is ``a_i + b_j`` with ``a_i = logF_i - prefix_i`` and
``b_j = prefix_j - logF_j`` (``prefix`` the cumulative log P_F), so

    L = sum_j [ sum_{i<j} a_i^2 + 2 b_j sum_{i<j} a_i + j b_j^2 ] / sum_j j

takes two cumulative sums: O(T), not O(T^2).  The terminal index is
(selected edges + 1), and ``log_flow_states`` already holds log R there.
"""

from __future__ import annotations

import math

import torch


def log_flow_with_terminal_reward(
    log_flow_pred: torch.Tensor,  # [G, T] estimator logF at each visited state
    log_reward: torch.Tensor,     # [G]
    edge_lengths: torch.Tensor,   # [G] number of selected edges
) -> torch.Tensor:
    """[G, T+1] flow states: one slot appended for max-length trajectories,
    and the realised terminal slot (edge_lengths + 1) set to log R."""
    g, t = log_flow_pred.shape
    lr = log_reward.to(log_flow_pred.dtype)
    states = torch.cat([log_flow_pred, lr[:, None]], dim=1)
    term = torch.clamp(edge_lengths.to(torch.int64), 0, t - 1) + 1
    return states.scatter(1, term[:, None], lr[:, None])


def subtb_per_graph(
    log_flow_states: torch.Tensor,  # [G, T+1]
    log_pf_steps: torch.Tensor,     # [G, T]
    edge_lengths: torch.Tensor,     # [G]
) -> torch.Tensor:
    """The SubTB loss of each graph, [G]."""
    g, t = log_pf_steps.shape
    if tuple(log_flow_states.shape) != (g, t + 1):
        raise ValueError(f"log_flow_states shape {tuple(log_flow_states.shape)} != ({g}, {t + 1})")
    zeros = torch.zeros(g, 1, dtype=log_pf_steps.dtype, device=log_pf_steps.device)
    prefix = torch.cat([zeros, torch.cumsum(log_pf_steps, dim=1)], dim=1)
    a = log_flow_states - prefix
    b = prefix - log_flow_states
    prefix_a = torch.cumsum(a, dim=1) - a          # sum_{i<j} a_i at slot j
    prefix_a2 = torch.cumsum(a * a, dim=1) - a * a
    idx = torch.arange(t + 1, dtype=log_pf_steps.dtype, device=log_pf_steps.device)[None, :]
    contrib = prefix_a2 + 2.0 * b * prefix_a + idx * (b * b)
    term = torch.clamp(edge_lengths.to(torch.int64), 0, t - 1) + 1
    mask = (idx <= term[:, None].to(log_pf_steps.dtype)).to(log_pf_steps.dtype)
    sum_sq = torch.sum(contrib * mask, dim=1)
    denom = torch.clamp(torch.sum(idx * mask, dim=1), min=1.0)
    return sum_sq / denom


def masked_graph_mean(per_graph: torch.Tensor, graph_mask: torch.Tensor | None) -> torch.Tensor:
    """Mean over the last (graph) axis, over ``graph_mask``'s graphs."""
    if graph_mask is None:
        return per_graph.mean(dim=-1)
    w = graph_mask.to(per_graph.dtype)
    return torch.sum(per_graph * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)


def subtb_loss(
    log_flow_states: torch.Tensor,
    log_pf_steps: torch.Tensor,
    edge_lengths: torch.Tensor,
    *,
    graph_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    return masked_graph_mean(subtb_per_graph(log_flow_states, log_pf_steps, edge_lengths), graph_mask)


def bc_weight_schedule(
    step: torch.Tensor | int,
    *,
    bc_weight: float,
    bc_weight_floor: float = 0.0,
    hold_steps: int = 0,
    decay_steps: int = 0,
) -> torch.Tensor:
    """Cosine hold/decay schedule of the DAG behaviour-cloning weight, a
    tensor function of the step tensor (on its device; no host sync)."""
    step = torch.as_tensor(step)
    if bc_weight <= 0.0:
        return torch.zeros((), device=step.device)
    floor = max(0.0, min(bc_weight_floor, bc_weight))
    step = step.to(torch.float32)
    if hold_steps == 0 and decay_steps == 0:
        return torch.full((), bc_weight, device=step.device)
    if decay_steps <= 0:
        scale = (step < hold_steps).to(torch.float32)
    else:
        tt = torch.clamp(step - hold_steps, 0, decay_steps)
        scale = torch.where(step < hold_steps, torch.ones_like(step),
                            0.5 * (1.0 + torch.cos(math.pi * tt / decay_steps)))
    return floor + (bc_weight - floor) * scale
