"""Pure-functional set-based graph MDP with edge-level actions.

Counterpart of ``evi_rag_tpu/models/gflownet/env.py``: an immutable
``EnvState`` and pure ``env_reset`` / ``env_step`` tensor functions with fixed
shapes and done-masking instead of early exit, so a rollout is a fixed
``max_steps + 1``-step loop with no host sync.

* actions are edge ids on the batch's padded edge axis; STOP = -1;
* a selected edge's non-active endpoint becomes the new frontier (frontier
  replacement); a selection is backward when its tail is active and its
  head is not;
* the answer hit records the lowest graph-local id among active answer nodes;
* ``action_hidden`` keeps a running mean of the selected edges' tokens.

"Any element of a segment" tests count with integer ``index_add_`` (exact in
any order), where the JAX package sums floats and compares with 0.
"""

from __future__ import annotations

import dataclasses

import torch

from evi_rag_tpu_torch.models.batches import AgentBatch
from evi_rag_tpu_torch.ops.segment import segment_min

STOP_ACTION = -1
DIRECTION_FORWARD = 0
DIRECTION_BACKWARD = 1


@dataclasses.dataclass(frozen=True)
class EnvState:
    active_nodes: torch.Tensor     # [N] bool: current frontier
    visited_nodes: torch.Tensor    # [N] bool
    used_edge_mask: torch.Tensor   # [E] bool
    selection_order: torch.Tensor  # [E] int32 (step index or -1)
    done: torch.Tensor             # [G] bool
    step_counts: torch.Tensor      # [G] int32
    answer_hits: torch.Tensor      # [G] bool
    answer_node_hit: torch.Tensor  # [G] int32 graph-local node id, -1 if none
    start_node_hit: torch.Tensor   # [G] int32 graph-local chosen-start id, -1
    action_hidden: torch.Tensor    # [G, H] running mean of selected edge tokens
    directions: torch.Tensor       # [G, T] int32 per-step direction
    actions: torch.Tensor          # [G, T] int32 per-step action (edge id or -1)


def segment_any(flags: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Per-segment "any" of a bool vector (an exact integer count > 0)."""
    counts = torch.zeros(num_segments, dtype=torch.int32, device=flags.device)
    return counts.index_add_(0, segment_ids.long(), flags.to(torch.int32)) > 0


def _min_local_answer_hit(active: torch.Tensor, batch: AgentBatch) -> tuple[torch.Tensor, torch.Tensor]:
    """(hit[G], min graph-local answer node id[G] or -1)."""
    gb = batch.graph
    n = gb.num_nodes
    nb = gb.node_batch.long()
    hit_nodes = active & batch.node_is_answer & gb.node_mask
    local = torch.arange(n, dtype=torch.int32, device=active.device) - gb.node_ptr[nb].to(torch.int32)
    packed = torch.where(hit_nodes, local, torch.full_like(local, n + 1))
    min_local = segment_min(packed, nb, gb.num_graphs, fill=n + 1)
    has = min_local <= n
    return has, torch.where(has, min_local, torch.full_like(min_local, -1))


def env_reset(
    batch: AgentBatch,
    *,
    max_steps: int,
    hidden_dim: int,
    stop_on_answer: bool = False,
) -> EnvState:
    gb = batch.graph
    g, e = gb.num_graphs, gb.num_edges
    t = max_steps + 1
    dev = gb.edge_batch.device

    active = batch.node_is_start & gb.node_mask
    missing_start = ~segment_any(active, gb.node_batch, g)
    answer_hits, answer_node_hit = _min_local_answer_hit(active, batch)
    start_node_hit = torch.where(answer_hits, answer_node_hit, torch.full_like(answer_node_hit, -1))

    done = missing_start | batch.is_dummy | (~gb.graph_mask)
    if stop_on_answer:
        done = done | answer_hits
    return EnvState(
        active_nodes=active,
        visited_nodes=active,
        used_edge_mask=torch.zeros(e, dtype=torch.bool, device=dev),
        selection_order=torch.full((e,), -1, dtype=torch.int32, device=dev),
        done=done,
        step_counts=torch.zeros(g, dtype=torch.int32, device=dev),
        answer_hits=answer_hits,
        answer_node_hit=answer_node_hit.to(torch.int32),
        start_node_hit=start_node_hit.to(torch.int32),
        action_hidden=torch.zeros(g, hidden_dim, dtype=torch.float32, device=dev),
        directions=torch.full((g, t), DIRECTION_FORWARD, dtype=torch.int32, device=dev),
        actions=torch.full((g, t), STOP_ACTION, dtype=torch.int32, device=dev),
    )


def candidate_edge_masks(state: EnvState, batch: AgentBatch, *, max_steps: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(forward, backward) candidate masks: incident to the active frontier,
    graph not done, horizon not exhausted."""
    gb = batch.graph
    eb = gb.edge_batch.long()
    horizon = state.step_counts[eb] >= max_steps
    base = (~state.done[eb]) & (~horizon) & gb.edge_mask
    fwd = base & state.active_nodes[gb.heads.long()]
    bwd = base & state.active_nodes[gb.tails.long()]
    return fwd, bwd


def env_step(
    state: EnvState,
    batch: AgentBatch,
    actions: torch.Tensor,            # [G] int32 edge id or STOP_ACTION
    action_embeddings: torch.Tensor,  # [G, H] selected edge tokens (0 for stop)
    *,
    step_index: int,
    max_steps: int,
    stop_on_answer: bool = False,
) -> EnvState:
    gb = batch.graph
    g, n, e = gb.num_graphs, gb.num_nodes, gb.num_edges
    dev = actions.device
    eb = gb.edge_batch.long()

    is_stop = (actions == STOP_ACTION) | state.done
    act = torch.where(is_stop, torch.zeros_like(actions), actions).long()  # safe index
    # One selected edge per acting graph; an action on another graph's edge
    # is dropped.  Stopped graphs all alias index 0, so the scatter is an OR.
    own = eb[act] == torch.arange(g, device=dev)
    edge_selected = segment_any((~is_stop) & own, act, e)

    used = state.used_edge_mask | edge_selected
    sel_order = torch.where(edge_selected, torch.full_like(state.selection_order, step_index),
                            state.selection_order)

    heads, tails = gb.heads.long(), gb.tails.long()
    head_active_e = state.active_nodes[heads] & edge_selected
    tail_active_e = state.active_nodes[tails] & edge_selected

    # Per-graph direction: backward iff tail active and head not.
    sel_head_active = segment_any(head_active_e, eb, g)
    sel_tail_active = segment_any(tail_active_e, eb, g)
    acting = ~is_stop
    step_directions = torch.where(acting & (~sel_head_active) & sel_tail_active,
                                  DIRECTION_BACKWARD, DIRECTION_FORWARD).to(torch.int32)

    # At step 0 record the chosen start endpoint (graph-local).
    chosen_start_glob = torch.where(sel_head_active, heads[act], tails[act]).to(torch.int32)
    local_start = chosen_start_glob - gb.node_ptr[:g].to(torch.int32)
    start_node_hit = (torch.where(acting, local_start, state.start_node_hit) if step_index == 0
                      else state.start_node_hit)

    # Frontier replacement: new actives are the far endpoints of selected edges.
    next_active = segment_any(torch.cat([head_active_e, tail_active_e]), torch.cat([tails, heads]), n)
    replace = acting[gb.node_batch.long()]
    active = torch.where(replace, next_active, state.active_nodes)
    visited = state.visited_nodes | active

    has_hit, min_local = _min_local_answer_hit(active, batch)
    newly = (~state.answer_hits) & has_hit
    answer_node_hit = torch.where(newly, min_local, state.answer_node_hit)
    answer_hits = state.answer_hits | has_hit

    # Running mean of selected edge embeddings over acting steps.
    counts = state.step_counts.to(torch.float32)[:, None]
    new_hidden = (state.action_hidden * counts + action_embeddings) / (counts + 1.0)
    action_hidden = torch.where(acting[:, None], new_hidden, state.action_hidden)

    step_counts = state.step_counts + acting.to(torch.int32)
    done = state.done | is_stop | (step_counts >= max_steps)
    if stop_on_answer:
        done = done | answer_hits

    directions = state.directions.clone()
    directions[:, step_index] = step_directions
    taken = state.actions.clone()
    taken[:, step_index] = torch.where(is_stop, torch.full_like(actions, STOP_ACTION), actions).to(torch.int32)
    return EnvState(
        active_nodes=active,
        visited_nodes=visited,
        used_edge_mask=used,
        selection_order=sel_order,
        done=done,
        step_counts=step_counts,
        answer_hits=answer_hits,
        answer_node_hit=answer_node_hit.to(torch.int32),
        start_node_hit=start_node_hit,
        action_hidden=action_hidden,
        directions=directions,
        actions=taken,
    )
