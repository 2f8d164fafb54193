"""Multi-graph rollout as a fixed-length step loop.

Counterpart of ``evi_rag_tpu/models/gflownet/actor.py``: the ``lax.scan``
over ``max_steps + 1`` steps becomes a Python loop of tensor functions with
no host sync, and finished graphs take STOP with log-prob 0 (done-masking).
Per step: encode the state -> policy -> joint edges + STOP segment softmax
-> Gumbel-max sampling through ``segment_argmax`` (ties to the lowest edge
index), or greedy or forced replay -> pure env step.  Behaviour-cloning
statistics (per-step -logsumexp of the DAG edges' log-probs) accumulate in
the loop.

Random draws are arguments (``make_rollout_draws``): the Gumbel uniforms of
every step (``uniform_edge`` [T, E], ``uniform_stop`` [T, G], on
(1e-10, 1 - 1e-10) as ``jax.random.uniform`` draws them) and the policy's
dropout keep masks.  Under ``remat_policy=True`` the precomputed step
tensors are recomputed in the backward (``torch.utils.checkpoint``) from the
same masks, which are drawn outside the checkpoint.  The two-pass
``sample_then_score`` rollout and ``remat_policy="dots"`` are not ported.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from evi_rag_tpu_torch.models.batches import AgentBatch
from evi_rag_tpu_torch.models.gflownet.embedder import EmbedOutputs
from evi_rag_tpu_torch.models.gflownet.env import (
    STOP_ACTION,
    candidate_edge_masks,
    env_reset,
    env_step,
    segment_any,
)
from evi_rag_tpu_torch.models.gflownet.policy import GFlowNetEdgePolicy, make_policy_draws
from evi_rag_tpu_torch.models.gflownet.state_encoder import StateEncoder
from evi_rag_tpu_torch.ops.segment import NEG_INF, gather_rows, segment_argmax, segment_logsumexp

MIN_TEMPERATURE = 1e-5
_UNIFORM_LO = 1e-10
_NOT_PORTED = "not ported yet (ROADMAP queue 1: the GFlowNet's sample-then-score and 'dots' remat)"


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    max_steps: int
    policy_temperature: float = 1.0
    stop_on_answer: bool = False
    # Hoist the per-step edge-axis policy matmuls into batched launches
    # before the loop (``PolicyStepTensors``); off runs the canonical policy.
    precompute_policy: bool = True
    # True: recompute the hoisted step tensors in the backward.
    remat_policy: bool | str = False
    sample_then_score: bool = False

    @property
    def num_steps(self) -> int:
        return self.max_steps + 1


def check_actor_config(config: ActorConfig) -> None:
    """Raise on the knobs the port does not have."""
    if config.sample_then_score:
        raise NotImplementedError(f"sample_then_score is {_NOT_PORTED}")
    if config.remat_policy == "dots":
        raise NotImplementedError(f"remat_policy='dots' is {_NOT_PORTED}")


def log_probs_edges(
    edge_logits: torch.Tensor,   # [E]
    stop_logits: torch.Tensor,   # [G]
    edge_batch: torch.Tensor,
    valid_edges: torch.Tensor,
    num_graphs: int,
    temperature: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(log_prob_edge [E], log_prob_stop [G], has_edge [G]) of the joint
    edges + STOP categorical."""
    t = max(float(temperature), MIN_TEMPERATURE)
    e_scaled = edge_logits.float() / t
    s_scaled = stop_logits.float() / t
    lse_edges = segment_logsumexp(e_scaled, edge_batch, num_graphs, mask=valid_edges)
    log_denom = torch.logaddexp(lse_edges, s_scaled)
    lp_edge = torch.where(valid_edges, e_scaled - log_denom[edge_batch.long()], torch.full_like(e_scaled, NEG_INF))
    return lp_edge, s_scaled - log_denom, lse_edges > NEG_INF


def make_rollout_draws(
    config: ActorConfig,
    batch: AgentBatch,
    *,
    hidden_dim: int,
    dropout: float,
    train: bool,
    sample: bool,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """A rollout's random draws on the batch's device: Gumbel uniforms when
    it samples, the policy's dropout keep masks in train mode with dropout."""
    gb = batch.graph
    dev = gb.edge_batch.device
    t = config.num_steps
    draws: dict[str, torch.Tensor] = {}
    if sample:
        for name, n in (("uniform_edge", gb.num_edges), ("uniform_stop", gb.num_graphs)):
            u = torch.rand((t, n), generator=generator, device=dev)
            draws[name] = torch.clamp(u * (1.0 - 2 * _UNIFORM_LO) + _UNIFORM_LO, min=_UNIFORM_LO)
    if train and dropout > 0.0:
        draws.update(make_policy_draws(t, gb.num_edges, hidden_dim, dropout, generator=generator, device=dev))
    return draws


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u))


def rollout(
    *,
    policy: GFlowNetEdgePolicy,
    state_encoder: StateEncoder,
    batch: AgentBatch,
    embed: EmbedOutputs,
    config: ActorConfig,
    greedy: bool = False,
    forced_actions: torch.Tensor | None = None,  # [G, T] edge ids / STOP
    dag_edge_mask: torch.Tensor | None = None,   # [E] bool, enables BC stats
    train: bool = False,
    draws: dict[str, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    check_actor_config(config)
    gb = batch.graph
    g = gb.num_graphs
    eb = gb.edge_batch
    h = embed.edge_tokens.shape[-1]
    T = config.num_steps
    temp = config.policy_temperature
    sample = forced_actions is None and not (greedy or temp < MIN_TEMPERATURE)
    if draws is None:
        draws = make_rollout_draws(config, batch, hidden_dim=h, dropout=policy.dropout, train=train,
                                   sample=sample, generator=generator)
    keep_edge, keep_head = draws.get("keep_edge"), draws.get("keep_head")

    edge_tokens = embed.edge_tokens.float()
    cache = state_encoder.precompute(batch, node_tokens=embed.node_tokens.float(),
                                     question_tokens=embed.question_tokens.float())
    edge_base = policy.compute_edge_base(edge_tokens)
    step_tensors = None
    if config.precompute_policy:
        def precompute(base, k_edge, k_head):
            return policy.precompute_steps(edge_tokens, T, edge_base=base, train=train,
                                           keep_edge=k_edge, keep_head=k_head)

        if config.remat_policy:
            step_tensors = checkpoint(precompute, edge_base, keep_edge, keep_head, use_reentrant=False)
        else:
            step_tensors = precompute(edge_base, keep_edge, keep_head)

    state = env_reset(batch, max_steps=config.max_steps, hidden_dim=h, stop_on_answer=config.stop_on_answer)
    want_bc = dag_edge_mask is not None
    stop = torch.full((g,), STOP_ACTION, dtype=torch.int32, device=eb.device)
    zero_g = torch.zeros(g, device=eb.device)
    outs: dict[str, list[torch.Tensor]] = {k: [] for k in ("log_pf", "state_out", "actions", "bc_loss", "bc_count")}
    for t in range(T):
        state_tokens = state_encoder.encode_state(cache, state, batch)
        fwd, bwd = candidate_edge_masks(state, batch, max_steps=config.max_steps)
        valid = (fwd | bwd) & ~state.used_edge_mask
        if step_tensors is not None:
            edge_logits, stop_logits, state_out = policy.apply_precomputed(step_tensors.at(t), state_tokens, eb, valid)
        else:
            edge_logits, stop_logits, state_out = policy(
                edge_tokens, state_tokens, eb, valid, edge_base=edge_base, train=train,
                keep_edge=None if keep_edge is None else keep_edge[t],
                keep_head=None if keep_head is None else keep_head[t])
        lp_edge, lp_stop, has_edge = log_probs_edges(edge_logits, stop_logits, eb, valid, g, temp)

        if forced_actions is not None:
            actions = forced_actions[:, t].to(torch.int32)
            forced_stop = actions == STOP_ACTION
            safe = torch.where(forced_stop, torch.zeros_like(actions), actions).long()
            log_pf = torch.where(forced_stop, lp_stop, lp_edge[safe])
        else:
            with torch.no_grad():
                score_edge, score_stop = lp_edge.detach(), lp_stop.detach()
                if sample:
                    score_edge = score_edge + _gumbel(draws["uniform_edge"][t])
                    score_stop = score_stop + _gumbel(draws["uniform_stop"][t])
                score_edge = torch.where(valid, score_edge, torch.full_like(score_edge, NEG_INF))
                max_v, argmax_e = segment_argmax(score_edge, eb, g, mask=valid)
                choose_edge = has_edge & (max_v > score_stop)
                actions = torch.where(choose_edge, argmax_e.to(torch.int32), stop)
            log_pf = torch.where(choose_edge, lp_edge[argmax_e.long()], lp_stop)

        # Done graphs: STOP with zero log-prob contribution.
        actions = torch.where(state.done, stop, actions)
        log_pf = torch.where(state.done, zero_g, log_pf)

        if want_bc:
            bc_mask = valid & dag_edge_mask
            bc_lse = segment_logsumexp(lp_edge, eb, g, mask=bc_mask)
            bc_valid = segment_any(bc_mask, eb, g)
            outs["bc_loss"].append(torch.where(bc_valid, -bc_lse, zero_g))
            outs["bc_count"].append(bc_valid.float())

        acting = actions != STOP_ACTION
        sel = torch.where(acting, actions, torch.zeros_like(actions)).long()
        sel_emb = torch.where(acting[:, None], gather_rows(edge_tokens, sel), torch.zeros(g, h, device=eb.device))
        state = env_step(state, batch, actions, sel_emb, step_index=t, max_steps=config.max_steps,
                         stop_on_answer=config.stop_on_answer)
        outs["log_pf"].append(log_pf)
        outs["state_out"].append(state_out.float())
        outs["actions"].append(actions)

    log_pf_steps = torch.stack(outs["log_pf"], dim=1)      # [G, T]
    result = {
        "log_pf": log_pf_steps.sum(dim=1),
        "log_pf_steps": log_pf_steps,
        "state_emb_seq": torch.stack(outs["state_out"], dim=1),
        "actions_seq": torch.stack(outs["actions"], dim=1),
        "directions_seq": state.directions,
        "selected_mask": state.used_edge_mask,
        "selection_order": state.selection_order,
        "reach_success": state.answer_hits.float(),
        "length": state.step_counts.float(),
        "answer_node_hit": state.answer_node_hit,
        "start_node_hit": state.start_node_hit,
        "active_nodes": state.active_nodes,
        "answer_hits": state.answer_hits,
    }
    if want_bc:
        bc_steps = torch.stack(outs["bc_count"], dim=1).sum(dim=1)
        result["bc_loss_per_graph"] = torch.stack(outs["bc_loss"], dim=1).sum(dim=1) / torch.clamp(bc_steps, min=1.0)
        result["bc_steps_per_graph"] = bc_steps
        result["bc_has_dag"] = segment_any(dag_edge_mask, eb, g).float()
    return result
