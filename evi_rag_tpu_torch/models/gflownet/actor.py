"""Multi-graph rollout as a fixed-length step loop.

Counterpart of ``evi_rag_tpu/models/gflownet/actor.py``: the ``lax.scan``
over ``max_steps + 1`` steps becomes a Python loop of tensor functions with
no host sync, and finished graphs take STOP with log-prob 0 (done-masking).
Per step: encode the state -> policy -> joint edges + STOP segment softmax
-> Gumbel-max sampling through ``segment_argmax`` (ties to the lowest edge
index), or greedy or forced replay -> pure env step.  Behaviour-cloning
statistics (per-step -logsumexp of the DAG edges' log-probs) accumulate in
the loop.

``sample_then_score`` runs the rollout in two passes: a sampling pass with
no autograd, then one differentiable score pass over all T steps at once
(``_rollout_sample_then_score``).

Random draws are arguments (``make_rollout_draws``): the Gumbel uniforms of
every step (``uniform_edge`` [T, E], ``uniform_stop`` [T, G], on
(1e-10, 1 - 1e-10) as ``jax.random.uniform`` draws them) and the policy's
dropout keep masks, drawn outside any checkpoint so that a recompute sees
the same masks.  ``remat_policy``: ``True`` recomputes everything inside its
checkpoint in the backward (``torch.utils.checkpoint``); ``"dots"`` saves
the matmul results and recomputes the rest (a selective checkpoint,
``jax.checkpoint_policies.dots_saveable``'s counterpart).  The checkpoint
holds the precomputed step tensors on the canonical path and the whole
score pass under ``sample_then_score``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

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
# The ops whose results a "dots" checkpoint saves: the matmuls, as autograd
# sees them (``@``, ``einsum`` and ``nn.functional.linear`` lower to these).
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default})


@dataclasses.dataclass(frozen=True)
class ActorConfig:
    max_steps: int
    policy_temperature: float = 1.0
    stop_on_answer: bool = False
    # Hoist the per-step edge-axis policy matmuls into batched launches
    # before the loop (``PolicyStepTensors``); off runs the canonical policy.
    precompute_policy: bool = True
    # Recompute in the backward what the forward computed inside the
    # checkpoint: False | True (everything) | "dots" (all but the matmuls).
    remat_policy: bool | str = False
    # Two passes: sample with no autograd and no per-step logsumexp (the
    # Gumbel / greedy argmax does not depend on the per-graph normaliser),
    # then score all T steps in one differentiable pass.  Uses the
    # precomputed step tensors whatever ``precompute_policy`` says.
    sample_then_score: bool = False

    @property
    def num_steps(self) -> int:
        return self.max_steps + 1


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of ``remat_policy="dots"``: save the
    matmuls' results, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in DOT_OPS else CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, remat_policy: bool | str, *args):
    """``fn(*args)`` under the checkpoint of ``remat_policy``: none when it
    is false, a selective one for ``"dots"``, a full one otherwise (as
    JAX's ``_remat_policy_of``)."""
    if not remat_policy:
        return fn(*args)
    kwargs = {}
    if remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, dots_policy)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


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


def _choose(score_edge, score_stop, valid, has_edge, eb, g: int, draws, t: int, sample: bool):
    """(choose_edge [G], best edge [G]) of step ``t``'s Gumbel-max (or, not
    sampling, greedy) choice over each graph's valid edges and STOP."""
    if sample:
        score_edge = score_edge + _gumbel(draws["uniform_edge"][t])
        score_stop = score_stop + _gumbel(draws["uniform_stop"][t])
    score_edge = torch.where(valid, score_edge, torch.full_like(score_edge, NEG_INF))
    max_v, argmax_e = segment_argmax(score_edge, eb, g, mask=valid)
    return has_edge & (max_v > score_stop), argmax_e


def advance(state, batch: AgentBatch, actions: torch.Tensor, edge_tokens: torch.Tensor, t: int,
            config: ActorConfig):
    """``env_step`` with ``actions`` [G] (STOP or an edge id) and the
    selected edges' tokens (0 for STOP)."""
    acting = actions != STOP_ACTION
    sel = torch.where(acting, actions, torch.zeros_like(actions)).long()
    sel_emb = torch.where(acting[:, None], gather_rows(edge_tokens, sel), torch.zeros((), device=actions.device))
    return env_step(state, batch, actions, sel_emb, step_index=t, max_steps=config.max_steps,
                    stop_on_answer=config.stop_on_answer)


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
    if config.sample_then_score:
        return _rollout_sample_then_score(
            policy=policy, state_encoder=state_encoder, batch=batch, edge_tokens=edge_tokens, cache=cache,
            config=config, forced_actions=forced_actions, dag_edge_mask=dag_edge_mask, train=train,
            draws=draws, sample=sample)
    edge_base = policy.compute_edge_base(edge_tokens)
    step_tensors = None
    if config.precompute_policy:
        def precompute(base, k_edge, k_head):
            return policy.precompute_steps(edge_tokens, T, edge_base=base, train=train,
                                           keep_edge=k_edge, keep_head=k_head)

        step_tensors = remat(precompute, config.remat_policy, edge_base, keep_edge, keep_head)

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
                choose_edge, argmax_e = _choose(lp_edge, lp_stop, valid, has_edge, eb, g, draws, t, sample)
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

        state = advance(state, batch, actions, edge_tokens, t, config)
        outs["log_pf"].append(log_pf)
        outs["state_out"].append(state_out.float())
        outs["actions"].append(actions)

    bc = None
    if want_bc:
        bc = (torch.stack(outs["bc_loss"], dim=1), torch.stack(outs["bc_count"], dim=1))
    return _result(state, torch.stack(outs["log_pf"], dim=1), torch.stack(outs["state_out"], dim=1),
                   torch.stack(outs["actions"], dim=1), bc, dag_edge_mask, eb, g)


def _result(state, log_pf_steps, state_emb_seq, actions_seq, bc, dag_edge_mask, eb, g) -> dict[str, torch.Tensor]:
    """The rollout's outputs from the final env state and the per-step
    [G, T] log-probs, [G, T, H] state embeddings, [G, T] actions and, with
    BC, the per-step [G, T] BC losses and counts."""
    result = {
        "log_pf": log_pf_steps.sum(dim=1),
        "log_pf_steps": log_pf_steps,
        "state_emb_seq": state_emb_seq,
        "actions_seq": actions_seq,
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
    if bc is not None:
        bc_loss, bc_count = bc
        bc_steps = bc_count.sum(dim=1)
        result["bc_loss_per_graph"] = bc_loss.sum(dim=1) / torch.clamp(bc_steps, min=1.0)
        result["bc_steps_per_graph"] = bc_steps
        result["bc_has_dag"] = segment_any(dag_edge_mask, eb, g).float()
    return result


def _rollout_sample_then_score(
    *,
    policy: GFlowNetEdgePolicy,
    state_encoder: StateEncoder,
    batch: AgentBatch,
    edge_tokens: torch.Tensor,
    cache,
    config: ActorConfig,
    forced_actions: torch.Tensor | None,
    dag_edge_mask: torch.Tensor | None,
    train: bool,
    draws: dict[str, torch.Tensor],
    sample: bool,
) -> dict[str, torch.Tensor]:
    """Two-pass rollout (``evi_rag_tpu/models/gflownet/actor.py::
    _rollout_sample_then_score``).

    Pass 1 runs the T-step loop under ``torch.no_grad``: it samples on the
    temperature-scaled logits (the Gumbel-max / greedy choice over edges +
    STOP does not depend on the per-graph log-normaliser) from the same
    draws as the canonical loop, and records each step's env snapshot
    (valid edges, frontier, step counts, done).  Forced replay never calls
    the policy.  Pass 2 is one differentiable pass over the step axis: the
    step tensors fold T into the edge axis (``PolicyStepTensors.flat``, state
    t's graphs at segment ids t * G ...), the action-history means come in
    closed form (exclusive cumulative sum / count of the selected edge
    tokens), and the log-probs and BC statistics of all T steps are one
    segment reduction each.  ``remat_policy`` checkpoints the whole score
    pass, whose step tensors it then recomputes from the same dropout
    masks."""
    gb = batch.graph
    g, e = gb.num_graphs, gb.num_edges
    eb = gb.edge_batch
    h = edge_tokens.shape[-1]
    T = config.num_steps
    temp = config.policy_temperature
    t_div = max(float(temp), MIN_TEMPERATURE)
    dev = eb.device
    keep_edge, keep_head = draws.get("keep_edge"), draws.get("keep_head")

    def precompute(tokens, k_edge, k_head):
        return policy.precompute_steps(tokens, T, train=train, keep_edge=k_edge, keep_head=k_head)

    # Without remat the score pass reuses these (differentiable) step tensors;
    # with it, pass 1 takes a copy made without autograd and the checkpoint
    # recomputes its own.
    step_tensors = None
    if not config.remat_policy:
        step_tensors = precompute(edge_tokens, keep_edge, keep_head)

    # ---- pass 1: sampling, no autograd --------------------------------
    stop = torch.full((g,), STOP_ACTION, dtype=torch.int32, device=dev)
    snaps: dict[str, list[torch.Tensor]] = {k: [] for k in ("valid", "active", "counts", "done", "actions")}
    with torch.no_grad():
        st = step_tensors if step_tensors is not None else precompute(edge_tokens, keep_edge, keep_head)
        state = env_reset(batch, max_steps=config.max_steps, hidden_dim=h, stop_on_answer=config.stop_on_answer)
        for t in range(T):
            fwd, bwd = candidate_edge_masks(state, batch, max_steps=config.max_steps)
            valid = (fwd | bwd) & ~state.used_edge_mask
            for k, v in (("valid", valid), ("active", state.active_nodes), ("counts", state.step_counts),
                         ("done", state.done)):
                snaps[k].append(v)
            if forced_actions is not None:
                actions = forced_actions[:, t].to(torch.int32)
            else:
                state_tokens = state_encoder.encode_state(cache, state, batch)
                edge_logits, stop_logits, _ = policy.apply_precomputed(st.at(t), state_tokens, eb, valid)
                choose_edge, argmax_e = _choose(edge_logits.float() / t_div, stop_logits.float() / t_div, valid,
                                                segment_any(valid, eb, g), eb, g, draws, t, sample)
                actions = torch.where(choose_edge, argmax_e.to(torch.int32), stop)
            actions = torch.where(state.done, stop, actions)
            state = advance(state, batch, actions, edge_tokens, t, config)
            snaps["actions"].append(actions)
        del st
    valid_seq, active_seq, counts_seq, done_seq, actions_t = (
        torch.stack(snaps[k]) for k in ("valid", "active", "counts", "done", "actions"))

    # ---- pass 2: one differentiable score pass over the T steps -----------
    acting = actions_t != STOP_ACTION                                     # [T, G]
    safe = torch.where(acting, actions_t, torch.zeros_like(actions_t)).long()
    sel_emb_seq = torch.where(acting[..., None], gather_rows(edge_tokens, safe.reshape(-1)).reshape(T, g, h),
                              torch.zeros((), device=dev))
    # The pre-step action-history mean: env_step's running mean after k
    # acting steps is the mean of the k selected edge tokens.
    acting_f = acting.float()
    cum_emb = torch.cumsum(sel_emb_seq, dim=0) - sel_emb_seq
    cum_cnt = torch.cumsum(acting_f, dim=0) - acting_f
    action_hidden_seq = cum_emb / torch.clamp(cum_cnt, min=1.0)[..., None]
    ids = (eb.long()[None] + g * torch.arange(T, device=dev)[:, None]).reshape(-1)   # [T E]
    valid_flat = valid_seq.reshape(-1)
    want_bc = dag_edge_mask is not None
    bc_flat = (valid_seq & dag_edge_mask[None]).reshape(-1) if want_bc else None

    def score_pass(tokens, hidden_seq, k_edge, k_head):
        st = step_tensors if step_tensors is not None else precompute(tokens, k_edge, k_head)
        state_tokens = state_encoder.encode_states_batched(cache, batch, active_seq=active_seq,
                                                           counts_seq=counts_seq, action_hidden_seq=hidden_seq)
        edge_logits, stop_logits, state_out = policy.apply_precomputed(
            st.flat(), state_tokens.reshape(T * g, h), ids, valid_flat)
        lp_edge, lp_stop, _ = log_probs_edges(edge_logits, stop_logits, ids, valid_flat, T * g, temp)
        log_pf_t = torch.where(~acting, lp_stop.reshape(T, g), torch.gather(lp_edge.reshape(T, e), 1, safe))
        log_pf_t = torch.where(done_seq, torch.zeros((), device=dev), log_pf_t)
        if not want_bc:
            return log_pf_t, state_out
        bc_lse = segment_logsumexp(lp_edge, ids, T * g, mask=bc_flat)
        return log_pf_t, state_out, bc_lse

    outs = remat(score_pass, config.remat_policy, edge_tokens, action_hidden_seq, keep_edge, keep_head)
    bc = None
    if want_bc:
        bc_valid = segment_any(bc_flat, ids, T * g).reshape(T, g)
        bc_loss = torch.where(bc_valid, -outs[2].reshape(T, g), torch.zeros((), device=dev))
        bc = (bc_loss.T, bc_valid.float().T)
    return _result(state, outs[0].T, outs[1].float().reshape(T, g, h).transpose(0, 1), actions_t.T, bc,
                   dag_edge_mask, eb, g)
