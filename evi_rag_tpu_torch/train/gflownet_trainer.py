"""GFlowNet training and evaluation, in eager PyTorch with autograd.

Counterpart of ``evi_rag_tpu/train/gflownet_trainer.py``.  One training step:
frozen-retriever embedding -> R sampled rollouts -> terminal reward -> the
estimator's flow states with log R at the terminal slot -> closed-form SubTB
plus the scheduled DAG behaviour-cloning term.  Dummy graphs (answer absent)
are masked out of the loss.  Eval: best-of-k rollouts -> ``answer_hit@k``.

The R rollouts, which the JAX package vmaps, run as ONE rollout over a batch
of R copies of the batch (``models.batches.replicate_agent_batch``): every
segment reduction and every ``[T, E, H]`` matmul of the R rollouts is one
launch, and each rollout keeps its own draws (its slice of the draws'
replicated edge and graph axes).

Parameters are the flax tree ``{"policy": {"params": ...}, "state_encoder":
{"params": ...}, "estimator": {"params": ...}, "edge_score_proj": {...}}``
(``gflownet_path``), with kernels ``[in, out]``, so checkpoints, digests and
the optimizer's glob patterns carry across; ``load_gflownet_params`` /
``gflownet_params_to_numpy`` move a JAX tree in and out.

A stacked ``[S, ...]`` agent batch (``data.feeder.collate_agent_stacked``)
is the data-parallel layout: the loss is the mean of the shards' losses.
In one process the shards run one after another on one device; under a
process group of ranks each rank computes its block of the shards and the gradients are all-reduced, as the retriever's step does
(``retriever_trainer.sharded_grads``).  Each shard's draws are
``actor.make_rollout_draws`` of that shard's replicated batch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from evi_rag_tpu_torch.data.feeder import prefetch
from evi_rag_tpu_torch.eval.metrics import MetricAccumulator
from evi_rag_tpu_torch.models.batches import AgentBatch, EmbedTables, materialize_agent_batch, replicate_agent_batch
from evi_rag_tpu_torch.models.gflownet.actor import MIN_TEMPERATURE, ActorConfig, make_rollout_draws, rollout
from evi_rag_tpu_torch.models.gflownet.embedder import EmbedOutputs, apply_score_bonus, embed_agent_batch_frozen
from evi_rag_tpu_torch.models.gflownet.policy import GFlowNetEdgePolicy
from evi_rag_tpu_torch.models.gflownet.reward import RewardConfig, compute_reward
from evi_rag_tpu_torch.models.gflownet.state_encoder import GFlowNetEstimator, StateEncoder
from evi_rag_tpu_torch.models.gflownet.subtb import (
    bc_weight_schedule,
    log_flow_with_terminal_reward,
    masked_graph_mean,
    subtb_per_graph,
)
from evi_rag_tpu_torch.models.retriever import Dense
from evi_rag_tpu_torch.ops.graph import batch_to
from evi_rag_tpu_torch.ops.nnfn import tree_to
from evi_rag_tpu_torch.train.checkpoint import flatten_tree, unflatten_tree
from evi_rag_tpu_torch.train.optim import Optimizer, OptimizerConfig, setup_optimizer
from evi_rag_tpu_torch.train.retriever_trainer import TrainState, sharded_grads
from evi_rag_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

POS_LABEL_THRESHOLD = 0.5
# flax lecun_normal: a normal cut at +-2 std, scaled to std sqrt(1 / fan_in).
_TRUNC_STD = 0.87962566103423978
# Zero-initialised: the policy's and the estimator's last layers, the step
# embeddings and the score bonus, so that the policy starts near-uniform.
ZERO_INIT = ("policy.edge_head_1.kernel", "policy.stop_head_1.kernel", "estimator.dense_1.kernel",
             "state_encoder.step_embeddings.embedding", "edge_score_proj.kernel")


@dataclasses.dataclass(frozen=True)
class GFlowNetConfig:
    hidden_dim: int = 1024
    max_steps: int = 3
    stop_on_answer: bool = True
    policy_temperature: float = 1.0
    eval_temperature: float = 1.0
    num_train_rollouts: int = 4
    reward: RewardConfig = RewardConfig()
    use_state_dde: bool = False
    bc_weight: float = 0.0
    bc_weight_floor: float = 0.0
    bc_hold_ratio: float = 0.0
    bc_decay_ratio: float = 0.0
    total_steps: int = 10_000
    eval_rollout_prefixes: tuple[int, ...] = (1, 10, 25, 50, 100)
    optimizer: OptimizerConfig = OptimizerConfig(name="adamw", learning_rate=1e-4)
    max_epochs: int = 10
    monitor: str = "answer_hit"
    patience: int = 5
    dropout: float = 0.1
    # Compute the frozen retriever embedding of each train batch once and
    # reuse it every epoch (fixes batch membership; the order reshuffles).
    cache_frozen_embed: bool = False
    compute_dtype: str = "float32"  # float32 | bfloat16 (the policy's per-edge network)
    precompute_policy: bool = True
    remat_policy: bool | str = False
    sample_then_score: bool = False

    @property
    def actor(self) -> ActorConfig:
        return ActorConfig(
            max_steps=self.max_steps, policy_temperature=self.policy_temperature,
            stop_on_answer=self.stop_on_answer, precompute_policy=self.precompute_policy,
            remat_policy=self.remat_policy, sample_then_score=self.sample_then_score,
        )


class GFlowNetModules(nn.Module):
    """The trainable GFlowNet: policy, state encoder, flow estimator and the
    edge-score bonus.  ``forward`` is ``rollout_losses`` (so that
    ``torch.func.functional_call`` can run it on another parameter tree)."""

    def __init__(self, cfg: GFlowNetConfig):
        super().__init__()
        self.policy = GFlowNetEdgePolicy(cfg.hidden_dim, dropout=cfg.dropout, compute_dtype=cfg.compute_dtype)
        self.state_encoder = StateEncoder(cfg.hidden_dim, cfg.max_steps, use_state_dde=cfg.use_state_dde)
        self.estimator = GFlowNetEstimator(cfg.hidden_dim)
        self.edge_score_proj = Dense(1, cfg.hidden_dim)

    def forward(self, *args, **kwargs):
        return rollout_losses(self, *args, **kwargs)


def build_modules(cfg: GFlowNetConfig) -> GFlowNetModules:
    return GFlowNetModules(cfg)


# ---------------------------------------------------------------- parameters

def gflownet_path(name: str) -> str:
    """``named_parameters()`` name -> the path in the JAX parameter tree."""
    top, rest = name.split(".", 1)
    rest = rest.replace(".", "/")
    return f"{top}/{rest}" if top == "edge_score_proj" else f"{top}/params/{rest}"


def gflownet_params_tree(modules: GFlowNetModules) -> dict[str, Any]:
    """The live parameters as the JAX tree (nested dicts of tensors)."""
    return unflatten_tree({gflownet_path(n): p for n, p in modules.named_parameters()})


def gflownet_params_to_numpy(modules: GFlowNetModules) -> dict[str, Any]:
    """The parameters as the JAX package's tree of numpy arrays."""
    return unflatten_tree({gflownet_path(n): p.detach().float().cpu().numpy() for n, p in modules.named_parameters()})


def load_gflownet_params(modules: GFlowNetModules, tree: dict[str, Any]) -> None:
    """Copy a JAX GFlowNet parameter tree (numpy arrays or tensors) into the
    modules; every parameter must be present with its shape."""
    flat = flatten_tree(tree)
    with torch.no_grad():
        for name, p in modules.named_parameters():
            path = gflownet_path(name)
            if path not in flat:
                raise KeyError(f"parameter {path} missing from the tree")
            src = torch.as_tensor(flat[path])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src.to(dtype=p.dtype, device=p.device))


def init_gflownet_params(
    cfg: GFlowNetConfig,
    modules: GFlowNetModules,
    bundle: dict[str, Any] | None = None,
    example_batch: AgentBatch | None = None,
    *,
    seed: int = 0,
    tables: EmbedTables | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """flax's initial distributions, drawn in ``named_parameters()`` order
    from a CPU generator seeded ``seed`` (every device starts from the same
    numbers): Dense kernels lecun_normal, biases zeros, LayerNorm scales
    ones, ``ZERO_INIT`` zeros.  Moves the modules to ``device`` (the card
    unless ``"cpu"`` is named) and returns their live parameter tree.
    ``bundle``, ``example_batch`` and ``tables`` are accepted for the JAX
    signature; the shapes come from ``cfg``."""
    del cfg, bundle, example_batch, tables
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    modules.to("cpu")
    with torch.no_grad():
        for name, p in modules.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name in ZERO_INIT:
                p.zero_()
            elif leaf == "kernel":
                std = math.sqrt(1.0 / p.shape[0]) / _TRUNC_STD
                nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()
    modules.to(dev)
    return gflownet_params_tree(modules)


def _device_of(modules: nn.Module) -> torch.device:
    return next(modules.parameters()).device


def bundle_on(bundle: dict[str, Any], device: torch.device) -> dict[str, Any]:
    """The feature bundle with its features as f32 tensors on ``device`` and
    its ``parity_meta`` as ints."""
    out = dict(bundle)
    out["features"] = tree_to(bundle["features"], device)
    out["parity_meta"] = {k: int(np.asarray(v)) for k, v in bundle["parity_meta"].items()}
    return out


# ---------------------------------------------------------------- the losses

def rollout_losses(
    modules: GFlowNetModules,
    bundle: dict[str, Any],
    batch: AgentBatch,
    cfg: GFlowNetConfig,
    *,
    num_rollouts: int,
    bc_weight: torch.Tensor | float,
    temperature: float,
    greedy: bool = False,
    train: bool = False,
    frozen_embed: EmbedOutputs | None = None,
    collect_rollouts: bool = False,
    draws: dict[str, torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Mean SubTB (+ BC) loss over R rollouts of a dense flat batch on the
    modules' device, and the metrics (means over the rollouts; per-graph
    ``answer_hit_graphs`` [R, G]).  ``draws`` are the rollout draws of the
    replicated batch (``actor.make_rollout_draws``; else from
    ``generator``).  ``collect_rollouts`` adds ``rollout_actions`` /
    ``rollout_directions`` [R, G, T] (edge ids of ``batch``, -1 for STOP)
    and ``rollout_hits`` [R, G].

    A stacked ``[S, ...]`` batch runs shard by shard (``frozen_embed`` and
    ``draws`` then hold one entry per shard): the mean loss, the scalar
    metrics averaged over the shards and the per-graph ones stacked on a
    leading shard axis."""
    if batch.question_emb.ndim == 3:
        parts = [rollout_losses(
            modules, bundle, batch.shard(i), cfg, num_rollouts=num_rollouts, bc_weight=bc_weight,
            temperature=temperature, greedy=greedy, train=train,
            frozen_embed=None if frozen_embed is None else frozen_embed[i], collect_rollouts=collect_rollouts,
            draws=None if draws is None else draws[i], generator=generator,
        ) for i in range(batch.question_emb.shape[0])]
        per_shard = {k: torch.stack([m[k] for _, m in parts]) for k in parts[0][1]}
        return (torch.stack([lo for lo, _ in parts]).mean(),
                {k: v.mean(0) if v.ndim == 1 else v for k, v in per_shard.items()})
    gb = batch.graph
    g, e = gb.num_graphs, gb.num_edges
    r = num_rollouts
    base = frozen_embed if frozen_embed is not None else embed_agent_batch_frozen(bundle, batch)
    esp = {"kernel": modules.edge_score_proj.kernel, "bias": modules.edge_score_proj.bias}
    embed = apply_score_bonus(base, batch, esp)
    rep = replicate_agent_batch(batch, r)
    rembed = EmbedOutputs(*(t.repeat(r, 1) for t in (embed.edge_tokens, embed.node_tokens, embed.question_tokens)))
    need_bc = train and cfg.bc_weight > 0.0
    dag = ((rep.edge_labels > POS_LABEL_THRESHOLD) & rep.graph.edge_mask) if need_bc else None
    ro = rollout(
        policy=modules.policy, state_encoder=modules.state_encoder, batch=rep, embed=rembed,
        config=dataclasses.replace(cfg.actor, policy_temperature=temperature), greedy=greedy,
        dag_edge_mask=dag, train=train, draws=draws, generator=generator,
    )
    with torch.no_grad():
        rw = compute_reward(rep, selected_mask=ro["selected_mask"], answer_hit=ro["answer_hits"],
                            start_node_hit=ro["start_node_hit"], answer_node_hit=ro["answer_node_hit"],
                            config=cfg.reward)
    not_dummy = (~rep.is_dummy) & rep.graph.graph_mask
    # Dummy / padding graphs carry -inf log R: zero it for the loss and keep
    # those graphs out of the SubTB mean.
    log_r = torch.where(not_dummy, rw.log_reward, torch.zeros_like(rw.log_reward))
    lengths = ro["length"].to(torch.int32)
    flows = log_flow_with_terminal_reward(modules.estimator(ro["state_emb_seq"], rembed.question_tokens),
                                          log_r, lengths)
    nd = not_dummy.reshape(r, g)
    l_subtb = masked_graph_mean(subtb_per_graph(flows, ro["log_pf_steps"], lengths).reshape(r, g), nd)  # [R]
    count = torch.clamp(nd.float().sum(-1), min=1.0)

    def graph_mean(x: torch.Tensor) -> torch.Tensor:  # [R*G] -> [R] mean over the real graphs
        x = x.reshape(r, g)
        return torch.where(nd, x, torch.zeros_like(x)).sum(-1) / count

    bc = graph_mean(ro["bc_loss_per_graph"]) if need_bc else torch.zeros_like(l_subtb)
    losses = l_subtb + bc_weight * bc
    success = torch.where(nd, rw.success.reshape(r, g), torch.zeros(r, g, device=nd.device))
    metrics = {
        "subtb_loss": l_subtb.mean().detach(),
        "bc_loss": bc.mean().detach(),
        "answer_hit_graphs": success,
        "answer_hit": graph_mean(rw.success).mean(),
        "log_reward": graph_mean(rw.log_reward).mean(),
        "length_mean": graph_mean(rw.path_len).mean(),
        "semantic": graph_mean(rw.semantic_score).mean(),
    }
    if collect_rollouts:
        acts = ro["actions_seq"].reshape(r, g, -1)
        offset = (torch.arange(r, device=acts.device, dtype=acts.dtype) * e)[:, None, None]
        metrics["rollout_actions"] = torch.where(acts >= 0, acts - offset, acts)
        metrics["rollout_directions"] = ro["directions_seq"].reshape(r, g, -1)
        metrics["rollout_hits"] = ro["answer_hits"].reshape(r, g)
    return losses.mean(), metrics


def _prepare(batch: AgentBatch, dev: torch.device, tables: EmbedTables | None) -> AgentBatch:
    return materialize_agent_batch(batch_to(batch, dev), tables)


def train_rollout_draws(cfg: GFlowNetConfig, batch: AgentBatch,
                        generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """The draws a training ``rollout_losses`` of the flat ``batch`` makes
    (``actor.make_rollout_draws`` over its R copies), from ``generator``."""
    return make_rollout_draws(
        cfg.actor, replicate_agent_batch(batch, cfg.num_train_rollouts), hidden_dim=cfg.hidden_dim,
        dropout=cfg.dropout, train=True, sample=cfg.policy_temperature >= MIN_TEMPERATURE, generator=generator)


def make_gfn_train_step(
    modules: GFlowNetModules,
    tx: Optimizer,
    cfg: GFlowNetConfig,
    bundle: dict[str, Any],
    tables: EmbedTables | None = None,
) -> Callable[..., tuple[TrainState, dict[str, torch.Tensor]]]:
    """One update: ``step(state, batch, frozen_embed=None, draws=None)``
    moves the batch to the modules' device, resolves an id-feed batch from
    ``tables``, and returns the new state and device scalars (``loss``,
    ``bc_weight`` and the metrics).  The BC weight is a tensor function of
    the step.  A stacked batch takes ``frozen_embed`` and ``draws`` as one
    entry per shard; under a process group of ranks the step is
    data-parallel (``retriever_trainer.sharded_grads``)."""
    hold = int(round(cfg.total_steps * cfg.bc_hold_ratio))
    decay = int(round(cfg.total_steps * cfg.bc_decay_ratio))

    def step(state: TrainState, batch: AgentBatch, frozen_embed: EmbedOutputs | None = None,
             draws: dict[str, torch.Tensor] | None = None):
        dev = _device_of(modules)
        batch = _prepare(batch, dev, tables)
        bc_w = bc_weight_schedule(torch.tensor(state.step, dtype=torch.int32), bc_weight=cfg.bc_weight,
                                  bc_weight_floor=cfg.bc_weight_floor, hold_steps=hold, decay_steps=decay)
        kw = dict(num_rollouts=cfg.num_train_rollouts, bc_weight=bc_w, temperature=cfg.policy_temperature,
                  train=True)
        if batch.question_emb.ndim == 3:
            def shard_loss(i: int, d):
                lo, m = rollout_losses(modules, bundle, batch.shard(i), cfg, draws=d,
                                       frozen_embed=None if frozen_embed is None else frozen_embed[i], **kw)
                return lo, {k: v for k, v in m.items() if k != "answer_hit_graphs"}

            def draws_fn(i: int):
                return draws[i] if draws is not None else train_rollout_draws(cfg, batch.shard(i), state.generator)

            loss, metrics, named = sharded_grads(modules, batch.question_emb.shape[0], shard_loss, draws_fn)
            grads = {gflownet_path(n): g for n, g in named.items()}
        else:
            modules.zero_grad(set_to_none=True)
            loss, metrics = rollout_losses(modules, bundle, batch, cfg, frozen_embed=frozen_embed, draws=draws,
                                           generator=state.generator, **kw)
            loss.backward()
            grads = {gflownet_path(n): (p.grad if p.grad is not None else torch.zeros_like(p))
                     for n, p in modules.named_parameters()}
        params = flatten_tree(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, params)
        with torch.no_grad():
            for path, u in updates.items():
                params[path].add_(u)
        out = {k: v.detach() for k, v in metrics.items() if k != "answer_hit_graphs"}
        out["loss"] = loss.detach()
        out["bc_weight"] = bc_w
        return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1,
                          generator=state.generator), out

    return step


def _module_params(modules: GFlowNetModules, params: Any) -> dict[str, torch.Tensor]:
    dev = _device_of(modules)
    flat = flatten_tree(params)
    return {n: torch.as_tensor(flat[gflownet_path(n)], dtype=p.dtype, device=dev) for n, p in modules.named_parameters()}


def make_gfn_eval_step(
    modules: GFlowNetModules,
    cfg: GFlowNetConfig,
    bundle: dict[str, Any],
    *,
    num_rollouts: int | None = None,
    tables: EmbedTables | None = None,
    collect_rollouts: bool = False,
) -> Callable[..., dict[str, torch.Tensor]]:
    """Best-of-k eval: ``step(params, batch, generator=None, draws=None)``
    gives ``answer_hit@{k}`` (dummy agents excluded through
    ``graph_valid``) and ``answer_hit_ref@{k}`` (dummies count as misses,
    the reference protocol) per graph, over ``num_rollouts`` rollouts at
    ``cfg.eval_temperature`` (greedy below 1e-5)."""
    ks = tuple(cfg.eval_rollout_prefixes)
    r = num_rollouts if num_rollouts is not None else max(ks)

    @torch.no_grad()
    def step(params, batch: AgentBatch, generator: torch.Generator | None = None,
             draws: dict[str, torch.Tensor] | None = None) -> dict[str, torch.Tensor]:
        batch = _prepare(batch, _device_of(modules), tables)
        loss, metrics = functional_call(
            modules, _module_params(modules, params), (bundle, batch, cfg),
            dict(num_rollouts=r, bc_weight=0.0, temperature=cfg.eval_temperature,
                 collect_rollouts=collect_rollouts, draws=draws, generator=generator),
        )
        hits = metrics.pop("answer_hit_graphs") > 0.5                 # [R, G]
        not_dummy = (~batch.is_dummy) & batch.graph.graph_mask
        cum = torch.cumsum(hits.to(torch.int32), dim=0) > 0
        out = dict(metrics)
        out["loss"] = loss
        for k in ks:
            hit_k = cum[min(max(int(k), 1), r) - 1]
            out[f"answer_hit@{k}"] = hit_k.float()
            out[f"answer_hit_ref@{k}"] = (hit_k & not_dummy).float()
        out["graph_valid"] = not_dummy
        out["graph_valid_ref"] = batch.graph.graph_mask
        return out

    return step


def evaluate_gflownet(params, eval_step: Callable, batches: Iterable[AgentBatch], *,
                      generator: torch.Generator | None = None) -> dict[str, float]:
    return evaluate_gflownet_results(eval_step(params, b, generator) for b in batches)


def evaluate_gflownet_results(results: Iterable[dict]) -> dict[str, float]:
    """Aggregate ``eval_step`` outputs over a split (per-graph hit metrics
    over their valid graphs, the scalars over batches)."""
    acc = MetricAccumulator()
    for res in results:
        res = dict(res)
        for k in ("rollout_actions", "rollout_directions", "rollout_hits"):
            res.pop(k, None)
        valid, valid_ref = res.pop("graph_valid"), res.pop("graph_valid_ref")
        acc.update({k: v for k, v in res.items() if k.startswith("answer_hit@")}, valid)
        acc.update({k: v for k, v in res.items() if k.startswith("answer_hit_ref@")}, valid_ref)
        for name, v in res.items():
            if not name.startswith(("answer_hit@", "answer_hit_ref@")):
                acc.update({name: v}, np.ones((), bool))
    return acc.compute()


def fit_gflownet(
    cfg: GFlowNetConfig,
    bundle: dict[str, Any],
    train_batches: Callable[[int], Iterable[AgentBatch]],
    val_batches: Callable[[], Iterable[AgentBatch]],
    *,
    seed: int = 0,
    eval_rollouts: int = 4,
    tables: EmbedTables | None = None,
    device: str | torch.device | None = None,
) -> tuple[dict, dict[str, Any]]:
    """Epoch loop with monitored early stopping on ``device`` (the card
    unless ``"cpu"`` is named); returns (best parameters as a tree of
    tensors, history with ``final_state`` and ``modules``)."""
    dev = resolve_device(device)
    bundle = bundle_on(bundle, dev)
    modules = build_modules(cfg)
    first = next(iter(train_batches(0)))
    params = init_gflownet_params(cfg, modules, bundle, first, seed=seed, tables=tables, device=dev)
    tx = setup_optimizer(cfg.optimizer, flatten_tree(params))
    state = TrainState(params=params, opt_state=tx.init(flatten_tree(params)), step=0,
                       generator=torch.Generator(device=dev).manual_seed(seed + 1))
    train_step = make_gfn_train_step(modules, tx, cfg, bundle, tables=tables)
    eval_step = make_gfn_eval_step(modules, cfg, bundle, num_rollouts=eval_rollouts, tables=tables)

    best_score, best_params, bad = -float("inf"), _snapshot(state.params), 0
    cached = None
    history: list[dict] = []
    for epoch in range(cfg.max_epochs):
        t0 = time.time()
        last: dict = {}
        if cfg.cache_frozen_embed:
            if cached is None:
                cached = []
                for b in train_batches(0):
                    b = _prepare(b, dev, tables)
                    cached.append((b, embed_agent_batch_frozen(bundle, b)))
            for j in np.random.default_rng([seed, epoch]).permutation(len(cached)):
                state, last = train_step(state, *cached[j])
        else:
            for batch in prefetch(iter(train_batches(epoch))):
                state, last = train_step(state, batch)
        val = evaluate_gflownet(state.params, eval_step, val_batches(),
                                generator=torch.Generator(device=dev).manual_seed(1000 + epoch))
        score = val.get(cfg.monitor, val.get("answer_hit", -float("inf")))
        history.append({"epoch": epoch, "val": val, "train_loss": float(last.get("loss", float("nan"))),
                        "seconds": time.time() - t0})
        log.info("gfn epoch %d monitor=%.4f", epoch, score)
        if score > best_score:
            best_score, best_params, bad = score, _snapshot(state.params), 0
        else:
            bad += 1
            if bad > cfg.patience:
                break
    return best_params, {"history": history, "best_score": best_score, "final_state": state, "modules": modules}


def _snapshot(params: dict[str, Any]) -> dict[str, Any]:
    return unflatten_tree({k: v.detach().clone() for k, v in flatten_tree(params).items()})
