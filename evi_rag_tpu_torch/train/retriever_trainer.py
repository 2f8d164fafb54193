"""Retriever training and evaluation loop, in eager PyTorch with autograd.

Counterpart of ``evi_rag_tpu/train/retriever_trainer.py``:

* ``make_train_step`` builds one update: forward, InfoNCE (+ BCE), backward,
  the optax-rule optimizer.  Stacked batches keep their semantics: the loss
  is the mean of the per-shard losses.  In one process all shards run on
  one device (each shard's backward runs before the next shard's forward,
  so only one shard's activations are alive at a time).  Under a process
  group of n ranks (one process per device, JAX's data-parallel mesh in the
  torch idiom), rank r computes its block of the
  shards and the gradients, loss and metrics are all-reduced (the sum over
  the shards, then / S: JAX's mean over the vmapped shards), so every rank
  applies the same update.  Every rank builds the same stacked batch from
  the same seed and draws every shard's random draws in order, keeping its
  own, so the generators stay in step.  ``remat`` recomputes the forward
  in the backward (``torch.utils.checkpoint``); the random draws are made
  *outside* the checkpointed function, because a recompute would otherwise
  draw other masks from the explicit generator.  While a ``torch.profiler``
  session records, each step is one call of ``utils/profiling.py``'s
  registry with three spans: ``train.upload`` (``batch_to`` and the id
  feed's lookup), ``train.forward_backward`` and ``train.optimizer`` (the
  update, the parameter add, ``grad_norm``).
* ``make_eval_step`` computes the full per-graph metric suite and the
  FeatureMonitor terms on the device.
* ``fit`` drives epochs with the reference's model selection: a monitored
  metric, early stopping, the best parameters kept, ``resume_from``.

Parameters travel as the flax variable tree ``{"params": {...}}``
(``models.retriever.params_tree``); the train state holds the module's live
parameters in that form.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from evi_rag_tpu_torch.data.feeder import prefetch
from evi_rag_tpu_torch.eval.metrics import (
    MetricAccumulator,
    answer_reachability_sweeps,
    bridge_positive_coverage,
    edge_recall_at_k,
    prob_quality,
    score_margin,
)
from evi_rag_tpu_torch.models.batches import EmbedTables, RetrieverBatch, materialize_retriever_batch
from evi_rag_tpu_torch.models.losses import RetrieverLossConfig, retriever_loss
from evi_rag_tpu_torch.models.retriever import Retriever, flax_path, init_parameters, params_tree
from evi_rag_tpu_torch.ops.graph import batch_to
from evi_rag_tpu_torch.parallel.multihost import all_reduce_mean, owned_shards, world_size
from evi_rag_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint, unflatten_tree
from evi_rag_tpu_torch.train.optim import Optimizer, OptimizerConfig, setup_optimizer
from evi_rag_tpu_torch.utils import profiling
from evi_rag_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    params: dict[str, Any]        # {"params": {...}}: the module's live parameters
    opt_state: dict[str, torch.Tensor]
    step: int
    generator: torch.Generator    # dropout / hide-and-seek draws


@dataclasses.dataclass(frozen=True)
class RetrieverTrainConfig:
    loss: RetrieverLossConfig = RetrieverLossConfig()
    optimizer: OptimizerConfig = OptimizerConfig(name="adamw", learning_rate=1e-4)
    max_epochs: int = 10
    monitor: str = "answer/reachability@100"
    monitor_mode: str = "max"
    patience: int = 5
    k_values: tuple[int, ...] = (1, 10, 25, 50, 100, 200, 300, 400, 500)
    # Recompute the forward in the backward: more FLOPs, less activation memory.
    remat: bool = False


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def create_train_state(
    model: Retriever,
    example_batch: RetrieverBatch,
    cfg: RetrieverTrainConfig,
    *,
    seed: int = 0,
    tables: EmbedTables | None = None,
    device: str | torch.device | None = None,
) -> tuple[TrainState, Optimizer]:
    """Initialise the parameters (flax's distributions, a CPU generator
    seeded ``seed``, so every device starts from the same numbers), move the
    module to ``device`` (the card unless ``"cpu"`` is named) and build the
    optimizer.  The draws' generator is seeded ``seed + 1``.
    ``example_batch`` and ``tables`` are accepted for the JAX signature; the
    module's shapes come from its fields."""
    del example_batch, tables
    dev = resolve_device(device)
    model.to("cpu")
    init_parameters(model, torch.Generator().manual_seed(seed))
    model.to(dev)
    params = params_tree(model)
    tx = setup_optimizer(cfg.optimizer, flatten_tree(params))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    return TrainState(params=params, opt_state=tx.init(flatten_tree(params)), step=0, generator=gen), tx


def shard_loss(
    model: Retriever,
    loss_cfg: RetrieverLossConfig,
    batch: RetrieverBatch,
    *,
    draws: dict[str, Any] | None = None,
    generator: torch.Generator | None = None,
    remat: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Loss and metrics of one flat (dense) batch in train mode."""
    if draws is None:
        draws = model.make_draws(batch, train=True, generator=generator)
    if remat:
        out = checkpoint(lambda b, d: model(b, train=True, draws=d), batch, draws, use_reentrant=False)
    else:
        out = model(batch, train=True, draws=draws)
    gb = batch.graph
    lo = retriever_loss(
        out.logits, batch.edge_labels, gb.edge_batch, num_graphs=gb.num_graphs,
        graph_mask=gb.graph_mask, edge_mask=gb.edge_mask, config=loss_cfg,
        edge_is_near=batch.edge_is_near if loss_cfg.requires_edge_is_near else None,
    )
    return lo.loss, {**lo.components, **lo.metrics}


def sharded_grads(
    module: torch.nn.Module,
    num_shards: int,
    shard_loss_fn: Callable[[int, Any], tuple[torch.Tensor, dict[str, torch.Tensor]]],
    draws_fn: Callable[[int], Any],
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(mean loss over the shards, mean metrics, ``{parameter name: mean
    gradient}``) of a stacked batch.  ``draws_fn(i)`` makes shard i's draws,
    called for every shard in order; ``shard_loss_fn(i, draws)`` gives the
    loss and metrics of each shard this process owns (``owned_shards``:
    all, or its block under a process group of ranks), whose backward runs
    at once.  The gradients, loss and metrics are summed in shard order,
    all-reduced over the ranks, then divided by ``num_shards``."""
    own = owned_shards(num_shards)
    named = list(module.named_parameters())
    module.zero_grad(set_to_none=True)
    loss, sums, grads = None, {}, None
    for i in range(num_shards):
        d = draws_fn(i)
        if i not in own:
            continue
        lo, metrics = shard_loss_fn(i, d)
        lo.backward()
        g = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in named]
        module.zero_grad(set_to_none=True)
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = lo.detach() if loss is None else loss + lo.detach()
        for k, v in metrics.items():
            sums[k] = v.detach().float() if k not in sums else sums[k] + v.detach().float()
    keys = sorted(sums)
    scalars = torch.stack([loss.float()] + [sums[k] for k in keys])
    all_reduce_mean(grads + [scalars], num_shards)
    return scalars[0], dict(zip(keys, scalars[1:])), {name: g for (name, _), g in zip(named, grads)}


def loss_and_grads(
    model: Retriever,
    cfg: RetrieverTrainConfig,
    stacked: RetrieverBatch,
    *,
    generator: torch.Generator | None = None,
    draws: list[dict[str, Any]] | None = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(mean loss over shards, mean metrics, ``{flax path: grad}``) of a
    stacked dense batch on the module's device (``sharded_grads``; under a
    process group this rank computes its shards and the results are
    all-reduced).  ``draws`` gives each shard's draws (else they come from
    ``generator``, every shard's in order)."""
    n = stacked.question_emb.shape[0]

    def draws_fn(i: int):
        if draws is not None:
            return draws[i]
        return model.make_draws(stacked.shard(i), train=True, generator=generator)

    loss, metrics, grads = sharded_grads(
        model, n, lambda i, d: shard_loss(model, cfg.loss, stacked.shard(i), draws=d, remat=cfg.remat),
        draws_fn)
    return loss, metrics, {flax_path(name): g for name, g in grads.items()}


def make_train_step(
    model: Retriever,
    tx: Optimizer,
    cfg: RetrieverTrainConfig,
    tables: EmbedTables | None = None,
) -> Callable[[TrainState, RetrieverBatch], tuple[TrainState, dict[str, torch.Tensor]]]:
    """One update over a stacked ``[S, ...]`` batch (moved to the module's
    device; an id-feed batch is resolved from ``tables`` there).  Returns
    the new state and device scalars (``loss``, ``grad_norm``, the loss's
    components and metrics).  Under a process group of ranks the step is
    data-parallel: see ``sharded_grads``."""

    @profiling.one_call
    def step(state: TrainState, stacked: RetrieverBatch):
        dev = _model_device(model)
        with profiling.span("train.upload"):
            stacked = materialize_retriever_batch(batch_to(stacked, dev), tables)
        with profiling.span("train.forward_backward"):
            loss, metrics, grads = loss_and_grads(model, cfg, stacked, generator=state.generator)
        with profiling.span("train.optimizer"):
            params = flatten_tree(state.params)
            updates, opt_state = tx.update(grads, state.opt_state, params)
            with torch.no_grad():
                for path, u in updates.items():
                    params[path].add_(u)
            grad_norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["grad_norm"] = grad_norm
        return TrainState(params=state.params, opt_state=opt_state, step=state.step + 1,
                          generator=state.generator), metrics

    return step


def _module_params(model: torch.nn.Module, params: dict[str, Any]) -> dict[str, torch.Tensor]:
    """A flax variable tree -> ``functional_call``'s ``{module name: tensor}``
    on the module's device."""
    dev = _model_device(model)
    flat = flatten_tree(params)
    return {name: torch.as_tensor(flat[flax_path(name)], dtype=p.dtype, device=dev)
            for name, p in model.named_parameters()}


def make_eval_step(
    model: Retriever, cfg: RetrieverTrainConfig, tables: EmbedTables | None = None,
) -> Callable[[Any, RetrieverBatch], dict[str, Any]]:
    """Per-batch metric computation for a flat batch: ``step(params,
    batch)`` runs the module with ``params`` (a flax variable tree)."""
    ks = cfg.k_values

    @torch.no_grad()
    def step(params, batch: RetrieverBatch) -> dict[str, Any]:
        dev = _model_device(model)
        batch = materialize_retriever_batch(batch_to(batch, dev), tables)
        out = functional_call(model, _module_params(model, params), (batch,), {"train": False})
        scores, labels = out.logits, batch.edge_labels
        res: dict[str, Any] = {}
        rec = edge_recall_at_k(scores, labels, batch, ks)
        res.update({f"edge/{k}": v for k, v in rec.items() if k != "graph_valid"})
        res["edge/graph_valid"] = rec["graph_valid"]
        bridge_sub = ~batch.edge_is_near
        brec = edge_recall_at_k(scores, labels, batch, ks, subset_mask=bridge_sub, require_positive=True)
        res.update({f"bridge/{k}": v for k, v in brec.items() if k != "graph_valid"})
        res["bridge/graph_valid"] = brec["graph_valid"]
        reach, res["cc_sweeps"] = answer_reachability_sweeps(scores, batch, ks)
        res.update({f"answer/{k}": v for k, v in reach.items() if k != "graph_valid"})
        res["answer/graph_valid"] = reach["graph_valid"]
        sm = score_margin(scores, labels, batch)
        res["edge/score_margin"] = sm["margin"]
        # The bounded [0, 1] form of the margin: graphs whose worst positive
        # outranks their best negative.
        res["edge/margin_positive_rate"] = (sm["margin"] > 0).float()
        res["edge/margin_valid"] = sm["graph_valid"]
        pq = prob_quality(scores, labels, batch, subset_mask=bridge_sub)
        res.update({f"bridge/{k}": v for k, v in pq.items() if k != "graph_valid"})
        res["bridge/quality_valid"] = pq["graph_valid"]
        res["coverage"] = bridge_positive_coverage(labels, batch)
        # FeatureMonitor terms: mean sigmoid prob by label, edge-feature norm.
        emask = batch.graph.edge_mask
        probs = torch.sigmoid(scores)
        pos, neg = (labels > 0.5) & emask, (labels <= 0.5) & emask
        zero = torch.zeros_like(probs)
        res["features/pos_prob_avg"] = torch.where(pos, probs, zero).sum() / pos.sum().clamp(min=1)
        res["features/neg_prob_avg"] = torch.where(neg, probs, zero).sum() / neg.sum().clamp(min=1)
        norms = torch.linalg.vector_norm(out.edge_embeddings, dim=-1)
        res["features/norm_avg"] = torch.where(emask, norms, torch.zeros_like(norms)).sum() / emask.sum().clamp(min=1)
        res["logits"] = scores
        res["logits_fwd"] = out.logits_fwd
        res["logits_bwd"] = out.logits_bwd
        return res

    return step


def evaluate(params: Any, eval_step: Callable, batches: Iterable[RetrieverBatch]) -> dict[str, float]:
    """Aggregate the metric suite over an eval split."""
    return evaluate_results(eval_step(params, b) for b in batches)


def evaluate_results(results: Iterable[dict]) -> dict[str, float]:
    """Aggregate precomputed ``eval_step`` outputs."""
    acc, cov, feat = MetricAccumulator(), MetricAccumulator(), MetricAccumulator()
    for res in results:
        feat.update({k: res[k] for k in ("features/pos_prob_avg", "features/neg_prob_avg",
                                         "features/norm_avg")}, np.ones((), bool))
        groups = {
            "edge/graph_valid": [k for k in res if k.startswith("edge/recall")],
            "bridge/graph_valid": [k for k in res if k.startswith("bridge/recall")],
            "answer/graph_valid": [k for k in res if k.startswith("answer/reach")],
            "edge/margin_valid": ["edge/score_margin", "edge/margin_positive_rate"],
            "bridge/quality_valid": ["bridge/pos_prob", "bridge/neg_prob", "bridge/separation"],
        }
        for valid_key, names in groups.items():
            acc.update({n: res[n] for n in names}, res[valid_key])
        cov.update_sums(res["coverage"])
    out = acc.compute()
    c = cov._sums
    out["bridge/pos_edge_frac"] = c.get("bridge_pos_edges", 0.0) / max(c.get("total_pos_edges", 0.0), 1e-8)
    out["bridge/pos_graph_frac"] = c.get("graphs_with_bridge_pos", 0.0) / max(c.get("graphs_with_pos", 0.0), 1e-8)
    out.update(feat.compute())
    out["features/separation_gap"] = (out.get("features/pos_prob_avg", 0.0)
                                      - out.get("features/neg_prob_avg", 0.0))
    return out


def _restore(state: TrainState, resume_from: str) -> TrainState:
    """Parameters (+ the optimizer state when the checkpoint has one) and
    the step from a checkpoint directory."""
    tree, meta = load_checkpoint(resume_from)
    params = flatten_tree(state.params)
    with torch.no_grad():
        for path, leaf in flatten_tree(tree["params"]).items():
            if path not in params:
                raise KeyError(f"checkpoint parameter {path} not in the model")
            params[path].copy_(torch.as_tensor(np.asarray(leaf)).to(params[path].device))
    opt_state = state.opt_state
    if meta.get("has_opt_state") and "opt_state" in tree:
        saved = flatten_tree(tree["opt_state"])
        if set(saved) != set(opt_state):
            raise KeyError("checkpoint optimizer state does not match the optimizer")
        opt_state = {k: torch.as_tensor(np.asarray(v)).to(opt_state[k].device) for k, v in saved.items()}
    log.info("resumed from %s at step %s", resume_from, meta.get("step"))
    return TrainState(params=state.params, opt_state=opt_state, step=int(meta.get("step") or 0),
                      generator=state.generator)


def fit(
    model: Retriever,
    cfg: RetrieverTrainConfig,
    train_batches: Callable[[int], Iterable[RetrieverBatch]],
    val_batches: Callable[[], Iterable[RetrieverBatch]],
    *,
    seed: int = 0,
    log_every: int = 50,
    resume_from: str | None = None,
    mesh=None,
    tables: EmbedTables | None = None,
    device: str | torch.device | None = None,
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Epoch loop with monitored early stopping; returns (best params as a
    flax variable tree of tensors, history).  ``resume_from`` restores the
    parameters (+ the optimizer state when saved) from a checkpoint.
    Under a process group of n ranks the training is data-parallel (one
    process per device), every rank from the same seed and batches; the
    history and the best parameters are the same on every rank.  ``mesh``
    (JAX's signature) is the data axis: its size must be the group's."""
    if mesh is not None and mesh.size != world_size():
        raise ValueError(
            f"a {mesh.size}-device training mesh runs one process per device, but the process group has "
            f"{world_size()}: launch with EVI_DISTRIBUTED=1 torchrun --nproc-per-node {mesh.size} (or the EVI_* "
            "variables)")
    first = next(iter(train_batches(0)))
    state, tx = create_train_state(model, first, cfg, seed=seed, tables=tables, device=device)
    if resume_from:
        state = _restore(state, resume_from)
    train_step = make_train_step(model, tx, cfg, tables=tables)
    eval_step = make_eval_step(model, cfg, tables=tables)

    sign = 1.0 if cfg.monitor_mode == "max" else -1.0
    best_score = -float("inf")
    best_params = _snapshot(state.params)
    bad_epochs = 0
    history: list[dict[str, Any]] = []
    for epoch in range(cfg.max_epochs):
        t0 = time.time()
        n_steps, last_metrics = 0, None
        for batch in prefetch(iter(train_batches(epoch))):
            state, last_metrics = train_step(state, batch)
            n_steps += 1
            if n_steps % log_every == 0:
                log.info("epoch %d step %d loss %.4f", epoch, n_steps, float(last_metrics["loss"]))
        last_loss = float(last_metrics["loss"]) if last_metrics is not None else float("nan")
        val = evaluate(state.params, eval_step, val_batches())
        score = sign * val.get(cfg.monitor, -float("inf"))
        history.append({"epoch": epoch, "val": val, "train_loss": last_loss, "seconds": time.time() - t0})
        log.info("epoch %d %s=%.4f", epoch, cfg.monitor, val.get(cfg.monitor, float("nan")))
        if score > best_score:
            best_score, best_params, bad_epochs = score, _snapshot(state.params), 0
        else:
            bad_epochs += 1
            if bad_epochs > cfg.patience:
                log.info("early stop at epoch %d", epoch)
                break
    return best_params, {"history": history, "best_score": sign * best_score, "final_state": state}


def _snapshot(params: dict[str, Any]) -> dict[str, Any]:
    """A detached copy of a parameter tree, on the same device."""
    return unflatten_tree({k: v.detach().clone() for k, v in flatten_tree(params).items()})
