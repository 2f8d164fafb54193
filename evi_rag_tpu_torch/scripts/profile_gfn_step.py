"""Profile the GFlowNet train step on the card, stage by stage.

Counterpart of the JAX package's ``scripts/profile_gfn_step.py``.  Two
outputs:

1. a stage breakdown: each part of the step timed alone with CUDA events
   (best of 3 windows of ``--iters`` calls after a warm-up call): the frozen
   embed, one rollout's forward, the R rollouts and the loss forward,
   forward + backward, the optimizer apply, the full step with the frozen
   embed cached and inline, and four sample-then-score variants;
2. with ``--trace DIR``, a ``torch.profiler`` trace of three full steps
   (``utils.profiling.trace``: ``DIR/trace.json``).

The batch is ``bench.bench_gflownet_step``'s (``_build``: the synthetic
dataset at seed 5, agent samples with ``edge_top_k`` 200 and random
retriever scores from seed 0, a retriever bundle of the port's init at
seed 0, the GFlowNet at seed 0 with its draws seeded 1), so the numbers line
up with the bench's ``gflownet_step_graphs_per_sec*`` keys.  The port's own
init and draws stand in for JAX's: timings do not depend on them.

Usage::

    python -m evi_rag_tpu_torch.scripts.profile_gfn_step [--trace DIR] [--iters 5] [--graphs 16] \\
        [--dropout 0.1] [--remat] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from evi_rag_tpu_torch.data.feeder import collate_agent, fixed_agent_bucket
from evi_rag_tpu_torch.data.g_agent import AgentSettings, build_agent_sample
from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
from evi_rag_tpu_torch.models.retriever import Retriever, init_parameters, params_to_numpy
from evi_rag_tpu_torch.ops.graph import batch_to
from evi_rag_tpu_torch.train import gflownet_trainer as gt
from evi_rag_tpu_torch.train.checkpoint import export_retriever_features, flatten_tree
from evi_rag_tpu_torch.train.optim import OptimizerConfig
from evi_rag_tpu_torch.train.retriever_trainer import TrainState
from evi_rag_tpu_torch.utils.device import resolve_device

EMB = 1024


def agent_batch(num_graphs: int, emb: int):
    """The profiled step's batch, on the CPU: the JAX script's generator
    settings and seeds, ``num_graphs`` agent samples at most."""
    ds = make_synthetic_dataset(num_samples=num_graphs, emb_dim=emb, max_nodes=48, seed=5)
    rng = np.random.default_rng(0)
    agents = []
    for s in ds.samples:
        a = build_agent_sample(
            sample_id=s.sample_id, question_id=s.question_id,
            heads=s.edge_index[0], tails=s.edge_index[1], relations=s.edge_relations,
            labels=s.edge_labels.astype(np.float32),
            scores=rng.normal(size=s.edge_index.shape[1]).astype(np.float32) + 2 * s.edge_labels,
            node_entity_ids=np.arange(1000, 1000 + s.num_nodes),
            node_embedding_ids=s.node_embedding_ids,
            start_entity_ids=1000 + s.topic_locals, answer_entity_ids=1000 + s.answer_locals,
            settings=AgentSettings(edge_top_k=200, score_mode="logits"),
        )
        if a is not None:
            agents.append(a)
    agents = agents[:num_graphs]
    return collate_agent(agents, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                         question_emb=ds.question_emb, bucket=fixed_agent_bucket(agents, num_graphs))


def fresh_step(cfg: gt.GFlowNetConfig, bundle: dict[str, Any], dev: torch.device):
    """(modules, parameters, optimizer, state, step) of a GFlowNet built from
    ``cfg`` at seed 0, its draws seeded 1 (JAX's ``key(1)``)."""
    mods = gt.build_modules(cfg)
    params = gt.init_gflownet_params(cfg, mods, seed=0, device=dev)
    tx = gt.setup_optimizer(cfg.optimizer, flatten_tree(params))
    state = TrainState(params=params, opt_state=tx.init(flatten_tree(params)), step=0,
                       generator=torch.Generator(device=dev).manual_seed(1))
    return mods, params, tx, state, gt.make_gfn_train_step(mods, tx, cfg, bundle)


def _build(num_graphs: int = 16, dropout: float = 0.1, remat: bool | str = False, *, emb: int = EMB,
           device: str | torch.device | None = None):
    """The JAX script's GFlowNet setup: (cfg, modules, bundle, batch,
    params, optimizer, state, step), the batch on the device.  ``emb`` is
    the embedding and hidden width (1024, as in JAX; smaller only in tests)."""
    dev = resolve_device(device)
    batch = agent_batch(num_graphs, emb)
    retr = Retriever(emb_dim=emb, hidden_dim=emb, dropout_p=0.0)
    init_parameters(retr, torch.Generator().manual_seed(0))
    bundle = gt.bundle_on(export_retriever_features(params_to_numpy(retr), retr.parity_meta()), dev)
    cfg = gt.GFlowNetConfig(
        hidden_dim=emb, max_steps=3, num_train_rollouts=4, bc_weight=0.5,
        total_steps=100, dropout=dropout, remat_policy=remat,
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-4),
    )
    mods, params, tx, state, step = fresh_step(cfg, bundle, dev)
    return cfg, mods, bundle, batch_to(batch, dev), params, tx, state, step


def _timeit(fn: Callable[[], Any], dev: torch.device, *, iters: int) -> float:
    """One warm call, then the best of 3 windows of ``iters`` calls, in ms
    per call: CUDA events on the card, the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = (time.perf_counter() - t0) * 1e3
        best = min(best, ms / iters)
    return best


STS_VARIANTS = (
    ("sts", dict(sample_then_score=True)),
    ("sts_bf16", dict(sample_then_score=True, compute_dtype="bfloat16")),
    ("sts_remat", dict(sample_then_score=True, remat_policy=True)),
    ("sts_remat_bf16", dict(sample_then_score=True, remat_policy=True, compute_dtype="bfloat16")),
)


def profile(*, graphs: int = 16, dropout: float = 0.1, remat: bool = False, iters: int = 5,
            emb: int = EMB, trace: str | None = None, device: str | torch.device | None = None) -> dict[str, float]:
    """The stage breakdown (ms by stage; printed as the JAX script prints it)."""
    from evi_rag_tpu_torch.models.gflownet.actor import rollout
    from evi_rag_tpu_torch.models.gflownet.embedder import apply_score_bonus, embed_agent_batch_frozen

    dev = resolve_device(device)
    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    cfg, mods, bundle, batch, params, tx, state, step = _build(graphs, dropout, remat, emb=emb, device=dev)
    g, e, n = batch.graph.num_graphs, batch.graph.num_edges, batch.graph.num_nodes
    print(f"batch: G={g} N={n} E={e} H={cfg.hidden_dim} R={cfg.num_train_rollouts} T={cfg.max_steps + 1}")
    time_it = lambda fn: _timeit(fn, dev, iters=iters)  # noqa: E731

    fe = embed_agent_batch_frozen(bundle, batch)
    ms = {"frozen embed": time_it(lambda: embed_agent_batch_frozen(bundle, batch))}
    gen = torch.Generator(device=dev).manual_seed(3)

    def fwd_rollouts():
        return gt.rollout_losses(mods, bundle, batch, cfg, num_rollouts=cfg.num_train_rollouts, bc_weight=0.5,
                                 temperature=cfg.policy_temperature, train=True, frozen_embed=fe,
                                 generator=gen)[0]

    with torch.no_grad():
        ms["rollouts + loss fwd"] = time_it(fwd_rollouts)

    def fwd_bwd():
        mods.zero_grad(set_to_none=True)
        fwd_rollouts().backward()

    ms["fwd+bwd (grad)"] = time_it(fwd_bwd)
    grads = {gt.gflownet_path(name): p.grad if p.grad is not None else torch.zeros_like(p)
             for name, p in mods.named_parameters()}
    flat = flatten_tree(params)

    def opt_apply():
        updates, _ = tx.update(grads, state.opt_state, flat)
        return {k: flat[k] + u for k, u in updates.items()}

    ms["optimizer apply"] = time_it(opt_apply)
    esp = {"kernel": mods.edge_score_proj.kernel, "bias": mods.edge_score_proj.bias}
    with torch.no_grad():
        embed_full = apply_score_bonus(fe, batch, esp)
        ms["1 rollout fwd"] = time_it(lambda: rollout(
            policy=mods.policy, state_encoder=mods.state_encoder, batch=batch, embed=embed_full,
            config=cfg.actor, train=True, generator=gen)["log_pf"])
    ms["full step (cached embed)"] = time_it(lambda: step(state, batch, fe))
    ms["full step (embed inline)"] = time_it(lambda: step(state, batch))
    for label, over in STS_VARIANTS:
        _, _, _, st_v, step_v = fresh_step(dataclasses.replace(cfg, **over), bundle, dev)
        ms[f"full step ({label})"] = time_it(lambda: step_v(st_v, batch, fe))

    print(f"frozen embed            : {ms['frozen embed']:8.3f} ms")
    print(f"1 rollout fwd (scan)    : {ms['1 rollout fwd']:8.3f} ms")
    print(f"{cfg.num_train_rollouts} rollouts + loss fwd  : {ms['rollouts + loss fwd']:8.3f} ms")
    print(f"fwd+bwd (grad)          : {ms['fwd+bwd (grad)']:8.3f} ms")
    print(f"optimizer apply         : {ms['optimizer apply']:8.3f} ms")
    for label in ("cached embed", "embed inline"):
        t = ms[f"full step ({label})"]
        print(f"FULL step ({label}): {t:8.3f} ms  -> {g / t * 1e3:7.1f} graphs/s")
    for label, _ in STS_VARIANTS:
        t = ms[f"full step ({label})"]
        print(f"FULL step ({label:11s}): {t:8.3f} ms  -> {g / t * 1e3:7.1f} graphs/s")
    print(f"  bwd-only estimate     : {ms['fwd+bwd (grad)'] - ms['rollouts + loss fwd']:8.3f} ms")
    print(f"  non-loss overhead     : "
          f"{ms['full step (cached embed)'] - ms['fwd+bwd (grad)'] - ms['optimizer apply']:8.3f} ms")

    if trace:
        from evi_rag_tpu_torch.utils.profiling import trace as profiler_trace

        with profiler_trace(trace):
            for _ in range(3):
                state, _ = step(state, batch, fe)
        print(f"trace written to {trace}/trace.json")
    return ms


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None, help="torch.profiler trace output dir")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--graphs", type=int, default=16)
    ap.add_argument("--dropout", type=float, default=0.1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None, help="cpu to run off the card (default: the card)")
    a = ap.parse_args(argv)
    profile(graphs=a.graphs, dropout=a.dropout, remat=a.remat, iters=a.iters, trace=a.trace, device=a.device)


if __name__ == "__main__":
    main()
