"""Shared inputs of the ``test_torch_gflownet_*`` files: agent samples built
from the synthetic generator (the same numpy code in both packages),
collated by each package, a JAX retriever feature bundle, both packages'
GFlowNet configs and parameters, and JAX's random draws replayed into the
port's draw layout."""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn

from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.data.g_agent import AgentSettings, build_agent_sample
from evi_rag_tpu.data.synthetic import make_synthetic_dataset
from evi_rag_tpu.models.batches import RetrieverBatch
from evi_rag_tpu.models.gflownet.policy import GFlowNetEdgePolicy as JPolicy
from evi_rag_tpu.models.gflownet.reward import RewardConfig as JReward
from evi_rag_tpu.models.retriever import Retriever
from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu.train.checkpoint import export_retriever_features
from evi_rag_tpu.train.optim import OptimizerConfig as JOpt
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch.models.gflownet.reward import RewardConfig as TReward
from evi_rag_tpu_torch.train import gflownet_trainer as tgt
from evi_rag_tpu_torch.train.optim import OptimizerConfig as TOpt

EMB = 16
F32 = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def agent_setup(seed=5, num_samples=8, emb=EMB, max_nodes=12, count=4, edge_top_k=20, dummy=False):
    """(JAX batch, port batch, samples, dataset, numpy bundle, JAX bundle,
    port bundle) of ``count`` agent samples with random retriever scores."""
    ds = make_synthetic_dataset(num_samples=num_samples, emb_dim=emb, max_nodes=max_nodes, seed=seed)
    rng = np.random.default_rng(seed)
    samples = []
    for s in ds.samples:
        a = build_agent_sample(
            sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0], tails=s.edge_index[1],
            relations=s.edge_relations, labels=s.edge_labels.astype(np.float32),
            scores=(rng.normal(size=s.edge_index.shape[1]) + 2.0 * s.edge_labels).astype(np.float32),
            node_entity_ids=np.arange(1000, 1000 + s.num_nodes), node_embedding_ids=s.node_embedding_ids,
            start_entity_ids=1000 + s.topic_locals, answer_entity_ids=1000 + s.answer_locals,
            settings=AgentSettings(edge_top_k=edge_top_k, max_hops=3, score_mode="logits"))
        if a is not None:
            samples.append(a)
    samples = samples[:count]
    assert len(samples) == count
    if dummy:
        samples[0] = dataclasses.replace(samples[0], is_dummy_agent=True, is_answer_reachable=False,
                                         answer_node_locals=np.empty(0, np.int64))
    bucket = jfeed.fixed_agent_bucket(samples, count)
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb)
    jb = jfeed.collate_agent(samples, bucket=bucket, **kw)
    tb = tfeed.collate_agent(samples, bucket=tfeed.Bucket(**dataclasses.asdict(bucket)), **kw)

    retr = Retriever(emb_dim=emb, hidden_dim=emb, dropout_p=0.0)
    start = jb.node_is_start.astype(jnp.float32)
    rb = RetrieverBatch(graph=jb.graph, node_emb=jb.node_emb, node_is_nontext=jb.node_is_nontext,
                        edge_emb=jb.edge_emb, question_emb=jb.question_emb,
                        topic_one_hot=jnp.stack([start, 1 - start], axis=-1), edge_labels=jb.edge_labels,
                        node_is_q=jb.node_is_start, node_is_a=jb.node_is_answer)
    rparams = jax.tree.map(np.asarray, jax.jit(retr.init)(jax.random.key(0), rb))
    # Non-trivial biases and LayerNorm affines, so that no term vanishes.
    prng = np.random.default_rng(seed + 1)
    rparams = jax.tree.map(lambda x: (x + 0.1 * prng.normal(size=x.shape)).astype(np.float32), rparams)
    bundle_np = export_retriever_features(rparams["params"], retr.parity_meta())
    jbundle = jax.tree.map(jnp.asarray, bundle_np)
    tbundle = tgt.bundle_on(bundle_np, torch.device("cpu"))
    return types.SimpleNamespace(jb=jb, tb=tb, samples=samples, ds=ds, bucket=bucket, bundle_np=bundle_np,
                                 jbundle=jbundle, tbundle=tbundle)


def configs(**kw):
    """(JAX config, port config) with the same fields."""
    base = dict(hidden_dim=EMB, max_steps=2, stop_on_answer=True, num_train_rollouts=2, bc_weight=0.5,
                total_steps=50, eval_rollout_prefixes=(1, 2, 4), dropout=0.0)
    base.update(kw)
    opt = dict(name="adamw", learning_rate=1e-4, grad_clip_norm=1.0)
    reward = base.pop("reward", {})
    return (jgt.GFlowNetConfig(optimizer=JOpt(**opt), reward=JReward(**reward), **base),
            tgt.GFlowNetConfig(optimizer=TOpt(**opt), reward=TReward(**reward), **base))


def perturbed_params(jcfg, jmods, s, seed=0, scale=0.3):
    """JAX-initialised GFlowNet parameters (numpy) with noise on every leaf,
    so that the zero-initialised heads score edges apart."""
    params = jax.tree.map(np.asarray, jgt.init_gflownet_params(jcfg, jmods, s.jbundle, s.jb, seed=seed))
    rng = np.random.default_rng(seed + 7)
    return jax.tree.map(lambda x: (x + scale * rng.normal(size=x.shape)).astype(np.float32), params)


def port_modules(tcfg, params):
    mods = tgt.build_modules(tcfg)
    tgt.load_gflownet_params(mods, params)
    return mods


def jax_uniforms(key, steps, num_edges, num_graphs):
    """The rollout's Gumbel uniforms as ``actor.rollout`` draws them."""
    keys = jax.random.split(key, steps)
    u = lambda k, n: np.asarray(jax.random.uniform(k, (n,), minval=1e-10, maxval=1.0 - 1e-10))  # noqa: E731
    return (np.stack([u(k, num_edges) for k in keys]),
            np.stack([u(jax.random.fold_in(k, 1), num_graphs) for k in keys]))


def jax_dropout_masks(policy_params, key, steps, num_edges, hidden, dropout):
    """The two dropout keep masks ``precompute_steps`` draws from the
    rollout key (recorded through ``nn.intercept_methods``)."""
    recorded = []

    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, nn.Dropout) and context.method_name == "__call__":
            recorded.append(np.asarray(out) != 0)
        return out

    ones = jnp.ones((num_edges, hidden))
    with nn.intercept_methods(interceptor):
        JPolicy(hidden_dim=hidden, dropout=dropout).apply(
            policy_params, ones, steps, edge_base=ones, train=True, method=JPolicy.precompute_steps,
            rngs={"dropout": jax.random.fold_in(key, 987)})
    assert len(recorded) == 2
    return recorded


def rollout_draws(keys, jb, steps, hidden, *, dropout=0.0, policy_params=None, sample=True):
    """JAX's draws of the rollouts of ``keys`` in the port's layout: the
    rollouts' edge and graph axes side by side (``replicate_agent_batch``)."""
    e, g = jb.graph.num_edges, jb.graph.num_graphs
    parts = {"uniform_edge": [], "uniform_stop": [], "keep_edge": [], "keep_head": []}
    for key in keys:
        if sample:
            ue, us = jax_uniforms(key, steps, e, g)
            parts["uniform_edge"].append(ue)
            parts["uniform_stop"].append(us)
        if dropout > 0.0:
            ke, kh = jax_dropout_masks(policy_params, key, steps, e, hidden, dropout)
            parts["keep_edge"].append(ke)
            parts["keep_head"].append(kh)
    return {k: torch.from_numpy(np.concatenate(v, axis=1)) for k, v in parts.items() if v}


_KEY_CHAINS: dict = {}


def jax_step_keys(stream_seed, step, rollouts):
    """The rollout keys of JAX's GFlowNet trainer at ``step`` (0-based) of
    the stream ``key(stream_seed)`` (``fit_gflownet``'s ``key(seed + 1)``):
    the state's key split once a step, then ``split(sub, rollouts)``."""
    chain = _KEY_CHAINS.setdefault(stream_seed, [jax.random.key(stream_seed)])
    while len(chain) <= step:
        chain.append(jax.random.split(chain[-1])[0])
    return list(jax.random.split(jax.random.split(chain[step])[1], rollouts))


def jax_eval_keys(eval_seed, batch, rollouts):
    """The rollout keys of batch ``batch`` of a JAX GFlowNet eval from
    ``key(eval_seed)`` (``evaluate_gflownet``'s ``key(1000 + epoch)``,
    ``eval_gflownet``'s ``key(7)``): ``split(fold_in(key, batch), rollouts)``."""
    return list(jax.random.split(jax.random.fold_in(jax.random.key(eval_seed), batch), rollouts))


def replay_jax_draws(policy_params, graphs, log=None):
    """A stand-in for the port's ``actor.make_rollout_draws`` that hands out
    JAX's draws: for the ``n``-th draw of a generator seeded ``s``, the
    keys of JAX's trainer at step ``n`` of ``key(s)`` in train mode
    (``jax_step_keys``), of batch ``n`` of an eval from ``key(s)`` otherwise
    (``jax_eval_keys``), as ``rollout_draws`` lays them out.  So a port that
    seeds or advances its generators otherwise than JAX keys its draws gets
    other draws.  ``policy_params`` (JAX's) give the dropout recorder its
    shapes; ``graphs`` is a batch's bucket (its rollout count divides the
    replicated batch); ``log`` collects (seed, n, train) of every call."""
    counts, kept = {}, []  # ``kept`` holds every generator alive, so that ids stay unique

    def make_rollout_draws(config, batch, *, hidden_dim, dropout, train, sample, generator=None):
        kept.append(generator)
        n = counts.get(id(generator), 0)
        counts[id(generator)] = n + 1
        s = generator.initial_seed()
        if log is not None:
            log.append((s, n, train))
        gb = batch.graph
        r = gb.num_graphs // graphs
        keys = jax_step_keys(s, n, r) if train else jax_eval_keys(s, n, r)
        shape = types.SimpleNamespace(graph=types.SimpleNamespace(num_edges=gb.num_edges // r,
                                                                  num_graphs=gb.num_graphs // r))
        draws = rollout_draws(keys, shape, config.num_steps, hidden_dim, dropout=dropout if train else 0.0,
                              policy_params=policy_params, sample=sample)
        return {k: v.to(gb.edge_batch.device) for k, v in draws.items()}
    return make_rollout_draws


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def to_np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def recording_train_step(lib, rows: list):
    """``lib.make_gfn_train_step`` (either package's trainer module) whose
    steps append their (loss, bc_weight) to ``rows``; patch it in where
    ``fit_gflownet`` looks it up."""
    real = lib.make_gfn_train_step

    def make_gfn_train_step(*a, **kw):
        step = real(*a, **kw)

        def recorded(state, *args, **kwargs):
            state, out = step(state, *args, **kwargs)
            rows.append((float(out["loss"]), float(out["bc_weight"])))
            return state, out
        return recorded
    return make_gfn_train_step
