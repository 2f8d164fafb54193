"""Port vs JAX: the sample-then-score rollout and the remat policies.

The cases of ``tests/test_gflownet_sts.py``, each held to JAX's
sample-then-score rollout under JAX's draws (``rollout_draws``: the same
``split(rng, T)`` Gumbel uniforms and ``fold_in(rng, 987)`` dropout masks
serve both JAX paths), at that file's tolerances:

* sampled and greedy rollouts: actions, selected edges and directions
  equal; log-probs, state embeddings and BC statistics rtol 2e-4 / atol
  2e-4 (and equal actions to the port's canonical loop);
* forced replay (the sampling pass never calls the policy);
* gradients of a loss over the rollout: rtol 5e-3 / atol 5e-4;
* train mode with JAX's dropout masks; bf16 finite;
* one train step's loss: rtol 1e-3 / atol 1e-4;
* ``remat_policy`` True and ``"dots"``, on the two-pass rollout and on the
  canonical loop: the forward bit for bit, gradients rtol 1e-4 / atol 1e-6;
  the "dots" checkpoint saves exactly the matmuls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.models.gflownet import actor as jactor
from evi_rag_tpu.models.gflownet import embedder as jemb
from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu.train.optim import setup_optimizer as jsetup
from evi_rag_tpu.train.retriever_trainer import TrainState as JState
from evi_rag_tpu_torch.models.gflownet import actor as tactor
from evi_rag_tpu_torch.models.gflownet import embedder as temb
from evi_rag_tpu_torch.train import gflownet_trainer as tgt
from evi_rag_tpu_torch.train.checkpoint import flatten_tree
from evi_rag_tpu_torch.train.optim import setup_optimizer as tsetup
from evi_rag_tpu_torch.train.retriever_trainer import TrainState as TState

from _torch_gfn_common import EMB, agent_setup, configs, flat, perturbed_params, port_modules, rollout_draws, to_np

STS_TOL = dict(rtol=2e-4, atol=2e-4)
STS_GRAD_TOL = dict(rtol=5e-3, atol=5e-4)
REMAT_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
T = 4  # max_steps 3


@pytest.fixture(scope="module")
def setup():
    return agent_setup()


def _prep(s, *, dropout=0.0, compute_dtype="float32", seed=2):
    jcfg, tcfg = configs(max_steps=3, stop_on_answer=False, dropout=dropout, compute_dtype=compute_dtype)
    params = perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=seed)
    return jcfg, tcfg, params


def _dag(s):
    return (s.jb.edge_labels > 0.5) & s.jb.graph.edge_mask


def _jax_rollout(s, jcfg, params, key, *, greedy=False, train=False, forced=None, sts=True):
    jm = jgt.build_modules(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    embed = jemb.embed_agent_batch(s.jbundle, s.jb, edge_score_proj=jp["edge_score_proj"])
    cfg = dataclasses.replace(jcfg.actor, sample_then_score=sts)
    return jax.jit(lambda k: jactor.rollout(
        policy=jm.policy, state_encoder=jm.state_encoder, policy_params=jp["policy"],
        encoder_params=jp["state_encoder"], batch=s.jb, embed=embed, rng=k, config=cfg, greedy=greedy,
        forced_actions=forced, dag_edge_mask=_dag(s), train=train))(key)


def _port_rollout(s, tcfg, params, key, *, greedy=False, train=False, forced=None, sts=True, remat=False, tm=None):
    """(rollout, modules) of the port under JAX's draws of ``key``."""
    tm = tm if tm is not None else port_modules(tcfg, params)
    embed = temb.embed_agent_batch(s.tbundle, s.tb, edge_score_proj={"kernel": tm.edge_score_proj.kernel,
                                                                      "bias": tm.edge_score_proj.bias})
    sample = forced is None and not greedy
    draws = rollout_draws([key], s.jb, T, EMB, dropout=tcfg.dropout if train else 0.0,
                          policy_params=jax.tree.map(jnp.asarray, params["policy"]), sample=sample)
    cfg = dataclasses.replace(tcfg.actor, sample_then_score=sts, remat_policy=remat)
    ro = tactor.rollout(policy=tm.policy, state_encoder=tm.state_encoder, batch=s.tb, embed=embed, config=cfg,
                        greedy=greedy, forced_actions=None if forced is None else torch.from_numpy(np.asarray(forced)),
                        dag_edge_mask=torch.from_numpy(np.asarray(_dag(s))), train=train, draws=draws)
    return ro, tm


EXACT = ("actions_seq", "selected_mask", "directions_seq")
CLOSE = ("log_pf", "log_pf_steps", "state_emb_seq", "bc_loss_per_graph", "bc_steps_per_graph", "length",
         "reach_success")


def _assert_matches(want, got, names=CLOSE, tol=STS_TOL):
    for k in EXACT:
        np.testing.assert_array_equal(to_np(got[k]), np.asarray(want[k]).astype(to_np(got[k]).dtype), err_msg=k)
    for k in names:
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), err_msg=k, **tol)


@pytest.mark.parametrize("greedy", [False, True])
def test_sts_matches_jax_sts_and_the_canonical_loop(setup, greedy):
    s = setup
    jcfg, tcfg, params = _prep(s)
    if greedy:  # a lower stop bias, so that the greedy policy takes edges
        params["policy"]["params"]["stop_head_1"]["bias"] = np.full((1,), -3.0, np.float32)
    for i in range(2):
        key = jax.random.key(3 + i)
        want = _jax_rollout(s, jcfg, params, key, greedy=greedy)
        with torch.no_grad():
            got, tm = _port_rollout(s, tcfg, params, key, greedy=greedy)
            canon, _ = _port_rollout(s, tcfg, params, key, greedy=greedy, sts=False, tm=tm)
        _assert_matches(want, got)
        _assert_matches({k: to_np(v) for k, v in canon.items()}, got)
    assert (to_np(got["actions_seq"]) >= 0).any() and float(to_np(got["bc_steps_per_graph"]).sum()) > 0


def test_sts_forced_replay_matches(setup):
    s = setup
    jcfg, tcfg, params = _prep(s)
    free = _jax_rollout(s, jcfg, params, jax.random.key(11))
    forced = free["actions_seq"]
    want = _jax_rollout(s, jcfg, params, jax.random.key(12), forced=forced)
    with torch.no_grad():
        got, _ = _port_rollout(s, tcfg, params, jax.random.key(12), forced=forced)
    _assert_matches(want, got, names=("log_pf_steps", "state_emb_seq", "bc_loss_per_graph"))
    np.testing.assert_array_equal(to_np(got["actions_seq"]), np.asarray(forced))
    np.testing.assert_allclose(to_np(got["log_pf"]), np.asarray(free["log_pf"]), **STS_TOL)


def _jax_grads(s, jcfg, params, key, *, sts=True, train=False):
    jm = jgt.build_modules(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    embed = jemb.embed_agent_batch(s.jbundle, s.jb, edge_score_proj=jp["edge_score_proj"])
    cfg = dataclasses.replace(jcfg.actor, sample_then_score=sts)

    def loss_fn(p):
        ro = jactor.rollout(policy=jm.policy, state_encoder=jm.state_encoder, policy_params=p["policy"],
                            encoder_params=p["state_encoder"], batch=s.jb, embed=embed, rng=key, config=cfg,
                            dag_edge_mask=_dag(s), train=train)
        return (jnp.sum(ro["log_pf_steps"] ** 2) + jnp.sum(ro["state_emb_seq"] ** 2)
                + jnp.sum(ro["bc_loss_per_graph"]))

    trainable = {k: jp[k] for k in ("policy", "state_encoder")}
    return flat(jax.jit(jax.grad(loss_fn))(trainable))


def _port_grads(s, tcfg, params, key, *, sts=True, train=False, remat=False):
    """(rollout, {flax path: gradient}) of the port's policy and state encoder."""
    ro, tm = _port_rollout(s, tcfg, params, key, sts=sts, train=train, remat=remat)
    loss = ro["log_pf_steps"].square().sum() + ro["state_emb_seq"].square().sum() + ro["bc_loss_per_graph"].sum()
    loss.backward()
    grads = {tgt.gflownet_path(n): to_np(p.grad) for n, p in tm.named_parameters()
             if n.startswith(("policy.", "state_encoder.")) and p.grad is not None}
    return ro, grads


def test_sts_gradient_parity(setup):
    s = setup
    jcfg, tcfg, params = _prep(s)
    key = jax.random.key(7)
    want = _jax_grads(s, jcfg, params, key)
    _, got = _port_grads(s, tcfg, params, key)
    _, canon = _port_grads(s, tcfg, params, key, sts=False)
    assert got.keys() == canon.keys() and got
    assert any(float(np.abs(g).max()) > 0 for g in want.values()), "degenerate test: zero grads"
    for path, g in got.items():
        np.testing.assert_allclose(g, want[path], err_msg=path, **STS_GRAD_TOL)
        np.testing.assert_allclose(g, canon[path], err_msg=path, **STS_GRAD_TOL)


def test_sts_train_dropout_parity(setup):
    s = setup
    jcfg, tcfg, params = _prep(s, dropout=0.3)
    key = jax.random.key(9)
    want = _jax_rollout(s, jcfg, params, key, train=True)
    with torch.no_grad():
        got, _ = _port_rollout(s, tcfg, params, key, train=True)
    _assert_matches(want, got, names=("log_pf_steps", "state_emb_seq"))
    assert np.isfinite(to_np(got["bc_loss_per_graph"])).all()


def test_sts_bf16_finite(setup):
    s = setup
    _, tcfg, params = _prep(s, compute_dtype="bfloat16")
    with torch.no_grad():
        ro, _ = _port_rollout(s, tcfg, params, jax.random.key(5))
    assert np.isfinite(to_np(ro["log_pf"])).all() and np.isfinite(to_np(ro["state_emb_seq"])).all()


def test_sts_train_step_matches_jax(setup):
    """One train step (2 rollouts, SubTB + BC) with sample-then-score: the
    loss within rtol 1e-3 / atol 1e-4 of JAX's sample-then-score step and of
    the port's canonical step on the same draws."""
    s = setup
    jcfg, tcfg, params = _prep(s)
    jcfg, tcfg = (dataclasses.replace(c, sample_then_score=True, bc_weight=0.3) for c in (jcfg, tcfg))
    jm = jgt.build_modules(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    tx = jsetup(jcfg.optimizer, jp)
    state = JState(params=jp, opt_state=jax.jit(tx.init)(jp), step=jnp.zeros((), jnp.int32), rng=jax.random.key(2))
    _, jout = jgt.make_gfn_train_step(jm, tx, jcfg, s.jbundle)(state, s.jb)
    _, sub = jax.random.split(state.rng)
    draws = rollout_draws(list(jax.random.split(sub, jcfg.num_train_rollouts)), s.jb, T, EMB)
    losses = {}
    for sts in (True, False):
        cfg = dataclasses.replace(tcfg, sample_then_score=sts)
        tm = port_modules(cfg, params)
        p = tgt.gflownet_params_tree(tm)
        ttx = tsetup(cfg.optimizer, flatten_tree(p))
        tstate = TState(params=p, opt_state=ttx.init(flatten_tree(p)), step=0, generator=None)
        _, out = tgt.make_gfn_train_step(tm, ttx, cfg, s.tbundle)(tstate, s.tb, draws=draws)
        losses[sts] = out["loss"].item()
    assert np.isfinite(losses[True])
    np.testing.assert_allclose(losses[True], float(jout["loss"]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("sts", [True, False], ids=["sts", "canonical"])
@pytest.mark.parametrize("remat", [True, "dots"], ids=["full", "dots"])
def test_remat_keeps_the_forward_and_the_gradients(setup, remat, sts):
    """Under a checkpoint the forward is the same bit for bit (the dropout
    masks are arguments drawn outside it) and the gradients match the
    rollout without remat."""
    s = setup
    _, tcfg, params = _prep(s, dropout=0.3)
    key = jax.random.key(21)
    base_ro, base = _port_grads(s, tcfg, params, key, sts=sts, train=True)
    ro, got = _port_grads(s, tcfg, params, key, sts=sts, train=True, remat=remat)
    for k in ("actions_seq", "log_pf_steps", "state_emb_seq", "bc_loss_per_graph"):
        np.testing.assert_array_equal(to_np(ro[k]), to_np(base_ro[k]), err_msg=k)
    assert got.keys() == base.keys() and got
    for path, g in base.items():
        np.testing.assert_allclose(got[path], g, err_msg=path, **REMAT_GRAD_TOL)


def test_dots_policy_saves_the_matmuls(setup, monkeypatch):
    """The "dots" checkpoint of the score pass sees the policy's matmuls as
    ``aten.mm`` / ``aten.addmm`` (``@`` and ``einsum`` lower to them) and saves
    those, and only those."""
    s = setup
    _, tcfg, params = _prep(s)
    seen: dict[str, object] = {}
    policy = tactor.dots_policy

    def recording(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen[str(op)] = decision
        return decision

    monkeypatch.setattr(tactor, "dots_policy", recording)
    _port_grads(s, tcfg, params, jax.random.key(3), remat="dots")
    saved = {op for op, d in seen.items() if d == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE}
    assert "aten.mm.default" in saved
    assert saved <= {str(op) for op in tactor.DOT_OPS}
    assert len(seen) > len(saved)  # the elementwise ops are recomputed


def test_sts_vs_canonical_check_on_cpu():
    """``testing.sts_vs_canonical`` (the card's phase 8f check, here at H =
    16 on the CPU with dropout masks): no graph differs, every rollout
    output within ``STS_TOL``, the loss within ``STS_LOSS_TOL``; and
    ``gumbel_margin`` ranks the canonical loop's own choice first."""
    from evi_rag_tpu_torch import testing
    from evi_rag_tpu_torch.models.batches import replicate_agent_batch

    hidden = 16
    cfg = tgt.GFlowNetConfig(hidden_dim=hidden, max_steps=3, num_train_rollouts=2, bc_weight=0.5, dropout=0.1)
    batch = testing.agent_inputs(hidden, 4, seed=1)
    modules = tgt.build_modules(cfg)
    tgt.init_gflownet_params(cfg, modules, seed=0, device="cpu")
    noise = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for _, p in modules.named_parameters():
            p.add_(0.3 * torch.randn(p.shape, generator=noise))
    draws = tactor.make_rollout_draws(cfg.actor, replicate_agent_batch(batch, 2), hidden_dim=hidden, dropout=0.1,
                                      train=True, sample=True, generator=torch.Generator().manual_seed(5))
    res = testing.sts_vs_canonical(cfg, modules, tgt.bundle_on(testing.random_bundle(hidden), torch.device("cpu")),
                                   batch, draws)
    assert res["differing"] == [] and res["acting_steps"] > 0
    assert max(res["ratios"].values()) <= 1.0 and res["loss_ratio"] <= 1.0, res

    seen = {}

    def recording(**kw):
        seen["kw"], seen["ro"] = kw, tactor.rollout(**kw)
        return seen["ro"]

    from unittest import mock

    with mock.patch.object(tgt, "rollout", recording), torch.no_grad():
        tgt.rollout_losses(modules, tgt.bundle_on(testing.random_bundle(hidden), torch.device("cpu")), batch, cfg,
                           num_rollouts=2, bc_weight=0.5, temperature=1.0, train=True, draws=draws)
    acts = seen["ro"]["actions_seq"]
    margins = [testing.gumbel_margin(seen["kw"], acts, gi, 0) for gi in range(acts.shape[0])
               if bool(acts[gi, 0] >= 0)]
    assert margins and all(m > 0 for m, _ in margins)
