"""Port vs JAX: the GFlowNet train and eval steps, init, ``fit_gflownet``.

* One train step (R = 2 rollouts, BC on) from the same parameters with
  JAX's Gumbel uniforms, first with dropout 0, then with JAX's recorded
  dropout masks: the loss within rtol 1e-4, every gradient leaf within atol
  1e-5 + rtol 1e-3, the parameters after one AdamW step within 1e-6.
* The eval step's metrics and rollouts: equal (greedy, and sampled with
  JAX's draws).
* ``init_gflownet_params``: flax's distributions (moments), zero-init heads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu.train.checkpoint import params_digest as jdigest
from evi_rag_tpu.train.optim import setup_optimizer as jsetup
from evi_rag_tpu.train.retriever_trainer import TrainState as JState
from evi_rag_tpu_torch.models.batches import replicate_agent_batch
from evi_rag_tpu_torch.models.gflownet.actor import make_rollout_draws
from evi_rag_tpu_torch.train import gflownet_trainer as tgt
from evi_rag_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint
from evi_rag_tpu_torch.train.optim import setup_optimizer as tsetup
from evi_rag_tpu_torch.train.retriever_trainer import TrainState as TState

from _torch_gfn_common import (
    EMB, GRAD_TOL, agent_setup, configs, flat, perturbed_params, port_modules, rollout_draws, to_np)


@pytest.fixture(scope="module")
def setup():
    return agent_setup()


def _port_state(tm, tcfg):
    params = tgt.gflownet_params_tree(tm)
    tx = tsetup(tcfg.optimizer, flatten_tree(params))
    return TState(params=params, opt_state=tx.init(flatten_tree(params)), step=0, generator=None), tx


@pytest.mark.parametrize("dropout", [0.0, 0.2])
def test_train_step_matches_jax(setup, dropout):
    s = setup
    jcfg, tcfg = configs(dropout=dropout, max_steps=3, stop_on_answer=False)
    jm = jgt.build_modules(jcfg)
    params = perturbed_params(jcfg, jm, s, seed=1)
    jp = jax.tree.map(jnp.asarray, params)
    tx = jsetup(jcfg.optimizer, jp)
    state = JState(params=jp, opt_state=jax.jit(tx.init)(jp), step=jnp.zeros((), jnp.int32), rng=jax.random.key(1))
    _, sub = jax.random.split(state.rng)
    keys = jax.random.split(sub, jcfg.num_train_rollouts)
    bc_w = jgt.bc_weight_schedule(0, bc_weight=jcfg.bc_weight, hold_steps=int(round(50 * jcfg.bc_hold_ratio)),
                                  decay_steps=int(round(50 * jcfg.bc_decay_ratio)))

    def loss_fn(p):
        return jgt._rollout_losses(p, jm, s.jbundle, s.jb, keys, jcfg, bc_weight=bc_w,
                                   temperature=jcfg.policy_temperature, train=True)

    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    jnew, jout = jgt.make_gfn_train_step(jm, tx, jcfg, s.jbundle)(state, s.jb)
    jgrads = flat(jgrads)

    tm = port_modules(tcfg, params)
    tstate, ttx = _port_state(tm, tcfg)
    draws = rollout_draws(list(keys), s.jb, jcfg.actor.num_steps, EMB, dropout=dropout, policy_params=jp["policy"])
    tnew, tout = tgt.make_gfn_train_step(tm, ttx, tcfg, s.tbundle)(tstate, s.tb, draws=draws)

    np.testing.assert_allclose(tout["loss"].item(), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(tout["loss"].item(), float(jout["loss"]), rtol=1e-4)
    for name in ("subtb_loss", "bc_loss", "answer_hit", "length_mean", "semantic", "log_reward"):
        np.testing.assert_allclose(tout[name].item(), float(jmetrics[name]), rtol=1e-4, atol=1e-5, err_msg=name)
    assert float(jmetrics["bc_loss"]) > 0
    tgrads = {tgt.gflownet_path(n): to_np(p.grad) for n, p in tm.named_parameters()}
    assert tgrads.keys() == jgrads.keys()
    for path, g in jgrads.items():
        np.testing.assert_allclose(tgrads[path], g, err_msg=path, **GRAD_TOL)
    tflat = {k: to_np(v) for k, v in flatten_tree(tnew.params).items()}
    for path, v in flat(jnew.params).items():
        np.testing.assert_allclose(tflat[path], v, rtol=0, atol=1e-6, err_msg=path)
    assert tnew.step == 1 and float(tout["bc_weight"]) == pytest.approx(float(jout["bc_weight"]))


@pytest.mark.parametrize("greedy", [True, False])
def test_eval_step_matches_jax(setup, greedy):
    s = setup
    jcfg, tcfg = configs(max_steps=3, eval_temperature=0.0 if greedy else 1.0)
    jm = jgt.build_modules(jcfg)
    params = perturbed_params(jcfg, jm, s, seed=2)
    r, key = 4, jax.random.key(5)
    want = jgt.make_gfn_eval_step(jm, jcfg, s.jbundle, num_rollouts=r, collect_rollouts=True)(
        jax.tree.map(jnp.asarray, params), s.jb, key)
    tm = tgt.build_modules(tcfg)
    draws = None if greedy else rollout_draws(list(jax.random.split(key, r)), s.jb, 4, EMB)
    got = tgt.make_gfn_eval_step(tm, tcfg, s.tbundle, num_rollouts=r, collect_rollouts=True)(params, s.tb,
                                                                                            draws=draws)
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.startswith(("answer_hit@", "answer_hit_ref@", "graph_valid", "rollout_")):
            np.testing.assert_array_equal(to_np(got[k]), np.asarray(v).astype(to_np(got[k]).dtype), err_msg=k)
        else:
            np.testing.assert_allclose(to_np(got[k]), np.asarray(v), rtol=1e-4, atol=1e-5, err_msg=k)
    jagg = jgt.evaluate_gflownet_results([want])
    tagg = tgt.evaluate_gflownet_results([got])
    assert tagg.keys() == jagg.keys()
    for k, v in jagg.items():
        assert tagg[k] == pytest.approx(v, rel=1e-4, abs=1e-5), k


def test_init_moments_match_flax(setup):
    """Kernels lecun_normal (std sqrt(1 / fan_in), cut at 2 std), biases
    zero, LayerNorm scales one; the policy's and estimator's last layers,
    the step embeddings and the score bonus zero."""
    s = setup
    jcfg, tcfg = configs(hidden_dim=EMB, use_state_dde=True)
    jparams = flat(jax.tree.map(np.asarray, jgt.init_gflownet_params(jcfg, jgt.build_modules(jcfg), s.jbundle,
                                                                      s.jb, seed=3)))
    tm = tgt.build_modules(tcfg)
    tparams = {k: to_np(v) for k, v in flatten_tree(tgt.init_gflownet_params(tcfg, tm, seed=3,
                                                                             device="cpu")).items()}
    assert tparams.keys() == jparams.keys()
    for k, v in jparams.items():
        assert tparams[k].shape == v.shape, k
        if not k.endswith("kernel") or not v.any():
            np.testing.assert_array_equal(tparams[k], v, err_msg=k)

    def moments(tree):
        z = np.concatenate([v.ravel() / np.sqrt(1.0 / v.shape[0]) for k, v in tree.items()
                            if k.endswith("kernel") and v.any()])
        return z.mean(), z.std(), np.abs(z).max()

    (jmean, jstd, jmax), (tmean, tstd, tmax) = moments(jparams), moments(tparams)
    assert abs(tmean) < 0.05 and abs(tstd - jstd) < 0.05 * jstd and abs(tstd - 1.0) < 0.05
    assert tmax <= 2.0 / 0.87962566103423978 + 1e-6 and jmax <= 2.0 / 0.87962566103423978 + 1e-6


def test_converter_round_trip(setup):
    s = setup
    jcfg, tcfg = configs()
    params = perturbed_params(jcfg, jgt.build_modules(jcfg), s, seed=4)
    tm = port_modules(tcfg, params)
    back = tgt.gflownet_params_to_numpy(tm)
    assert jdigest(back) == jdigest(params)
    bad = jax.tree.map(lambda x: x, params)
    del bad["policy"]["params"]["attn_q"]
    with pytest.raises(KeyError, match="attn_q"):
        tgt.load_gflownet_params(tm, bad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_steps_reduce_loss(setup, dtype):
    """Six steps on one fixed batch lower the loss (the JAX test's bar),
    with one fixed set of rollout draws."""
    s = setup
    _, tcfg = configs(compute_dtype=dtype)
    tcfg = dataclasses.replace(tcfg, optimizer=dataclasses.replace(tcfg.optimizer, learning_rate=1e-3))
    tm = tgt.build_modules(tcfg)
    tgt.init_gflownet_params(tcfg, tm, seed=0, device="cpu")
    state, tx = _port_state(tm, tcfg)
    state = dataclasses.replace(state, generator=torch.Generator().manual_seed(1))
    step = tgt.make_gfn_train_step(tm, tx, tcfg, s.tbundle)
    draws = make_rollout_draws(tcfg.actor, replicate_agent_batch(s.tb, tcfg.num_train_rollouts), hidden_dim=EMB,
                               dropout=tcfg.dropout, train=True, sample=True, generator=torch.Generator().manual_seed(0))
    losses = []
    for _ in range(6):
        state, m = step(state, s.tb, draws=draws)
        losses.append(m["loss"].item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_dummy_graphs_keep_training_finite():
    s = agent_setup(dummy=True)
    _, tcfg = configs(dropout=0.1)
    tm = tgt.build_modules(tcfg)
    tgt.init_gflownet_params(tcfg, tm, seed=0, device="cpu")
    state, tx = _port_state(tm, tcfg)
    state = dataclasses.replace(state, generator=torch.Generator().manual_seed(5))
    state, m = tgt.make_gfn_train_step(tm, tx, tcfg, s.tbundle)(state, s.tb)
    assert np.isfinite(m["loss"].item())
    assert all(bool(torch.isfinite(v).all()) for v in flatten_tree(state.params).values())


@pytest.mark.parametrize("cache", [False, True])
def test_fit_gflownet_on_cpu(setup, cache, tmp_path):
    s = setup
    _, tcfg = configs(max_epochs=2, cache_frozen_embed=cache)
    best, info = tgt.fit_gflownet(tcfg, s.bundle_np, lambda epoch: [s.tb], lambda: [s.tb], seed=0,
                                  eval_rollouts=2, device="cpu")
    assert len(info["history"]) == 2 and np.isfinite(info["best_score"])
    assert flatten_tree(best).keys() == flatten_tree(info["final_state"].params).keys()
    from evi_rag_tpu_torch.cli import save_gflownet_checkpoint

    digest = save_gflownet_checkpoint(tmp_path / "best", best, s.bundle_np, {"parity_meta": {}}, info["best_score"])
    tree, meta = load_checkpoint(tmp_path / "best")
    assert meta["params_sha256"] == digest == jdigest(jax.tree.map(np.asarray, tree["params"]))
    assert meta["retriever_meta"] == {"parity_meta": {}}
