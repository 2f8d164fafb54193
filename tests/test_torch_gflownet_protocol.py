"""Port vs JAX: GFlowNet training under the protocol the WebQSP chain trains
with, step by step and across a whole ``fit_gflownet``.

The protocol is ``configs/gflownet/default.yaml`` under
``configs/experiment/webqsp_synth_hw.yaml``: SubTB plus DAG behaviour
cloning at weight 0.5, held for 0.2 and decayed over 0.6 of
``total_steps``; ``max_steps`` 3 with ``stop_on_answer``; policy dropout
0.1; 4 train rollouts; reward 1.0 / 1e-4 with the semantic and length
coefficients at 1; AdamW at 1e-4 with a global clip of 1.0; f32 (the
GFlowNet's ``compute_dtype``); eval over rollout prefixes (1, 10, 25) with
the 4 rollouts ``fit_gflownet`` evaluates with.  Only the width (the
geometry of ``_torch_gfn_common``), the data and the number of steps are
cut.

Both packages see JAX's own draws: the JAX trainer's key streams, in the
port's draw layout (``_torch_gfn_common.rollout_draws``):

* training: ``state.rng = key(seed + 1)``, one ``split`` a step, the
  ``num_train_rollouts`` keys of ``split(sub, R)``; each rollout's Gumbel
  uniforms from its key (edges) and ``fold_in(key, 1)`` (STOP) per step,
  and its dropout masks from ``fold_in(key, 987)`` (``precompute_policy``,
  the default, draws them once for all steps; ``fold_in(key, 2)`` is the
  per-step key of the path without it);
* eval: epoch ``e`` draws from ``key(1000 + e)``, batch ``i`` from
  ``split(fold_in(key(1000 + e), i), r)``.

The port's ``actor.make_rollout_draws`` is patched to hand out the draws of
the JAX key that matches the generator the port passes, by its seed and by
how many draws that generator has given (``replay_jax_draws``): the train
generator ``seed + 1`` gives step after step, each epoch's eval generator
``1000 + epoch`` batch after batch.  So a port that seeds or advances its
generators otherwise than JAX keys its draws gets other draws than JAX.

Cases:

* (a) One train step from one set of parameters (JAX's init with noise on
  every leaf, so that no gradient vanishes behind a zero head), at a step
  where BC is in its hold, one in its decay and one past it: the loss at
  rtol 1e-5, ``bc_weight`` exactly, every gradient leaf within atol 1e-5 +
  rtol 1e-3 (``tests/test_torch_gflownet_train.py``'s step bars).
* (b) ``fit_gflownet`` from JAX's init (``init_gflownet_params`` patched in
  the port to load it) on 12 train and 8 validation agent samples (one a
  dummy) in batches of 4: up to 4 epochs of 3 steps, ``total_steps`` 10 (BC
  held over steps 0-1, decayed over steps 2-7, 0 from step 8) and patience
  1, so that the hold ends in epoch 0, the decay in epoch 2, and patience
  stops the run after epoch 2, whose monitor ties epoch 0's (the best
  epoch).  Held: the loss and ``bc_weight`` of every step at rtol 1e-3,
  each epoch's validation metrics (``answer_hit``, ``answer_hit@k``,
  ``answer_hit_ref@k``) within one validation graph's share and the rest
  (the eval loss, reward, length) at rtol 1e-3, the draws each generator
  gave, the same epochs run, the same best score and best epoch, and the
  best parameters leaf by leaf within ``fit_param_tol``.
* (c) The same ``fit`` with ``cache_frozen_embed: true``, whose batches are
  fixed at epoch 0 and reordered by ``default_rng([seed, epoch])``.

**The drift bound.**  An AdamW update is ``lr * m / (sqrt(v) + eps)``, a
ratio that does not depend on the gradient's scale; a gradient known to
rtol 1e-3 moves it by at most ``2e-3 lr``, and the differences of the
steps add up: ``2e-3 * sum(lr_t)``, as
``tests/test_torch_train_fit.py::_fit_param_tol`` derives it (the
learning rate is constant here, so ``sum(lr_t) = steps * lr``).  From
JAX's init every leaf behind the zero-initialised heads has a gradient of
exactly 0 at step 0 in both packages, and AdamW moves it by 0.

Mutations, each made in a copy of the port: the BC schedule one step late
(``bc_weight_schedule(step - 1)``) fails (a) at the decay step and (b) /
(c) from step 3; the eval generator seeded 1000 once instead of ``1000 +
epoch`` each epoch fails (b) / (c) (epoch 1 draws the key of epoch 0's
third batch, and the monitor no longer stops the run after epoch 2); the
best epoch replaced on a tie (``>=``) fails (b) / (c) (epoch 2's tie
resets patience, so the port runs a fourth epoch); dropout unscaled (the
keep masks applied without ``1 / (1 - p)``) fails every case.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.data.g_agent import AgentSettings, build_agent_sample
from evi_rag_tpu.data.synthetic import make_synthetic_dataset
from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch.models.gflownet import actor as tactor
from evi_rag_tpu_torch.train import gflownet_trainer as tgt
from evi_rag_tpu_torch.train.checkpoint import flatten_tree
from evi_rag_tpu_torch.train.optim import setup_optimizer as tsetup
from evi_rag_tpu_torch.train.retriever_trainer import TrainState as TState

from _torch_gfn_common import (
    EMB, GRAD_TOL, agent_setup, configs, flat, jax_step_keys, perturbed_params, port_modules, recording_train_step,
    replay_jax_draws, rollout_draws, to_np)

SEED = 0
BATCH, TRAIN_BATCHES, VAL_BATCHES = 4, 3, 2
EPOCHS, TOTAL_STEPS, PATIENCE = 4, 10, 1
EVAL_ROLLOUTS = 4  # fit_gflownet's default: the CLI passes none
LR = 1e-4
PROTOCOL = dict(max_steps=3, stop_on_answer=True, num_train_rollouts=4, bc_weight=0.5, bc_hold_ratio=0.2,
                bc_decay_ratio=0.6, total_steps=TOTAL_STEPS, eval_rollout_prefixes=(1, 10, 25), dropout=0.1,
                max_epochs=EPOCHS, patience=PATIENCE, monitor="answer_hit")
HOLD, DECAY = round(TOTAL_STEPS * 0.2), round(TOTAL_STEPS * 0.6)
STEP_TOL = dict(loss=1e-5, grad=GRAD_TOL)
FIT_TOL = 1e-3
HIT_PREFIXES = ("answer_hit@", "answer_hit_ref@")


def fit_param_tol(steps: int) -> float:
    """The drift bound of the module docstring: ``2e-3 * sum(lr_t)``."""
    return 2e-3 * steps * LR


# --------------------------------------------------------------------- data

def agent_data(seed=10, emb=EMB):
    """Train and validation agent samples of the synthetic generator (one
    dummy among the validation ones), one bucket for every batch, and both
    packages' collations of them."""
    ds = make_synthetic_dataset(num_samples=40, emb_dim=emb, max_nodes=12, seed=seed)
    rng = np.random.default_rng(seed)
    samples = []
    for s in ds.samples:
        a = build_agent_sample(
            sample_id=s.sample_id, question_id=s.question_id, heads=s.edge_index[0], tails=s.edge_index[1],
            relations=s.edge_relations, labels=s.edge_labels.astype(np.float32),
            scores=(rng.normal(size=s.edge_index.shape[1]) + 2.0 * s.edge_labels).astype(np.float32),
            node_entity_ids=np.arange(1000, 1000 + s.num_nodes), node_embedding_ids=s.node_embedding_ids,
            start_entity_ids=1000 + s.topic_locals, answer_entity_ids=1000 + s.answer_locals,
            settings=AgentSettings(edge_top_k=20, max_hops=3, score_mode="logits"))
        if a is not None:
            samples.append(a)
    n_train, n_val = BATCH * TRAIN_BATCHES, BATCH * VAL_BATCHES
    assert len(samples) >= n_train + n_val
    train, val = samples[:n_train], samples[n_train:n_train + n_val]
    val[1] = dataclasses.replace(val[1], is_dummy_agent=True, is_answer_reachable=False,
                                 answer_node_locals=np.empty(0, np.int64))
    bucket = jfeed.fixed_agent_bucket(train + val, BATCH)
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb)

    def collate(chunk):
        return (jfeed.collate_agent(chunk, bucket=bucket, **kw),
                tfeed.collate_agent(chunk, bucket=tfeed.Bucket(**dataclasses.asdict(bucket)), **kw))

    def train_batches(epoch, pkg):
        order = np.arange(len(train))
        np.random.default_rng([SEED, epoch]).shuffle(order)  # the CLI's train feed
        return [collate([train[j] for j in order[i:i + BATCH]])[pkg] for i in range(0, len(order), BATCH)]

    def val_batches(pkg):
        return [collate(val[i:i + BATCH])[pkg] for i in range(0, len(val), BATCH)]

    return types.SimpleNamespace(train_batches=train_batches, val_batches=val_batches, graphs=bucket.graphs)


# ---------------------------------------------------------------------- (a)

@pytest.fixture(scope="module")
def common():
    return agent_setup()


@pytest.fixture(scope="module")
def step_setup(common):
    s = common
    jcfg, tcfg = configs(**PROTOCOL)
    jm = jgt.build_modules(jcfg)
    params = perturbed_params(jcfg, jm, s, seed=1)
    jp = jax.tree.map(jnp.asarray, params)

    @jax.jit
    def loss_and_grads(p, keys, bc_w):  # the JAX trainer's loss_fn at one step's keys and BC weight
        return jax.value_and_grad(lambda q: jgt._rollout_losses(
            q, jm, s.jbundle, s.jb, keys, jcfg, bc_weight=bc_w, temperature=jcfg.policy_temperature,
            train=True)[0])(p)

    return types.SimpleNamespace(s=s, jcfg=jcfg, tcfg=tcfg, params=params, jp=jp, loss_and_grads=loss_and_grads)


PHASES = {"hold": HOLD - 1, "decay": HOLD + DECAY // 2, "past": HOLD + DECAY + 1}


@pytest.mark.parametrize("phase", list(PHASES))
def test_protocol_step_matches_jax(step_setup, phase):
    """One step of the trainer at a step of each phase of the BC schedule:
    its keys from the trainer's key stream, its BC weight the JAX
    trainer's (``bc_weight_schedule`` of the step, hold and decay rounded
    from ``total_steps``; (b) holds the trainer's own output to it)."""
    z, step = step_setup, PHASES[phase]
    jcfg = z.jcfg
    bc = jgt.bc_weight_schedule(jnp.asarray(step, jnp.int32), bc_weight=jcfg.bc_weight,
                                bc_weight_floor=jcfg.bc_weight_floor,
                                hold_steps=int(round(jcfg.total_steps * jcfg.bc_hold_ratio)),
                                decay_steps=int(round(jcfg.total_steps * jcfg.bc_decay_ratio)))
    assert {"hold": float(bc) == 0.5, "decay": 0.0 < float(bc) < 0.5, "past": float(bc) == 0.0}[phase], (phase, bc)
    keys = jax_step_keys(SEED + 1, step, PROTOCOL["num_train_rollouts"])
    jloss, jgrads = z.loss_and_grads(z.jp, jnp.stack(keys), bc)
    jgrads = flat(jgrads)

    tm = port_modules(z.tcfg, z.params)
    params = tgt.gflownet_params_tree(tm)
    ttx = tsetup(z.tcfg.optimizer, flatten_tree(params))
    tstate = TState(params=params, opt_state=ttx.init(flatten_tree(params)), step=step, generator=None)
    draws = rollout_draws(keys, z.s.jb, z.jcfg.actor.num_steps, EMB, dropout=PROTOCOL["dropout"],
                          policy_params=z.jp["policy"])
    _, tout = tgt.make_gfn_train_step(tm, ttx, z.tcfg, z.s.tbundle)(tstate, z.s.tb, draws=draws)

    assert float(tout["bc_weight"]) == float(bc)
    np.testing.assert_allclose(tout["loss"].item(), float(jloss), rtol=STEP_TOL["loss"])
    assert float(tout["bc_loss"]) > 0
    tgrads = {tgt.gflownet_path(n): to_np(p.grad) for n, p in tm.named_parameters()}
    assert tgrads.keys() == jgrads.keys()
    for path, g in jgrads.items():
        np.testing.assert_allclose(tgrads[path], g, err_msg=path, **STEP_TOL["grad"])


# ------------------------------------------------------------------ (b), (c)

_EVAL_STEPS: dict = {}
_make_eval_step = jgt.make_gfn_eval_step


def _shared_eval_step(modules, cfg, bundle, **kw):
    """JAX's eval step, compiled once for both fits: it reads no knob in
    which (b) and (c) differ (``cache_frozen_embed`` is a train knob)."""
    key = (dataclasses.replace(cfg, cache_frozen_embed=False), tuple(sorted(kw.items())))
    if key not in _EVAL_STEPS:
        _EVAL_STEPS[key] = _make_eval_step(modules, cfg, bundle, **kw)
    return _EVAL_STEPS[key]


@pytest.fixture(scope="module")
def fit_data():
    return agent_data()


def _fit_both(data, s, monkeypatch, cache: bool):
    """Both packages' ``fit_gflownet`` on ``data`` with the retriever bundle
    of ``s``, from JAX's init, the port with JAX's draws."""
    jcfg, tcfg = configs(cache_frozen_embed=cache, **PROTOCOL)
    jm = jgt.build_modules(jcfg)
    jinit = jax.tree.map(np.asarray, jgt.init_gflownet_params(jcfg, jm, s.jbundle, data.train_batches(0, 0)[0],
                                                               seed=SEED))
    jrows, trows = [], []
    monkeypatch.setattr(jgt, "make_gfn_train_step", recording_train_step(jgt, jrows))
    monkeypatch.setattr(jgt, "make_gfn_eval_step", _shared_eval_step)
    jbest, jinfo = jgt.fit_gflownet(jcfg, s.jbundle, lambda e: data.train_batches(e, 0),
                                    lambda: data.val_batches(0), seed=SEED, eval_rollouts=EVAL_ROLLOUTS)

    real_init = tgt.init_gflownet_params

    def jax_init(cfg, modules, *a, **kw):  # the port starts from JAX's init
        real_init(cfg, modules, *a, **kw)
        tgt.load_gflownet_params(modules, jinit)
        return tgt.gflownet_params_tree(modules)

    monkeypatch.setattr(tgt, "init_gflownet_params", jax_init)
    monkeypatch.setattr(tgt, "make_gfn_train_step", recording_train_step(tgt, trows))
    log: list = []
    monkeypatch.setattr(tactor, "make_rollout_draws", replay_jax_draws(jax.tree.map(jnp.asarray, jinit["policy"]),
                                                                      data.graphs, log))
    tbest, tinfo = tgt.fit_gflownet(tcfg, s.bundle_np, lambda e: data.train_batches(e, 1),
                                    lambda: data.val_batches(1), seed=SEED, eval_rollouts=EVAL_ROLLOUTS, device="cpu")
    return (jbest, jinfo, jrows), (tbest, tinfo, trows), log


def _stop_after(monitor):
    """The epoch after which ``fit_gflownet`` stops on this monitor history."""
    best, bad = -float("inf"), 0
    for epoch, score in enumerate(monitor):
        if score > best:
            best, bad = score, 0
        else:
            bad += 1
            if bad > PATIENCE:
                return epoch
    return EPOCHS - 1


@pytest.mark.parametrize("cache", [False, True], ids=["feed", "cache_frozen_embed"])
def test_protocol_fit_matches_jax(fit_data, common, monkeypatch, cache):
    (jbest, jinfo, jrows), (tbest, tinfo, trows), log = _fit_both(fit_data, common, monkeypatch, cache)
    epochs = len(jinfo["history"])
    # Every draw came from the generator JAX keys it with: step n of the
    # train stream, batch i of epoch e's eval key.
    want_log = []
    for e in range(epochs):
        want_log += [(SEED + 1, e * TRAIN_BATCHES + i, True) for i in range(TRAIN_BATCHES)]
        want_log += [(1000 + e, i, False) for i in range(VAL_BATCHES)]
    assert log == want_log
    # The run: BC held in epoch 0, decayed into epoch 2, stopped by patience.
    monitor = [h["val"]["answer_hit"] for h in jinfo["history"]]
    assert epochs == _stop_after(monitor) + 1 < EPOCHS, monitor
    assert monitor.count(max(monitor)) > 1, monitor  # a tie at the best: what the tie-breaking rule decides
    assert [h["epoch"] for h in tinfo["history"]] == [h["epoch"] for h in jinfo["history"]]
    assert len(jrows) == len(trows) == epochs * TRAIN_BATCHES
    bc = [w for _, w in jrows]
    assert bc[:HOLD] == [0.5] * HOLD and HOLD < TRAIN_BATCHES and 0.0 < bc[HOLD + 1] < 0.5
    assert bc[HOLD + DECAY] == 0.0 and HOLD + DECAY < len(bc)
    # rtol, not equality: the decay's cosine is XLA's and torch's f32 cos,
    # which part in the last bit (8.9e-7 relative at step 7, where 1 + cos
    # cancels); (a)'s three steps are equal to the last bit.
    np.testing.assert_allclose([w for _, w in trows], bc, rtol=FIT_TOL, atol=0)
    np.testing.assert_allclose([lo for lo, _ in trows], [lo for lo, _ in jrows], rtol=FIT_TOL)
    share = 1.0 / (BATCH * VAL_BATCHES)
    for jh, th in zip(jinfo["history"], tinfo["history"]):
        assert th["val"].keys() == jh["val"].keys()
        for k, v in jh["val"].items():
            if k.startswith(HIT_PREFIXES) or k == "answer_hit":
                assert abs(th["val"][k] - v) <= share + 1e-9, (jh["epoch"], k, th["val"][k], v)
            else:
                np.testing.assert_allclose(th["val"][k], v, rtol=FIT_TOL, atol=1e-6, err_msg=f"{jh['epoch']} {k}")
        np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=FIT_TOL)
    assert tinfo["best_score"] == pytest.approx(jinfo["best_score"], abs=share + 1e-9)
    best_epoch = max(range(epochs), key=lambda i: (monitor[i], -i))
    t_monitor = [h["val"]["answer_hit"] for h in tinfo["history"]]
    assert max(range(epochs), key=lambda i: (t_monitor[i], -i)) == best_epoch
    assert tinfo["final_state"].step == len(trows) and int(jinfo["final_state"].step) == len(jrows)
    jflat = flat(jax.tree.map(np.asarray, jbest))
    tflat = {k: to_np(v) for k, v in flatten_tree(tbest).items()}
    assert tflat.keys() == jflat.keys()
    tol = fit_param_tol((best_epoch + 1) * TRAIN_BATCHES)
    for path, want in jflat.items():
        np.testing.assert_allclose(tflat[path], want, rtol=0, atol=tol, err_msg=path)
