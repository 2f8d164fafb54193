"""Port vs JAX under the reference training protocol, step by step and
across a whole ``fit``.

The protocol is the one production training runs
(``configs/retriever/default.yaml``, ``configs/experiment/webqsp_synth_hw.yaml``):
hide-and-seek on (p_near 0.7, p_far 0.1, biases -2.0 / -0.5), dropout 0.1,
InfoNCE at T = 0.07 plus a BCE term of weight 0.1, AdamW with a global clip
of 1.0 under a linear warmup into a cosine, at f32 and at bf16 compute.
Only the width and the number of steps are cut.

Both packages see JAX's own random draws.  ``jax_draws`` replays the JAX
trainer's key stream (``evi_rag_tpu/train/retriever_trainer.py``):
``state.rng = key(seed + 1)``, one ``split`` a step, one key a shard, and
``{"dropout": r, "hide_seek": fold_in(r, 1)}`` for each shard's forward; it
records the dropout keep masks and hide-and-seek uniforms that the module
draws from them.  The port's ``Retriever.make_draws`` is patched to hand
them out in the order the port asks for them (every shard of every step).

Cases:

* (a) One train step at f32 from one set of parameters: the loss at rtol
  1e-5, every gradient leaf within atol 1e-5 + rtol 1e-3
  (``test_train_step_gradients_match_jax``'s bars).  With the BCE term no
  leaf is shift-only: its per-edge logit anchor gives ``score_head/bias``
  and ``state_net_1/bias`` true gradients, so every leaf is held to the bar.
* (b) The same step at bf16 compute, at the bf16 bars derived below.
* (c) ``fit`` from one checkpoint (each package's ``save_checkpoint``, read
  back through ``resume_from``), up to 4 epochs of 4 steps at f32 under a
  warmup of 2 steps into a cosine over the 16, patience 0 under
  ``monitor_mode: max``, so that the warmup, the cosine, early stopping
  (after epoch 2) and the best-epoch choice (epoch 1) all run: the loss of every step at rtol 1e-3, the per-epoch
  validation metrics within one of the 16 validation graphs' share, the
  same epochs run and the same best score kept, and the best parameters
  leaf by leaf within ``_fit_param_tol``'s drift bound.
* (d) The same fit at bf16, at the derived bf16 bars.

**The bf16 bars.**  The f32 bars of a step are the f32 forward bar
(``tests/test_torch_train_retriever.py``: rtol 1e-4 / atol 1e-5) with the
loss's rtol a tenth of it (1e-5) and the gradients' rtol ten times it
(1e-3, atol as is); a fit's loss is held at ten times the forward's rtol
(1e-3).  The bf16 bars apply the same factors to the bf16 forward bar
(rtol 2e-2 / atol 2e-2): a step's loss at rtol 2e-3, its gradients at atol
2e-2 + rtol 2e-1, a fit's per-step loss at rtol 2e-1.  A bf16 gradient is
held per leaf in the norm that the elementwise bar implies, ``|g - g'| <=
atol sqrt(n) + rtol |g|``: an element that sums many edges' terms of both
signs carries its terms' rounding, not its own size's (JAX's own bf16
gradient of ``state_net_1/bias`` lies 2.5 times its norm away from its f32
gradient, the port's 0.29 times).  The fit's parameters drift by at most
``_fit_param_tol``; the validation metrics of a bf16 fit are held within
one graph's share of the graphs each metric averages over.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.models.losses import RetrieverLossConfig as JLossCfg
from evi_rag_tpu.models.losses import retriever_loss as jloss
from evi_rag_tpu.train import checkpoint as jck
from evi_rag_tpu.train import retriever_trainer as jtrain
from evi_rag_tpu.train.optim import OptimizerConfig as JOpt
from evi_rag_tpu.train.optim import _make_schedule as _jax_schedule
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch.models.losses import RetrieverLossConfig as TLossCfg
from evi_rag_tpu_torch.models.retriever import Retriever as TRetriever
from evi_rag_tpu_torch.train import checkpoint as tck
from evi_rag_tpu_torch.train import retriever_trainer as ttrain
from evi_rag_tpu_torch.train.optim import OptimizerConfig as TOpt

from _torch_train_common import datasets, grads_tree_to_flat, init_both, models

BUCKET = jfeed.Bucket(graphs=9, nodes=256, edges=1024)
SHARDS, PER_SHARD = 2, 8
PROTOCOL = dict(dropout_p=0.1, hide_seek_enabled=True, hide_seek_p_near=0.7, hide_seek_p_far=0.1,
                hide_seek_bias_near=-2.0, hide_seek_bias_far=-0.5)
LOSS = dict(infonce_temperature=0.07, bce_weight=0.1)
# Peak lr of configs/retriever/default.yaml; a warmup of 2 steps into a
# cosine over the run's 16 steps (webqsp_synth_hw: 200 into 2,500).  With
# patience 0 the f32 fits stop after epoch 2, whose monitor does not improve.
LR, EPOCHS, STEPS_PER_EPOCH, WARMUP = 1e-3, 4, 4, 2
STEPS = EPOCHS * STEPS_PER_EPOCH
SCHEDULE = dict(name="adamw", learning_rate=LR, grad_clip_norm=1.0, schedule="cosine", warmup_steps=WARMUP,
                total_steps=STEPS)
MONITOR, K_VALUES, PATIENCE = "answer/reachability@5", (1, 5, 10), 0
NUM_VAL = 16

BARS = {  # see the module docstring
    "float32": dict(loss=1e-5, grad=dict(rtol=1e-3, atol=1e-5), fit_loss=1e-3),
    "bfloat16": dict(loss=2e-3, grad=dict(rtol=2e-1, atol=2e-2), fit_loss=2e-1),
}


def _rngs(r):
    return {"dropout": r, "hide_seek": jax.random.fold_in(r, 1)}


def jax_draws(jm, params, flat_batch, steps, *, seed=0):
    """The draws of JAX's trainer for ``steps`` steps of ``SHARDS`` shards
    from ``key(seed + 1)``: a list (step-major, then shard) of the port's
    ``draws`` dicts.  The draws depend on the keys and the shapes only, so
    one batch of the run's bucket stands for every batch."""

    def record(r):
        seen = []
        real = {n: getattr(jax.random, n) for n in ("bernoulli", "uniform")}

        def recorder(name):
            def wrapped(*a, **kw):
                out = real[name](*a, **kw)
                seen.append(out)
                return out
            return wrapped

        try:
            for name in real:
                setattr(jax.random, name, recorder(name))
            jm.apply(params, flat_batch, train=True, rngs=_rngs(r))
        finally:
            for name, fn in real.items():
                setattr(jax.random, name, fn)
        return seen  # fwd keep mask, bwd keep mask, hide-and-seek uniforms

    shard_draws = jax.jit(jax.vmap(record))
    rng, out = jax.random.key(seed + 1), []
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        fwd, bwd, u = (np.asarray(x) for x in shard_draws(jax.random.split(sub, SHARDS)))
        out += [{"dropout": (torch.from_numpy(fwd[i].copy()), torch.from_numpy(bwd[i].copy())),
                 "hide_seek": torch.from_numpy(u[i].copy())} for i in range(SHARDS)]
    return out


def replay(monkeypatch, draws):
    """Patch the port's ``Retriever.make_draws`` to hand out ``draws`` in
    order in train mode; returns the list, which empties as they go."""
    queue = list(draws)
    real = TRetriever.make_draws

    def make_draws(self, batch, *, train, generator=None):
        if not train:
            return real(self, batch, train=train, generator=generator)
        return queue.pop(0)

    monkeypatch.setattr(TRetriever, "make_draws", make_draws)
    return queue


@pytest.fixture(scope="module")
def data():
    jds, tds = datasets(num_samples=STEPS_PER_EPOCH * SHARDS * PER_SHARD, max_nodes=16, seed=2)
    kw = lambda ds: dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb,
                         bucket=BUCKET)
    stacked = (jfeed.collate_stacked(jds.samples[:SHARDS * PER_SHARD], num_shards=SHARDS, **kw(jds)),
               tfeed.collate_stacked(tds.samples[:SHARDS * PER_SHARD], num_shards=SHARDS, **kw(tds)))
    jm, _ = models(**PROTOCOL)
    flat = jax.tree.map(lambda x: x[0], stacked[0])
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), flat))
    return dict(jds=jds, tds=tds, kw=kw, stacked=stacked, params=params,
                draws=jax_draws(jm, params, flat, STEPS, seed=0))


# ------------------------------------------------------------------ (a), (b)

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_protocol_step_matches_jax(data, dtype):
    """One step's loss and gradients under the protocol with JAX's draws of
    the trainer's first step."""
    js, ts = data["stacked"]
    jm, tm = models(compute_dtype=dtype, **PROTOCOL)
    params = init_both(jm, tm, jax.tree.map(lambda x: x[0], js), seed=4)
    jcfg = JLossCfg(**LOSS)
    _, sub = jax.random.split(jax.random.key(1))
    keys = jax.random.split(sub, SHARDS)

    def loss_fn(p):  # the JAX trainer's loss_fn
        def shard(b, r):
            out = jm.apply(p, b, train=True, rngs=_rngs(r))
            return jloss(out.logits, b.edge_labels, b.graph.edge_batch, num_graphs=b.graph.num_graphs,
                         graph_mask=b.graph.graph_mask, edge_mask=b.graph.edge_mask, config=jcfg).loss
        return jnp.mean(jax.vmap(shard)(js, keys))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    jg = grads_tree_to_flat(jg)
    bars = BARS[dtype]
    tcfg = ttrain.RetrieverTrainConfig(loss=TLossCfg(**LOSS))
    tl, _, tg = ttrain.loss_and_grads(tm, tcfg, ts, draws=data["draws"][:SHARDS])
    np.testing.assert_allclose(tl.item(), float(jl), rtol=bars["loss"])
    assert set(tg) == set(jg)
    for path, g in tg.items():
        err = np.linalg.norm(g.numpy() - jg[path])
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), jg[path], err_msg=path, **bars["grad"])
        else:
            bound = bars["grad"]["atol"] * np.sqrt(g.numel()) + bars["grad"]["rtol"] * np.linalg.norm(jg[path])
            assert err <= bound, (path, err, bound)
    # The BCE term gives the leaves that only shift every logit a true
    # gradient: none of them is noise here (they are under pure InfoNCE).
    for path in ("params/score_head/bias", "params/state_net_1/bias"):
        assert np.abs(jg[path]).max() > 1e-3, path


# ------------------------------------------------------------------ (c), (d)

def _recording(lib, losses):
    """``lib.make_train_step`` whose steps append their loss to ``losses``."""
    real = lib.make_train_step

    def make_train_step(*a, **kw):
        step = real(*a, **kw)

        def recorded(state, batch):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            return state, metrics
        return recorded
    return make_train_step


def _fit_both(data, tmp, monkeypatch, dtype):
    jds, tds, kw = data["jds"], data["tds"], data["kw"]
    jm, tm = models(compute_dtype=dtype, **PROTOCOL)
    common = dict(max_epochs=EPOCHS, k_values=K_VALUES, monitor=MONITOR, monitor_mode="max", patience=PATIENCE)
    jcfg = jtrain.RetrieverTrainConfig(loss=JLossCfg(**LOSS), optimizer=JOpt(**SCHEDULE), **common)
    tcfg = ttrain.RetrieverTrainConfig(loss=TLossCfg(**LOSS), optimizer=TOpt(**SCHEDULE), **common)

    def feeds(lib, ds):
        train = lambda epoch: lib.iter_stacked_batches(ds.samples, num_shards=SHARDS, per_shard_batch=PER_SHARD,
                                                       seed=epoch, **kw(ds))
        val = lambda: (lib.collate_retriever(ds.samples[i : i + PER_SHARD], **kw(ds))
                       for i in range(0, NUM_VAL, PER_SHARD))
        return train, val

    jck.save_checkpoint(tmp / "jax_start", data["params"])
    tck.save_checkpoint(tmp / "port_start", data["params"])
    jlosses, tlosses = [], []
    monkeypatch.setattr(jtrain, "make_train_step", _recording(jtrain, jlosses))
    monkeypatch.setattr(ttrain, "make_train_step", _recording(ttrain, tlosses))
    jbest, jinfo = jtrain.fit(jm, jcfg, *feeds(jfeed, jds), resume_from=str(tmp / "jax_start"))
    queue = replay(monkeypatch, data["draws"])
    tbest, tinfo = ttrain.fit(tm, tcfg, *feeds(tfeed, tds), resume_from=str(tmp / "port_start"), device="cpu")
    assert len(queue) == SHARDS * (STEPS - len(tlosses))  # every step took its shards' draws in order
    return (jbest, jinfo, jlosses), (tbest, tinfo, tlosses)


def _lr_sum(steps: int) -> float:
    """The learning rates of the run's first ``steps`` updates, summed
    (optax's schedule at counts 0 .. steps - 1)."""
    sched = _jax_schedule(JOpt(**SCHEDULE), LR)
    return float(sum(sched(c) for c in range(steps)))


def _fit_param_tol(dtype: str, steps: int) -> float:
    """How far a parameter may drift between the packages over ``steps``
    AdamW updates (``tests/test_torch_train_fit.py::_fit_param_tol`` under a
    schedule).  A gradient known to rtol r moves an update ``lr_t * m / (sqrt(v)
    + eps)`` by at most ``2 r lr_t``: ``2e-3 * sum(lr_t)`` at f32.  At bf16
    the bar's atol (2e-2) leaves most elements' gradients unresolved, so
    their sign may differ and an update may go either way: ``2 * sum(lr_t)``,
    the bound of the f32 test's shift-only leaves."""
    return 2.0 * _lr_sum(steps) * (BARS[dtype]["grad"]["rtol"] if dtype == "float32" else 1.0)


def _shares(data, dtype):
    """{metric prefix: one validation graph's share of it}.  At f32 every
    metric is held within one of the ``NUM_VAL`` graphs' share, as in
    ``test_fit_matches_jax_from_one_checkpoint``; at bf16 within one graph
    of those the metric averages over (JAX's ``graph_valid`` counts)."""
    groups = {"edge/recall": "edge/graph_valid", "bridge/recall": "bridge/graph_valid",
              "answer/reach": "answer/graph_valid", "edge/margin_positive_rate": "edge/margin_valid"}
    if dtype == "float32":
        return {g: 1.0 / NUM_VAL for g in groups}
    jm, _ = models(compute_dtype=dtype, **PROTOCOL)
    step = jtrain.make_eval_step(jm, jtrain.RetrieverTrainConfig(k_values=K_VALUES))
    kw, jds = data["kw"], data["jds"]
    counts = {g: 0.0 for g in groups}
    for i in range(0, NUM_VAL, PER_SHARD):
        res = step(data["params"], jfeed.collate_retriever(jds.samples[i : i + PER_SHARD], **kw(jds)))
        for g, valid in groups.items():
            counts[g] += float(np.sum(res[valid]))
    return {g: 1.0 / max(n, 1.0) for g, n in counts.items()}


def _stop_after(monitor: list[float]) -> int:
    """The epoch after which ``fit`` stops on this monitor history
    (``monitor_mode: max``, patience ``PATIENCE``, at most ``EPOCHS``)."""
    best, bad = -float("inf"), 0
    for epoch, score in enumerate(monitor):
        if score > best:
            best, bad = score, 0
        else:
            bad += 1
            if bad > PATIENCE:
                return epoch
    return EPOCHS - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_protocol_fit_matches_jax(data, tmp_path, monkeypatch, dtype):
    (jbest, jinfo, jlosses), (tbest, tinfo, tlosses) = _fit_both(data, tmp_path, monkeypatch, dtype)
    bars = BARS[dtype]
    # Early stopping and the best epoch under monitor_mode max: each fit
    # stops and keeps its best where its own monitor says; at f32 both stop
    # after epoch 2.  At bf16 the monitor may differ by a graph's share (the
    # bar below), and so may the epoch where a fit stops: the epochs both
    # ran are compared.
    for info, losses in ((jinfo, jlosses), (tinfo, tlosses)):
        monitor = [h["val"][MONITOR] for h in info["history"]]
        assert len(monitor) == _stop_after(monitor) + 1 and len(losses) == STEPS_PER_EPOCH * len(monitor)
        assert info["best_score"] == max(monitor)
    if dtype == "float32":
        assert [h["epoch"] for h in tinfo["history"]] == [h["epoch"] for h in jinfo["history"]] == [0, 1, 2]
    n = min(len(jlosses), len(tlosses))
    np.testing.assert_allclose(tlosses[:n], jlosses[:n], rtol=bars["fit_loss"])
    shares = _shares(data, dtype)
    for jh, th in zip(jinfo["history"], tinfo["history"]):
        assert th["val"].keys() == jh["val"].keys()
        for k, v in jh["val"].items():
            share = next((s for g, s in shares.items() if k.startswith(g)), None)
            if share is not None:
                assert abs(th["val"][k] - v) <= share + 1e-9, (dtype, th["epoch"], k, th["val"][k], v)
    assert tinfo["best_score"] == pytest.approx(jinfo["best_score"], abs=shares["answer/reach"] + 1e-9)
    assert tinfo["final_state"].step == len(tlosses) and int(jinfo["final_state"].step) == len(jlosses)
    jflat = grads_tree_to_flat(jax.tree.map(np.asarray, jbest))
    tflat = {k: v.numpy() for k, v in tck.flatten_tree(tbest).items()}
    assert set(tflat) == set(jflat)
    tol = _fit_param_tol(dtype, max(len(jlosses), len(tlosses)))
    for path, want in jflat.items():
        np.testing.assert_allclose(tflat[path], want, rtol=0, atol=tol, err_msg=path)
