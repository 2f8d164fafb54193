"""Port vs JAX: the train step, ``fit``, checkpoints with optimizer state,
and the ``train_retriever`` task.

* One train step over a stacked batch of 2 shards (f32, dropout 0,
  hide-and-seek off) from the same parameters: the loss at f32 tolerance,
  every gradient leaf within atol 1e-5 + rtol 1e-3; ``remat`` changes
  nothing, also with dropout (its masks are drawn outside the recomputed
  function).
* Both ``fit``s start from one set of numpy parameters, saved by each
  package's ``save_checkpoint`` and read back through ``resume_from``, and
  run 2 epochs of the small synthetic setting: per-epoch train loss within
  rtol 1e-3, per-graph validation metrics within one graph's share, the
  best parameters leaf by leaf within the drift that the one-step gradient
  bound allows over the run's 6 steps (``_fit_param_tol``).
* Checkpoints keep ``opt_state`` / ``step`` / ``has_opt_state`` and the JAX
  digest; resuming restores the optimizer state.
* ``train_retriever`` runs on the CPU (``device=cpu``) end to end from the
  checkpoint the JAX task resumes from too; both ``metrics.json`` agree by
  value, and ``serve`` loads its ``ckpt/best``.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu import cli as jcli
from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.models.losses import retriever_loss as jloss
from evi_rag_tpu.train import checkpoint as jck
from evi_rag_tpu.train import retriever_trainer as jtrain
from evi_rag_tpu.train.optim import OptimizerConfig as JOpt
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch.models.losses import RetrieverLossConfig as TLoss
from evi_rag_tpu_torch.models.retriever import flax_path, params_to_numpy
from evi_rag_tpu_torch.train import checkpoint as tck
from evi_rag_tpu_torch.train import retriever_trainer as ttrain
from evi_rag_tpu_torch.train.optim import OptimizerConfig as TOpt
from evi_rag_tpu_torch.utils.config import ConfigError

from _torch_train_common import datasets, grads_tree_to_flat, init_both, models

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
BUCKET = jfeed.Bucket(graphs=9, nodes=256, edges=1024)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
# InfoNCE over each graph's edges is invariant to one shift of all its
# logits, and these two leaves only shift all logits: their true gradient is
# 0, and what each package computes for it is rounding noise
# (``test_train_step_gradients_match_jax`` holds both at or below 1e-5).
SHIFT_ONLY = ("params/score_head/bias", "params/state_net_1/bias")


def _stacked(jds, tds, n=16, shards=2):
    args = lambda ds: dict(num_shards=shards, entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                           question_emb=ds.question_emb, bucket=BUCKET)
    return (jfeed.collate_stacked(jds.samples[:n], **args(jds)),
            tfeed.collate_stacked(tds.samples[:n], **args(tds)))


def test_train_step_gradients_match_jax():
    jds, tds = datasets(num_samples=16, max_nodes=16, seed=2)
    js, ts = _stacked(jds, tds)
    jm, tm = models()
    params = init_both(jm, tm, jax.tree.map(lambda x: x[0], js), seed=4)
    cfg = jtrain.RetrieverTrainConfig()

    def loss_fn(p):
        def shard(b):
            out = jm.apply(p, b, train=True)
            return jloss(out.logits, b.edge_labels, b.graph.edge_batch, num_graphs=b.graph.num_graphs,
                         graph_mask=b.graph.graph_mask, edge_mask=b.graph.edge_mask, config=cfg.loss).loss
        return jnp.mean(jax.vmap(shard)(js))

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    jg = grads_tree_to_flat(jg)
    for remat in (False, True):
        tcfg = ttrain.RetrieverTrainConfig(loss=TLoss(), remat=remat)
        tl, metrics, tg = ttrain.loss_and_grads(tm, tcfg, ts)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        assert set(tg) == set(jg)
        for path, g in tg.items():
            np.testing.assert_allclose(g.numpy(), jg[path], err_msg=path, **GRAD_TOL)
        for path in SHIFT_ONLY:
            assert np.abs(jg[path]).max() <= 1e-5 and np.abs(tg[path].numpy()).max() <= 1e-5, path
        assert {"infonce", "pos_prob", "infonce_graphs"} <= set(metrics)


def test_remat_recomputes_with_the_same_draws():
    _, tds = datasets(num_samples=8, max_nodes=16, seed=2)
    _, ts = _stacked(tds, tds, n=8)
    _, tm = models(dropout_p=0.3, hide_seek_enabled=True, hide_seek_p_near=0.5, hide_seek_p_far=0.2,
                   hide_seek_bias_near=-2.0, hide_seek_bias_far=-0.5)
    ttrain.create_train_state(tm, None, ttrain.RetrieverTrainConfig(), seed=1, device="cpu")
    out = []
    for remat in (False, True):
        cfg = ttrain.RetrieverTrainConfig(loss=TLoss(), remat=remat)
        loss, _, grads = ttrain.loss_and_grads(tm, cfg, ts, generator=torch.Generator().manual_seed(9))
        out.append((loss.item(), {k: v.clone() for k, v in grads.items()}))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for k in out[0][1]:
        np.testing.assert_allclose(out[1][1][k].numpy(), out[0][1][k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def _fit_both(tmp, max_epochs=2):
    jds, tds = datasets(num_samples=48, max_nodes=16, seed=2)
    jm, tm = models(hidden_dim=64)
    jcfg = jtrain.RetrieverTrainConfig(
        optimizer=JOpt(name="adamw", learning_rate=3e-3, grad_clip_norm=1.0),
        max_epochs=max_epochs, k_values=(1, 5, 10), monitor="edge/recall@5", patience=8)
    tcfg = ttrain.RetrieverTrainConfig(
        optimizer=TOpt(name="adamw", learning_rate=3e-3, grad_clip_norm=1.0),
        max_epochs=max_epochs, k_values=(1, 5, 10), monitor="edge/recall@5", patience=8)

    def feeds(lib, ds):
        kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb, bucket=BUCKET)
        train = lambda epoch: lib.iter_stacked_batches(ds.samples, num_shards=2, per_shard_batch=8, seed=epoch, **kw)
        val = lambda: (lib.collate_retriever(ds.samples[i : i + 8], **kw) for i in range(0, 16, 8))
        return train, val

    first = jax.tree.map(lambda x: x[0], next(iter(feeds(jfeed, jds)[0](0))))
    params = jax.tree.map(np.asarray, jm.init(jax.random.key(0), first))
    jck.save_checkpoint(tmp / "jax_start", params)
    tck.save_checkpoint(tmp / "port_start", params)
    jbest, jinfo = jtrain.fit(jm, jcfg, *feeds(jfeed, jds), resume_from=str(tmp / "jax_start"))
    tbest, tinfo = ttrain.fit(tm, tcfg, *feeds(tfeed, tds), resume_from=str(tmp / "port_start"), device="cpu")
    return params, (jbest, jinfo), (tbest, tinfo), tm


def test_fit_matches_jax_from_one_checkpoint(tmp_path):
    _, (jbest, jinfo), (tbest, tinfo), tm = _fit_both(tmp_path)
    assert len(tinfo["history"]) == len(jinfo["history"]) == 2
    share = 1.0 / 16  # one of the 16 validation graphs
    for jh, th in zip(jinfo["history"], tinfo["history"]):
        np.testing.assert_allclose(th["train_loss"], jh["train_loss"], rtol=1e-3)
        assert th["val"].keys() == jh["val"].keys()
        for k, v in jh["val"].items():
            if k.startswith(("edge/recall", "answer/reach", "bridge/recall", "edge/margin_positive_rate")):
                assert abs(th["val"][k] - v) <= share + 1e-9, (th["epoch"], k, th["val"][k], v)
    assert tinfo["final_state"].step == 6
    jflat = grads_tree_to_flat(jax.tree.map(np.asarray, jbest))
    tflat = {k: v.numpy() for k, v in tck.flatten_tree(tbest).items()}
    assert set(tflat) == set(jflat)
    for path, want in jflat.items():
        np.testing.assert_allclose(tflat[path], want, rtol=0, atol=_fit_param_tol(path, lr=3e-3, steps=6),
                                   err_msg=path)


def _fit_param_tol(path: str, *, lr: float, steps: int) -> float:
    """How far the two packages' parameters may drift apart over ``steps``
    AdamW steps at learning rate ``lr``, from the one-step gradient bound
    of ``test_train_step_gradients_match_jax`` (atol 1e-5 + rtol 1e-3).

    A step moves a leaf by ``lr * m / (sqrt(v) + eps)``, a ratio that does
    not depend on the gradient's scale; a gradient known to rtol 1e-3 moves
    the ratio by at most 2e-3 of its size (numerator and denominator each
    off by 1e-3), i.e. by at most ``2e-3 * lr`` a step, and the differences
    of the steps add up: ``steps * 2e-3 * lr`` (3.6e-5 at lr 3e-3 over 6
    steps).  The atol term leaves a gradient at or below 1e-5 unresolved:
    its sign may differ, and AdamW turns noise into a step of up to ``lr``
    in either direction.  That is the case of the ``SHIFT_ONLY`` leaves,
    whose true gradient is 0: ``steps * 2 * lr``."""
    return steps * 2.0 * lr if path in SHIFT_ONLY else steps * 2e-3 * lr


def test_checkpoint_keeps_optimizer_state_and_resume_restores_it(tmp_path):
    jds, tds = datasets(num_samples=8, max_nodes=16, seed=2)
    _, ts = _stacked(jds, tds, n=8)
    _, tm = models()
    cfg = ttrain.RetrieverTrainConfig(loss=TLoss(), max_epochs=0)
    state, tx = ttrain.create_train_state(tm, None, cfg, seed=3, device="cpu")
    state, metrics = ttrain.make_train_step(tm, tx, cfg)(state, ts)
    assert np.isfinite(metrics["loss"].item()) and np.isfinite(metrics["grad_norm"].item())
    numpy_params = params_to_numpy(tm)
    digest = tck.save_checkpoint(tmp_path / "last", state.params, opt_state=state.opt_state, step=state.step,
                                 meta={"parity_meta": tm.parity_meta()})
    assert digest == jck.params_digest(numpy_params)
    tree, meta = tck.load_checkpoint(tmp_path / "last")
    assert meta["has_opt_state"] and meta["step"] == 1 and meta["parity_meta"] == tm.parity_meta()
    saved = tck.flatten_tree(tree["opt_state"])
    assert saved.keys() == state.opt_state.keys()
    for k, v in state.opt_state.items():
        np.testing.assert_array_equal(saved[k], v.numpy())
    tck.validate_parity_meta(tm.parity_meta(), meta["parity_meta"])
    with pytest.raises(ValueError, match="parity_meta mismatch"):
        tck.validate_parity_meta(tm.parity_meta(), {**meta["parity_meta"], "dde_rounds": 3})

    _, tm2 = models()
    _, info = ttrain.fit(tm2, cfg, lambda e: iter([ts]), lambda: iter(()), resume_from=str(tmp_path / "last"),
                         device="cpu")
    restored = info["final_state"]
    assert restored.step == 1
    for k, v in state.opt_state.items():
        np.testing.assert_array_equal(restored.opt_state[k].numpy(), v.numpy())
    for name, p in tm2.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), tck.flatten_tree(numpy_params)[flax_path(name)])


COMMON = ["dataset.num_samples=8", "dataset.emb_dim=32", "dataset.max_nodes=12", "retriever.model.emb_dim=32",
          "retriever.model.hidden_dim=32", "retriever.train.max_epochs=1", "retriever.train.k_values=[1,5]",
          "retriever.train.monitor=edge/recall@5", "retriever.model.hide_seek.enabled=false"]


def _start_checkpoint(tmp):
    """One set of parameters at the COMMON width, saved by both packages."""
    cfg = jcli.load_config(CONFIGS, "train_retriever", COMMON)
    samples, ent, rel, q = jcli._load_split(cfg, "train")
    batch = jfeed.collate_retriever(samples[:4], entity_emb=ent, relation_emb=rel, question_emb=q,
                                    bucket=jfeed.fixed_bucket_for(samples, 4))
    model = jcli._retriever_model(cfg, inferred_dim=ent.shape[1])
    params = jax.tree.map(np.asarray, model.init(jax.random.key(1), batch))
    meta = {"parity_meta": model.parity_meta()}
    jck.save_checkpoint(tmp / "jax_start", params, meta=meta)
    tck.save_checkpoint(tmp / "port_start", params, meta=meta)
    return params


# Validation metrics that are mean sigmoid probabilities, and differences of two.
PROBS = ("bridge/pos_prob", "bridge/neg_prob", "features/pos_prob_avg", "features/neg_prob_avg")
PROB_GAPS = ("bridge/separation", "features/separation_gap")


def _prob_tol(params, *, lr: float, steps: int) -> float:
    """How far a mean sigmoid probability may differ between the packages
    after ``steps`` AdamW steps from ``params``, through the ``SHIFT_ONLY``
    leaves (``_fit_param_tol``: up to ``2 lr`` apart a step, per
    component).  ``score_head/bias`` shifts every logit by its own drift,
    ``state_net_1/bias`` by its drift times ``score_head/kernel``; so the
    logits shift by at most ``2 lr (1 + |w|_1)`` a step, ``w`` the head's
    kernel (which itself moves by at most ``lr`` a component and step), and
    a sigmoid moves by at most a quarter of that."""
    w1 = float(np.abs(params["params"]["score_head"]["kernel"]).sum())
    w1 += steps * lr * params["params"]["score_head"]["kernel"].size
    return steps * 2.0 * lr * (1.0 + w1) / 4.0


def test_train_retriever_task_on_cpu_then_serve(tmp_path):
    """Both CLIs resume from one checkpoint (dropout 0, hide-and-seek off)
    and take one step (8 graphs, batch 8): the train loss of each epoch
    within rtol 1e-3, the validation recall and reachability within one
    validation graph's share, the mean sigmoid probabilities and their
    differences within rtol 1e-3 + ``_prob_tol``, every other validation
    metric within rtol 1e-3."""
    start = _start_checkpoint(tmp_path)
    runs = {}
    for name, lib, extra in (("port", tcli, ["device=cpu"]), ("jax", jcli, [])):
        assert lib.main(["train_retriever", "--configs-dir", CONFIGS, *COMMON, *extra,
                         "retriever.model.dropout_p=0.0", f"retriever.train.resume_from={tmp_path / f'{name}_start'}",
                         f"retriever.train.ckpt_dir={tmp_path / f'{name}_ckpt'}",
                         f"paths.log_dir={tmp_path / f'{name}_logs'}"]) == 0
        (metrics_file,) = (tmp_path / f"{name}_logs").glob("**/metrics.json")
        runs[name] = (json.loads(metrics_file.read_text()),
                      [json.loads(x) for x in (metrics_file.parent / "metrics.jsonl").read_text().splitlines()])
    (tm, tlog), (jm, jlog) = runs["port"], runs["jax"]
    assert tm.keys() == jm.keys()
    share, lr = 1.0 / 8, 1e-3  # 8 validation graphs; configs/retriever/default.yaml's learning rate
    prob_tol = _prob_tol(start, lr=lr, steps=1)
    for k, v in jm.items():
        if k == "best_ckpt_sha256":
            continue
        if k.startswith(("edge/recall", "answer/reach", "bridge/recall", "edge/margin_positive_rate")):
            assert abs(tm[k] - v) <= share + 1e-9, (k, tm[k], v)
        elif k in PROBS:
            assert tm[k] == pytest.approx(v, rel=1e-3, abs=prob_tol), k
        elif k in PROB_GAPS:
            assert tm[k] == pytest.approx(v, rel=1e-3, abs=2 * prob_tol), k
        else:
            assert tm[k] == pytest.approx(v, rel=1e-3), k
    assert len(tlog) == len(jlog) == tm["epochs"]
    for t_row, j_row in zip(tlog, jlog):
        assert t_row["train_loss"] == pytest.approx(j_row["train_loss"], rel=1e-3)

    best, best_meta = tck.load_checkpoint(tmp_path / "port_ckpt" / "best")
    _, last_meta = tck.load_checkpoint(tmp_path / "port_ckpt" / "last")
    assert tm["best_ckpt_sha256"] == best_meta["params_sha256"] and last_meta["has_opt_state"]
    assert jck.params_digest(best["params"]) == best_meta["params_sha256"]
    assert sorted(p.name for p in (tmp_path / "port_ckpt").iterdir()) == ["best", "last"]

    assert tcli.main(["serve", "--configs-dir", CONFIGS, "dataset.num_samples=8", "dataset.emb_dim=32",
                      "dataset.max_nodes=12", "serve.splits=[validation]", "serve.k=10", "serve.k_values=[1,10]",
                      "device=cpu", f"retriever.ckpt={tmp_path / 'port_ckpt' / 'best'}",
                      f"paths.log_dir={tmp_path / 'serve_logs'}"]) == 0
    (smetrics,) = (tmp_path / "serve_logs").glob("**/metrics.json")
    assert 0.0 <= json.loads(smetrics.read_text())["validation/serve/recall@10"] <= 1.0

    # num_shards > 1 in one process: data-parallel training runs one process
    # per device, and the error names the launch.
    with pytest.raises(ConfigError, match="num_shards=2 > available devices 1.*torchrun --nproc-per-node 2"):
        tcli.task_train_retriever.__wrapped__(
            {"device": "cpu", "retriever": {"train": {"num_shards": 2}}}, run_dir=tmp_path)
