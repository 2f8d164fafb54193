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
  rtol 1e-3, per-graph validation metrics within one graph's share.
* Checkpoints keep ``opt_state`` / ``step`` / ``has_opt_state`` and the JAX
  digest; resuming restores the optimizer state.
* ``train_retriever`` runs on the CPU (``device=cpu``) end to end, writes
  what the JAX task writes, and ``serve`` loads its ``ckpt/best``.
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


def test_train_retriever_task_on_cpu_then_serve(tmp_path):
    assert tcli.main(["train_retriever", "--configs-dir", CONFIGS, *COMMON, "device=cpu",
                      f"retriever.train.ckpt_dir={tmp_path / 'ckpt'}", f"paths.log_dir={tmp_path / 'logs'}"]) == 0
    (tmetrics,) = (tmp_path / "logs").glob("**/metrics.json")
    tm = json.loads(tmetrics.read_text())
    assert (tmetrics.parent / "metrics.jsonl").exists()
    best, best_meta = tck.load_checkpoint(tmp_path / "ckpt" / "best")
    _, last_meta = tck.load_checkpoint(tmp_path / "ckpt" / "last")
    assert tm["best_ckpt_sha256"] == best_meta["params_sha256"] and last_meta["has_opt_state"]
    assert jck.params_digest(best["params"]) == best_meta["params_sha256"]

    assert jcli.main(["train_retriever", "--configs-dir", CONFIGS, *COMMON,
                      f"retriever.train.ckpt_dir={tmp_path / 'jckpt'}", f"paths.log_dir={tmp_path / 'jlogs'}"]) == 0
    (jmetrics,) = (tmp_path / "jlogs").glob("**/metrics.json")
    assert set(tm) == set(json.loads(jmetrics.read_text()))
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["best", "last"]

    assert tcli.main(["serve", "--configs-dir", CONFIGS, "dataset.num_samples=8", "dataset.emb_dim=32",
                      "dataset.max_nodes=12", "serve.splits=[validation]", "serve.k=10", "serve.k_values=[1,10]",
                      "device=cpu", f"retriever.ckpt={tmp_path / 'ckpt' / 'best'}",
                      f"paths.log_dir={tmp_path / 'serve_logs'}"]) == 0
    (smetrics,) = (tmp_path / "serve_logs").glob("**/metrics.json")
    assert 0.0 <= json.loads(smetrics.read_text())["validation/serve/recall@10"] <= 1.0

    with pytest.raises(ConfigError, match="num_shards"):
        tcli.task_train_retriever.__wrapped__(
            {"device": "cpu", "retriever": {"train": {"num_shards": 2}}}, run_dir=tmp_path)
