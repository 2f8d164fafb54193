"""Port vs JAX: data-parallel training, one gloo rank per shard.

The port runs data-parallel training as one process per device
(``testing_dp`` spawns two CPU ranks joined by the ``EVI_*``
variables); JAX runs one program over ``make_mesh(2)`` of the virtual CPU
devices.  Both start from the same parameters and the same stacked batch.

* The two-shard retriever step (f32, dropout 0, AdamW at 1e-4) against
  JAX's ``make_train_step`` over ``make_mesh(2)``: the loss at rtol 1e-5, the
  parameters at rtol 1e-3 / atol 5e-5 (``tests/test_sharded.py:50-54``),
  except the two leaves whose true gradient is 0, which AdamW may move by
  2 lr either way (``tests/test_torch_train_fit.py::SHIFT_ONLY``).  The two
  ranks' parameters are bit for bit equal to each other and to the
  single-process two-shard step.
* The stacked GFlowNet step (dropout 0.2) under JAX's per-shard draws
  against JAX's stacked step: the loss at rtol 1e-4, the parameters within
  1e-6 (``tests/test_torch_gflownet_train.py``'s tolerances); the ranks
  equal each other and the single-process loop over the shards.
* ``collate_agent_stacked`` and ``collate_retriever(with_pairs=True)``
  against JAX's, array for array.
* The ``train_retriever`` CLI on two ranks with
  ``retriever.train.num_shards=2``: one ``ckpt/best`` in the shared
  directory, the same digest on both ranks.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from evi_rag_tpu.data import feeder as jfeed
from evi_rag_tpu.data.synthetic import make_synthetic_dataset as j_synth
from evi_rag_tpu.models.retriever import Retriever as JRetriever
from evi_rag_tpu.parallel.mesh import make_mesh as j_make_mesh, replicated, shard_batch
from evi_rag_tpu.train import gflownet_trainer as jgt
from evi_rag_tpu.train import retriever_trainer as jtrain
from evi_rag_tpu.train.optim import setup_optimizer as jsetup
from evi_rag_tpu_torch.data import feeder as tfeed
from evi_rag_tpu_torch import testing_dp
from evi_rag_tpu_torch.testing import SMALL_TRAIN_OVERRIDES
from evi_rag_tpu_torch.train.checkpoint import load_checkpoint

from _torch_gfn_common import EMB, agent_setup, configs, flat, perturbed_params, rollout_draws
from _torch_train_common import grads_tree_to_flat

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
SHIFT_ONLY = ("params/score_head/bias", "params/state_net_1/bias")
LR = 1e-4
RANKS = dict(timeout_s=120, threads=1)


def _params_of(out_dir, name, rank):
    with np.load(pathlib.Path(out_dir) / f"{name}_rank{rank}.npz") as npz:
        return {k: npz[k] for k in npz.files}


def _ranks_agree_with_single_process(out, spec, name):
    """Both ranks' parameters bit for bit equal to each other and to the
    same step in one process (the shards one after another), at the ranks'
    one thread (the CPU's sums depend on the thread count)."""
    ref = pathlib.Path(out) / "single"
    threads = torch.get_num_threads()
    torch.set_num_threads(RANKS["threads"])
    try:
        testing_dp.run_checks({**spec, "out_dir": str(ref)})
    finally:
        torch.set_num_threads(threads)
    p0, p1, single = _params_of(out, name, 0), _params_of(out, name, 1), _params_of(ref, name, 0)
    assert p0.keys() == p1.keys() == single.keys()
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
        np.testing.assert_array_equal(p0[k], single[k], err_msg=k)
    return p0


def test_two_rank_retriever_step_matches_jax(tmp_path):
    ds_kw = dict(num_samples=16, emb_dim=16, max_nodes=10, seed=4)
    jds = j_synth(**ds_kw)
    samples = jds.samples[:8]
    stacked = jfeed.collate_stacked(samples, num_shards=2, entity_emb=jds.entity_emb, relation_emb=jds.relation_emb,
                                    question_emb=jds.question_emb, bucket=jfeed.fixed_bucket_for(samples, 4))
    model_kw = dict(emb_dim=16, hidden_dim=16, dropout_p=0.0)
    model = JRetriever(**model_kw)
    cfg = jtrain.RetrieverTrainConfig(k_values=(5,))
    state, tx = jtrain.create_train_state(model, stacked, cfg, seed=0)
    np.savez(tmp_path / "params.npz", **grads_tree_to_flat(jax.tree.map(np.asarray, state.params)))
    mesh = j_make_mesh(2)
    jstate, jm = jtrain.make_train_step(model, tx, cfg)(jax.device_put(state, replicated(mesh)),
                                                       shard_batch(stacked, mesh))
    want = grads_tree_to_flat(jax.tree.map(np.asarray, jstate.params))

    spec = {"device": "cpu", "out_dir": str(tmp_path / "dp"), "timeout_s": 60, "checks": [{
        "kind": "retriever_step", "name": "ret", "dataset": ds_kw, "shards": 2, "per_shard": 4, "model": model_kw,
        "optimizer": {"name": "adamw", "learning_rate": LR}, "params": str(tmp_path / "params.npz")}]}
    rows = testing_dp.spawn_checks(spec, 2, **RANKS)
    assert [r["world"] for r in rows] == [2, 2] and [r["device"] for r in rows] == ["cpu", "cpu"]
    for row in rows:
        np.testing.assert_allclose(row["checks"]["ret"]["loss"], float(jm["loss"]), rtol=1e-5)
    got = _ranks_agree_with_single_process(spec["out_dir"], spec, "ret")
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k in SHIFT_ONLY:
            np.testing.assert_allclose(got[k], v, rtol=0, atol=2 * LR, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-3, atol=5e-5, err_msg=k)


def test_two_rank_gflownet_step_matches_jax(tmp_path):
    s = agent_setup(count=4)
    jcfg, tcfg = configs(dropout=0.2, max_steps=3, stop_on_answer=False)
    kw = dict(entity_emb=s.ds.entity_emb, relation_emb=s.ds.relation_emb, question_emb=s.ds.question_emb)
    bucket = jfeed.fixed_agent_bucket(s.samples, 2)
    jstacked = jfeed.collate_agent_stacked(s.samples, num_shards=2, bucket=bucket, **kw)
    tstacked = tfeed.collate_agent_stacked(s.samples, num_shards=2, bucket=tfeed.Bucket(**dataclasses.asdict(bucket)),
                                           **kw)
    jm = jgt.build_modules(jcfg)
    params = perturbed_params(jcfg, jm, s, seed=1)
    jp = jax.tree.map(jax.numpy.asarray, params)
    tx = jsetup(jcfg.optimizer, jp)
    state = jtrain.TrainState(params=jp, opt_state=jax.jit(tx.init)(jp), step=jax.numpy.zeros((), jax.numpy.int32),
                              rng=jax.random.key(1))
    jnew, jout = jgt.make_gfn_train_step(jm, tx, jcfg, s.jbundle)(state, jstacked)
    # JAX's draws: one key per shard, one per rollout within it.
    _, sub = jax.random.split(state.rng)
    draws = [rollout_draws(list(jax.random.split(key, jcfg.num_train_rollouts)),
                           jax.tree.map(lambda x, i=i: x[i], jstacked), jcfg.actor.num_steps, EMB, dropout=0.2,
                           policy_params=jp["policy"])
             for i, key in enumerate(jax.random.split(sub, 2))]
    torch.save(tstacked, tmp_path / "batch.pt")
    torch.save(draws, tmp_path / "draws.pt")
    np.savez(tmp_path / "params.npz", **flat(params))
    np.savez(tmp_path / "bundle.npz", **flat(s.bundle_np))
    cfg = {f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg) if f.name not in ("reward", "optimizer")}
    cfg["optimizer"] = {"name": "adamw", "learning_rate": 1e-4, "grad_clip_norm": 1.0}
    spec = {"device": "cpu", "out_dir": str(tmp_path / "dp"), "timeout_s": 60, "checks": [{
        "kind": "gflownet_step", "name": "gfn", "cfg": cfg, "batch": str(tmp_path / "batch.pt"),
        "draws": str(tmp_path / "draws.pt"), "params": str(tmp_path / "params.npz"),
        "bundle": str(tmp_path / "bundle.npz")}]}
    rows = testing_dp.spawn_checks(spec, 2, **RANKS)
    for row in rows:
        np.testing.assert_allclose(row["checks"]["gfn"]["loss"], float(jout["loss"]), rtol=1e-4)
    got = _ranks_agree_with_single_process(spec["out_dir"], spec, "gfn")
    want = flat(jax.tree.map(np.asarray, jnew.params))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-6, err_msg=k)


def _assert_trees_equal(jtree, ttree, path=""):
    if dataclasses.is_dataclass(jtree):
        for f in dataclasses.fields(jtree):
            _assert_trees_equal(getattr(jtree, f.name), getattr(ttree, f.name), f"{path}.{f.name}")
    elif jtree is None:
        assert ttree is None, path
    else:
        got = ttree.numpy()
        np.testing.assert_array_equal(got, np.asarray(jtree), err_msg=path)
        assert got.dtype == np.asarray(jtree).dtype, path


@pytest.mark.parametrize("id_feed", [False, True])
def test_collate_agent_stacked_matches_jax(id_feed):
    s = agent_setup(count=4)
    kw = dict(entity_emb=s.ds.entity_emb, relation_emb=s.ds.relation_emb, question_emb=s.ds.question_emb,
              id_feed=id_feed)
    bucket = jfeed.fixed_agent_bucket(s.samples, 2)
    want = jfeed.collate_agent_stacked(s.samples, num_shards=2, bucket=bucket, **kw)
    got = tfeed.collate_agent_stacked(s.samples, num_shards=2, bucket=tfeed.Bucket(**dataclasses.asdict(bucket)), **kw)
    assert got.question_emb.shape[0] == 2
    _assert_trees_equal(want, got)
    _assert_trees_equal(jax.tree.map(lambda x: x[1], want), got.shard(1))
    with pytest.raises(ValueError, match="divisible"):
        tfeed.collate_agent_stacked(s.samples[:3], num_shards=2, bucket=tfeed.Bucket(**dataclasses.asdict(bucket)),
                                    **kw)


@pytest.mark.parametrize("id_feed", [False, True])
def test_collate_retriever_with_pairs_matches_jax(id_feed):
    jds = j_synth(num_samples=6, emb_dim=16, max_nodes=12, seed=9)
    samples = jds.samples[:4]
    bucket = jfeed.fixed_bucket_for(samples, 4)
    kw = dict(entity_emb=jds.entity_emb, relation_emb=jds.relation_emb, question_emb=jds.question_emb, id_feed=id_feed)
    jb, jp = jfeed.collate_retriever(samples, bucket=bucket, with_pairs=True, **kw)
    tb, tp = tfeed.collate_retriever(samples, bucket=tfeed.Bucket(**dataclasses.asdict(bucket)), with_pairs=True, **kw)
    _assert_trees_equal(jb, tb)
    _assert_trees_equal(jp, tp)
    assert int(tp.pair_mask.sum()) == sum(x.pair_start_local.shape[0] for x in samples) > 0
    with pytest.raises(ValueError, match="pair bucket overflow"):
        tfeed.collate_retriever(samples, bucket=tfeed.Bucket(bucket.graphs, bucket.nodes, bucket.edges, pairs=1),
                                with_pairs=True, **kw)


def test_two_rank_train_retriever_cli(tmp_path):
    ckpt = tmp_path / "ckpt"
    overrides = [o for o in SMALL_TRAIN_OVERRIDES if not o.startswith(("retriever.train.per_shard_batch",
                                                                       "retriever.train.max_epochs"))]
    argv = lambda r: [sys.executable, "-m", "evi_rag_tpu_torch.cli", "train_retriever", "--configs-dir", CONFIGS,  # noqa: E731
                      *overrides, "retriever.train.max_epochs=2", "retriever.train.num_shards=2",
                      "retriever.train.per_shard_batch=8", "device=cpu", "extras.print_config=false",
                      f"retriever.train.ckpt_dir={ckpt}", f"paths.log_dir={tmp_path / f'logs{r}'}"]
    results = testing_dp.spawn(argv, 2, **RANKS)
    for rc, out, err in results:
        assert rc == 0, err[-4000:]
    assert sorted(p.name for p in ckpt.iterdir()) == ["best", "last"]
    digests = [json.loads(next((tmp_path / f"logs{r}").glob("**/metrics.json")).read_text())["best_ckpt_sha256"]
               for r in range(2)]
    _, meta = load_checkpoint(ckpt / "best")
    assert digests[0] == digests[1] == meta["params_sha256"]
    # Rank-tagged logs: each rank's records carry its rank.
    assert "[rank1]" in results[1][2] and "[rank1]" not in results[0][2]
