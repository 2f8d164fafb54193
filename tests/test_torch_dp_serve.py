"""Port vs JAX: data-parallel serving (``serve_split(mesh=...)``).

* ``tests/test_serving_parity.py::test_serve_split_dp_odd_group_size_and_counts``
  ported: a group size (5) that is not a multiple of the device count (8:
  rounded up) and 11 questions (a partial trailing group, padded with empty
  questions).  The port over ``["cpu"] * 8`` against JAX over
  ``make_mesh(8)`` at f32: every question returned, equal id sets,
  ``num_questions`` equal.
* The kernel route under a mesh: bf16 buckets from ``fused_threshold`` up go
  to ``fused_fn`` on every mesh entry with the entry's share of the group's
  questions, and the results equal the single-device serve bit for bit
  (kernel 3's plain version on the CPU).  JAX keeps its XLA scorer under a
  mesh (a ``pallas_call`` does not partition itself); the port does not
  need to.
* ``serve.data_parallel=true`` through the port's CLI.
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from evi_rag_tpu.data.feeder import Bucket, collate_retriever
from evi_rag_tpu.data.synthetic import make_synthetic_dataset
from evi_rag_tpu.models.retriever import Retriever
from evi_rag_tpu.parallel.mesh import make_mesh as j_make_mesh
from evi_rag_tpu.serving import serve_split as j_serve_split
from evi_rag_tpu.train.checkpoint import export_retriever_features
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.parallel.mesh import make_mesh
from evi_rag_tpu_torch.serving import serve_split
from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, save_checkpoint

EMB = 64
CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")


@pytest.fixture(scope="module")
def setup():
    ds = make_synthetic_dataset(num_samples=11, emb_dim=EMB, max_nodes=14, seed=23)
    model = Retriever(emb_dim=EMB, hidden_dim=EMB, dropout_p=0.0)
    b0 = collate_retriever(ds.samples[:1], entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
                           question_emb=ds.question_emb, bucket=Bucket(graphs=2, nodes=64, edges=256))
    params = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.key(5), b0))
    bundle = export_retriever_features(params["params"], model.parity_meta())
    tb = {"features": bundle_from_numpy(bundle["features"], device="cpu")}
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb, k=8,
              num_rounds=2, num_reverse_rounds=2)
    return dict(ds=ds, params=params, bundle=bundle, tb=tb, kw=kw)


def test_serve_split_dp_odd_group_size_and_counts(setup):
    import jax.numpy as jnp

    s = setup
    samples = s["ds"].samples
    j1, _ = j_serve_split(s["bundle"], samples, group_size=5, dtype=jnp.float32, **s["kw"])
    jdp, jstats = j_serve_split(s["bundle"], samples, group_size=5, mesh=j_make_mesh(8), dtype=jnp.float32, **s["kw"])
    tdp, tstats = serve_split(s["tb"], samples, group_size=5, mesh=make_mesh(devices=["cpu"] * 8),
                              dtype=torch.float32, **s["kw"])
    assert tstats.num_questions == jstats.num_questions == len(samples) == len(tdp)
    assert tstats.num_groups == jstats.num_groups == 2  # groups of 8 (5 rounded up), the last one partial
    by_id = {r.sample_id: r for r in tdp}
    for ref in (j1, jdp):
        for r in ref:
            got = by_id[r.sample_id]
            assert set(got.edge_ids.tolist()) == set(r.edge_ids.tolist()), r.sample_id
            np.testing.assert_allclose(np.sort(got.scores), np.sort(r.scores), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("entries", [1, 2, 4])
def test_kernel_route_runs_on_every_mesh_entry(setup, entries):
    s = setup
    samples = s["ds"].samples
    calls = []

    def spy(bundle, q, h, *args, **kw):
        calls.append((q.shape[0], h.device))
        return sk.per_question_topk(bundle, q, h, *args, **kw)

    kw = dict(group_size=4, dtype=torch.bfloat16, fused_threshold=8, **s["kw"])
    single, _ = serve_split(s["tb"], samples, device="cpu", **kw)
    dp, stats = serve_split(s["tb"], samples, mesh=make_mesh(devices=["cpu"] * entries), fused_fn=spy, **kw)
    # Every group runs once on every entry, each entry with its share of the group.
    assert len(calls) == stats.num_groups * entries and {c[0] for c in calls} == {4 // entries}
    for a, b in zip(single, dp):
        assert a.sample_id == b.sample_id
        np.testing.assert_array_equal(a.edge_ids, b.edge_ids)
        np.testing.assert_array_equal(a.scores, b.scores)


def test_serve_cli_data_parallel(setup, tmp_path):
    s = setup
    save_checkpoint(tmp_path / "ckpt", s["params"], meta={"parity_meta": {"dde_rounds": 2, "dde_reverse_rounds": 2}})
    common = ["serve", "--configs-dir", CONFIGS, f"retriever.ckpt={tmp_path / 'ckpt'}", "serve.splits=[validation]",
              "serve.k=8", "serve.k_values=[1,8]", "dataset.num_samples=11", f"dataset.emb_dim={EMB}",
              "dataset.max_nodes=14", "device=cpu", "serve.fused_threshold=8"]
    out = {}
    for dp in ("false", "true"):
        assert tcli.main([*common, f"serve.data_parallel={dp}", f"paths.log_dir={tmp_path / dp}"]) == 0
        (m,) = (tmp_path / dp).glob("**/metrics.json")
        out[dp] = json.loads(m.read_text())
    for key in ("validation/num_questions", "validation/serve/recall@1", "validation/serve/recall@8"):
        assert out["true"][key] == out["false"][key], key
