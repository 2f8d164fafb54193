"""Port vs JAX: checkpoints, the weights converter and the ``serve`` task.

A JAX retriever checkpoint (orbax) is re-saved in the port's format; the
digest must be the JAX digest, and the port's ``serve`` task must write the
same metrics keys, the same recall and the same ranked triples as the JAX
task (f32 compute, so rankings are identical).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evi_rag_tpu import cli as jcli
from evi_rag_tpu import serving as jserve
from evi_rag_tpu.data.feeder import Bucket, collate_retriever
from evi_rag_tpu.data.synthetic import make_synthetic_dataset
from evi_rag_tpu.models.retriever import Retriever
from evi_rag_tpu.train import checkpoint as jck
from evi_rag_tpu.utils.config import load_config as j_load_config
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch import serving as tserve
from evi_rag_tpu_torch.train import checkpoint as tck

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
EMB = 64


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_ckpt")
    ds = make_synthetic_dataset(num_samples=2, emb_dim=EMB, max_nodes=10, seed=0)
    batch = collate_retriever(
        ds.samples[:1], entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
        question_emb=ds.question_emb, bucket=Bucket(graphs=2, nodes=32, edges=128),
    )
    model = Retriever(emb_dim=EMB, hidden_dim=EMB, dropout_p=0.0)
    params = jax.jit(model.init)(jax.random.key(0), batch)
    digest = jck.save_checkpoint(tmp / "jax", params, meta={"parity_meta": model.parity_meta()})
    return tmp, params, model, digest


def test_params_digest_matches_jax(jax_ckpt):
    _, params, _, digest = jax_ckpt
    host = jax.tree.map(np.asarray, params)
    assert tck.params_digest(host) == jck.params_digest(host) == digest
    # Torch leaves hash the same bytes.
    as_torch = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), host)
    assert tck.params_digest(as_torch) == digest


def test_convert_save_load_roundtrip(jax_ckpt):
    tmp, _, _, digest = jax_ckpt
    tree, meta = jck.load_checkpoint(tmp / "jax")
    got = tck.save_checkpoint(tmp / "port", tree["params"], meta=meta)
    assert got == digest
    loaded, meta2 = tck.load_checkpoint(tmp / "port")
    assert meta2["params_sha256"] == digest and meta2["schema_version"] == 1
    assert meta2["parity_meta"] == meta["parity_meta"]
    for path, leaf in tck._leaves(loaded["params"]):
        want = tree["params"]
        for p in path:
            want = want[p]
        np.testing.assert_array_equal(leaf, np.asarray(want))
    # A corrupted array fails the digest check.
    with np.load(tmp / "port" / "state.npz") as npz:
        arrays = {k: npz[k].copy() for k in npz.files}
    key = next(iter(arrays))
    arrays[key].flat[0] += 1.0
    bad = tmp / "bad"
    bad.mkdir()
    np.savez(bad / "state.npz", **arrays)
    (bad / "meta.json").write_text((tmp / "port" / "meta.json").read_text())
    with pytest.raises(ValueError, match="digest mismatch"):
        tck.load_checkpoint(bad)


def test_bundle_from_numpy_gives_same_serve_output(jax_ckpt):
    _, params, model, _ = jax_ckpt
    jb = jck.export_retriever_features(params["params"], model.parity_meta())
    host = jax.tree.map(np.asarray, params)
    exported = tck.export_retriever_features(host, model.parity_meta())
    tb = {"features": tck.bundle_from_numpy(exported["features"]), "parity_meta": exported["parity_meta"]}
    assert sorted(tb["features"]) == sorted(tck.RETRIEVER_FEATURE_KEYS)
    ds = make_synthetic_dataset(num_samples=6, emb_dim=EMB, max_nodes=20, seed=2)
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb,
              question_emb=ds.question_emb, k=10, num_rounds=2, num_reverse_rounds=2, group_size=3)
    jres, _ = jserve.serve_split(jb, ds.samples, dtype=jnp.float32, **kw)
    tres, _ = tserve.serve_split(tb, ds.samples, dtype=torch.float32, device="cpu", **kw)
    for rj, rt in zip(jres, tres):
        np.testing.assert_array_equal(rt.edge_ids, rj.edge_ids)
        np.testing.assert_allclose(rt.scores, rj.scores, rtol=1e-4, atol=1e-5)


def test_serve_task_matches_jax_task(jax_ckpt):
    tmp, _, _, _ = jax_ckpt
    tree, meta = jck.load_checkpoint(tmp / "jax")
    tck.save_checkpoint(tmp / "port_cli", tree["params"], meta=meta)
    common = ["serve.splits=[validation]", "serve.k=20", "serve.k_values=[1, 10, 20]",
              "serve.compute_dtype=float32", "dataset.num_samples=8", "dataset.max_nodes=16"]

    jcfg = j_load_config(CONFIGS, "serve", common + [f"retriever.ckpt={tmp / 'jax'}"])
    jcfg["task_name"] = "serve"
    jrun = tmp / "jax_run"
    jrun.mkdir()
    jm = jcli.task_serve.__wrapped__(jcfg, run_dir=jrun)

    logs = tmp / "port_logs"
    assert tcli.main(["serve", "--configs-dir", CONFIGS, *common, "device=cpu",
                      f"retriever.ckpt={tmp / 'port_cli'}", f"paths.log_dir={logs}"]) == 0
    (tmetrics,) = logs.glob("**/metrics.json")
    trun = tmetrics.parent
    tm = json.loads(tmetrics.read_text())

    assert set(tm) == set(jm)
    for key in ("validation/serve/recall@1", "validation/serve/recall@10",
                "validation/serve/recall@20", "validation/num_questions"):
        assert tm[key] == jm[key], key
    for name in ("validation_serve.jsonl", "validation.manifest.json"):
        assert (trun / name).exists()
    man_t = json.loads((trun / "validation.manifest.json").read_text())
    man_j = json.loads((jrun / "validation.manifest.json").read_text())
    assert set(man_t) == set(man_j) and man_t["artifact"] == man_j["artifact"] == "serve_topk"
    rows = lambda d: {r["sample_id"]: r for r in map(json.loads, (d / "validation_serve.jsonl").read_text().splitlines())}
    rt, rj = rows(trun), rows(jrun)
    assert rt.keys() == rj.keys()
    for sid in rj:
        assert rt[sid]["triples"] == rj[sid]["triples"], sid
        np.testing.assert_allclose(rt[sid]["scores"], rj[sid]["scores"], rtol=1e-4, atol=2e-5)
