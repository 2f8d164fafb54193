"""Port vs JAX: the hyperparameter sweep.

* ``sample_space``, ``grid_points`` and ``tpe_suggest`` give the same
  points as JAX's for the same seed and history (numpy's
  ``default_rng(seed)`` in both).
* ``run_sweep`` on a plain Python objective (a failing trial included)
  writes the same ``sweep.json``, tracebacks aside.
* ``task_sweep`` at the small CPU setting: the same trial overrides as
  JAX's, every trial ``ok`` with its checkpoint under ``trial_<i>/ckpt``.
  Scores are not compared: the two packages' inits draw other numbers.
* Without a GPU and without ``device=cpu`` every trial fails with the
  port's "no CUDA device" error and the sweep records it.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from evi_rag_tpu import cli as jcli
from evi_rag_tpu.train import sweep as jsweep
from evi_rag_tpu_torch import cli as tcli
from evi_rag_tpu_torch.train import sweep as tsweep
from evi_rag_tpu_torch.utils.config import ConfigError

CONFIGS = str(pathlib.Path(__file__).resolve().parents[1] / "configs")
SPACE = {
    "a.lr": {"dist": "loguniform", "low": 1e-5, "high": 1e-1},
    "b.dim": {"dist": "choice", "values": [16, 32, 64]},
    "c.t": {"dist": "uniform", "low": 0.5, "high": 2.0},
    "d.n": {"dist": "int_uniform", "low": 1, "high": 4},
}


def test_sample_space_and_grid_match_jax():
    for seed in (0, 1, 7):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(10):
            assert tsweep.sample_space(SPACE, tr) == jsweep.sample_space(SPACE, jr)
    grid = {"x": {"dist": "choice", "values": [1, 2]}, "y": {"values": ["a", "b", "c"]}}
    assert tsweep.grid_points(grid) == jsweep.grid_points(grid) and len(tsweep.grid_points(grid)) == 6
    with pytest.raises(ValueError, match="choice"):
        tsweep.grid_points({"x": {"dist": "uniform", "low": 0, "high": 1}})
    with pytest.raises(ValueError, match="unknown dist"):
        tsweep.sample_space({"x": {"dist": "beta"}}, np.random.default_rng(0))


def test_tpe_suggest_matches_jax():
    rng = np.random.default_rng(3)
    history = []
    for i in range(12):
        point = jsweep.sample_space(SPACE, rng)
        history.append({"overrides": point, "score": float(rng.normal()), "status": "error" if i == 4 else "ok"})
    for mode in ("max", "min"):
        for n in (3, 8, 12):  # below and above the startup phase
            jr, tr = np.random.default_rng(11), np.random.default_rng(11)
            want = jsweep.tpe_suggest(SPACE, history[:n], jr, mode=mode)
            got = tsweep.tpe_suggest(SPACE, history[:n], tr, mode=mode)
            assert got == want
            assert jr.random() == tr.random()  # the same number of draws


def _objective(cfg):
    lr, c = cfg["a"]["lr"], cfg["b"]["dim"]
    if c == 64 and lr > 1e-2:
        raise RuntimeError("boom")
    return {"score": -(np.log10(lr) + 3) ** 2 + c / 64, "aux": 1.0}


@pytest.mark.parametrize("strategy", ["random", "tpe", "grid"])
def test_run_sweep_writes_what_jax_writes(tmp_path, strategy):
    space = SPACE if strategy != "grid" else {"a.lr": {"values": [1e-4, 1e-3, 5e-2]}, "b.dim": {"values": [32, 64]}}
    out = {}
    for name, mod in (("jax", jsweep), ("port", tsweep)):
        res = mod.run_sweep({"a": {}, "keep": 1}, space, _objective, monitor="score", mode="max",
                            strategy=strategy, num_trials=9, seed=5, out_path=tmp_path / f"{name}.json")
        doc = json.loads((tmp_path / f"{name}.json").read_text())
        assert doc == json.loads(json.dumps(res, default=str))
        for t in doc["trials"]:
            t.pop("traceback", None)  # file paths differ
        out[name] = doc
    assert out["port"] == out["jax"]
    statuses = [t["status"] for t in out["port"]["trials"]]
    assert "ok" in statuses and out["port"]["best"]["status"] == "ok"
    if strategy == "grid":
        assert statuses.count("error") == 1 and len(statuses) == 6


def _sweep_args(run_log, extra=()):
    return ["sweep", "--configs-dir", CONFIGS, "experiment=quick_synthetic", "sweep.num_trials=2",
            "retriever.train.max_epochs=1", "dataset.num_samples=8", "sweep.monitor=edge/recall@5",
            "extras.print_config=false",
            f"paths.log_dir={run_log}", *extra]


def _sweep_doc(log_dir):
    (path,) = sorted(pathlib.Path(log_dir).glob("**/runs/*/sweep.json"))
    return json.loads(path.read_text()), path.parent


def test_task_sweep_matches_jax_trial_overrides(tmp_path):
    assert jcli.main(_sweep_args(tmp_path / "jax")) == 0
    assert tcli.main(_sweep_args(tmp_path / "port", ["device=cpu"])) == 0
    jdoc, _ = _sweep_doc(tmp_path / "jax")
    tdoc, run_dir = _sweep_doc(tmp_path / "port")
    assert [t["overrides"] for t in tdoc["trials"]] == [t["overrides"] for t in jdoc["trials"]]
    assert [t["status"] for t in tdoc["trials"]] == ["ok", "ok"] == [t["status"] for t in jdoc["trials"]]
    for i, t in enumerate(tdoc["trials"]):
        assert np.isfinite(t["score"]) and t["score"] == t["metrics"]["edge/recall@5"]
        assert (run_dir / f"trial_{i}" / "ckpt" / "best" / "meta.json").exists()
    best = max(tdoc["trials"], key=lambda t: t["score"])
    assert tdoc["best"]["trial"] == best["trial"]
    metrics = json.loads((run_dir / "metrics.json").read_text())
    assert metrics == {"best_score": best["score"], "num_trials": 2}


def test_task_sweep_records_failed_trials(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = {"dataset": {"source": "synthetic", "num_samples": 4, "emb_dim": 8, "max_nodes": 6},
            "sweep": {"space": {"retriever.train.optimizer.learning_rate": {"values": [1e-3]}}, "num_trials": 1}}
    res = tcli.task_sweep.__wrapped__(base, run_dir=tmp_path / "a")
    doc = json.loads((tmp_path / "a" / "sweep.json").read_text())
    assert res == {"best_score": None, "num_trials": 1}
    assert doc["trials"][0]["status"] == "error" and "no CUDA device" in doc["trials"][0]["error"]
    # The gflownet objective reaches its own retriever.ckpt check.
    base["sweep"].update(task="train_gflownet", monitor="best_score")
    assert tcli.task_sweep.__wrapped__({**base, "device": "cpu"}, run_dir=tmp_path / "b")["best_score"] is None
    with pytest.raises(ConfigError, match="sweep.task"):
        tcli.task_sweep.__wrapped__({**base, "sweep": {**base["sweep"], "task": "nope"}}, run_dir=tmp_path / "c")
    with pytest.raises(ConfigError, match="sweep.space"):
        tcli.task_sweep.__wrapped__({"sweep": {}}, run_dir=tmp_path / "d")
