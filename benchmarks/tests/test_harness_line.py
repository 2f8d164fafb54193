"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the last line's keys, the registry, the import guard."""

import functools
import json
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmarks import harness
from benchmarks.run import run_cell
from benchmarks.tests import tiny

SEED = 2_200_000_011
LOOSE = {k: 1e9 for k in ("table_err", "score_err", "topk_gap", "index_err", "loss_gap", "grad_gap", "change_gap")}


@pytest.mark.parametrize("workload", ["webqsp.serve", "cwq.pooled", "cwq.train"])
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(workload, trace):
    c = tiny.cell(workload)
    out = json.loads(run_cell(c, workload, SEED, 0.3, bool(trace), torch.device("cpu"), limits=LOOSE,
                              log=lambda *a, **k: None))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == set(harness.limits(workload))
    want = {m["name"] for m in (c["end_to_end"] if not trace else c["per_layer"])}
    if not trace:
        assert set(out["metrics"]) == want and "setup_s" in want
    else:  # no trace on the CPU: only the readers that need none report
        assert set(out["metrics"]) <= want and all(not k.startswith(("idle_frac", "kernel")) for k in out["metrics"])
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]


def test_every_cell_resolves_and_every_metric_has_a_reader():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        c = harness.cell(spec, w["name"])
        assert c["per_layer"] and any(m["name"] == "setup_s" for m in c["end_to_end"]) and len(c["end_to_end"]) >= 2
        assert set(harness.limits(w["name"]))
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_serve_takes_the_engines_options_from_the_program(monkeypatch):
    """The group size and kernel threshold are the program's (``cli serve``'s
    configuration, else ``serve_split``'s defaults): a change there reaches
    every request, and the kernel-3 roofline reads the ones served."""
    import evi_rag_tpu_torch.serving as serving
    import evi_rag_tpu_torch.utils.config as config
    from benchmarks.drivers import serve

    real_load, real_serve = config.load_config, serving.serve_split
    assert serve.engine_options()["group_size"] == real_load(harness.ROOT / "configs", "serve")["serve"]["group_size"]
    monkeypatch.setattr(config, "load_config", lambda *a, **k: {"serve": {"group_size": 8}})
    opts = serve.engine_options()
    assert opts == {"group_size": 8, "fused_threshold": 256}
    seen = []

    @functools.wraps(real_serve)
    def spy(bundle, samples, **kw):
        seen.append((kw["group_size"], kw["fused_threshold"]))
        return real_serve(bundle, samples, **kw)

    monkeypatch.setattr(serving, "serve_split", spy)
    c = tiny.cell("webqsp.serve")
    st = serve.setup(c, SEED, torch.device("cpu"), harness.Spans())
    res = serve.window(st, 0.2, harness.Spans())
    assert set(seen) == {(8, 256)}
    assert res["counters"]["group_size"] == 8 and res["counters"]["fused_threshold"] == 256


def test_new_files_register_without_editing_code(tmp_path, monkeypatch):
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "benchmarks", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    spec = harness.load_spec()
    here = root / "benchmarks"
    (here / "configs" / "webqsp_wide.json").write_text(json.dumps(dict(harness.config("webqsp"), splits={"test": 9})))
    (here / "traffic" / "serve_64.json").write_text(json.dumps(dict(harness.traffic("serve_256"), request=64)))
    (here / "limits" / "webqsp_wide.serve.json").write_text(json.dumps(harness.limits("webqsp.serve")))
    (here / "metrics" / "serve.requests.py").write_text("def read(ctx):\n    return len(ctx['counters']['requests'])\n")
    spec["configs"].append(dict(spec["configs"][0], name="webqsp_wide", file="benchmarks/configs/webqsp_wide.json"))
    spec["workloads"].append(dict(spec["workloads"][0], name="webqsp_wide.serve", config="webqsp_wide",
                                  traffic="serve_64"))
    spec["per_layer"].append(dict(spec["per_layer"][0], name="serve.requests", unit="requests",
                                  workloads=["webqsp_wide.serve"]))
    for m in spec["end_to_end"]:
        if "webqsp.serve" in m.get("workloads", ()):
            m["workloads"].append("webqsp_wide.serve")
    monkeypatch.setattr(harness, "HERE", here)
    c = harness.cell(spec, "webqsp_wide.serve")
    assert c["config"]["splits"] == {"test": 9} and c["traffic"]["request"] == 64
    assert "serve.requests" in {m["name"] for m in c["per_layer"]}
    assert harness.metric_reader("serve.requests")({"counters": {"requests": [[1], [2]]}}) == 2
    assert harness.limits("webqsp_wide.serve") == harness.limits("webqsp.serve")


def test_the_port_does_not_trip_the_import_guard():
    code = ("import benchmarks.run, benchmarks.control, benchmarks.drivers.serve, benchmarks.drivers.pooled, "
            "benchmarks.drivers.train\n"
            "import evi_rag_tpu_torch.serving, evi_rag_tpu_torch.ops.query, evi_rag_tpu_torch.ops.score_kernels\n"
            "import evi_rag_tpu_torch.train.retriever_trainer, evi_rag_tpu_torch.data.feeder\n"
            "from benchmarks import harness\nassert 'evi_rag_tpu_torch' in __import__('sys').modules\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=harness.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmarks.reference.model, benchmarks.reference.train, benchmarks.reference.compare\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('evi_rag_tpu_torch', 'evi_rag_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=harness.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_a_loaded_jax_module_refuses_the_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]
    c = tiny.cell("cwq.pooled")
    assert run_cell(c, "cwq.pooled", SEED, 0.1, False, torch.device("cpu"), limits=LOOSE,
                    log=lambda *a, **k: None) is None


def test_no_card_no_result(monkeypatch, capsys):
    from benchmarks import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cwq.pooled", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_no_program_no_result(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((harness.ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(harness.HERE, tmp_path / "benchmarks", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmarks.run", "--workload", "cwq.pooled", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
