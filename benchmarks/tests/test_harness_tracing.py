"""The per-layer metrics that read the program's own spans and counters
(``evi_rag_tpu_torch.utils.profiling``): each reader on a registry filled
by hand, on an empty one, and on a program without the registry; then
the tiny cells traced on the CPU."""

import json

import pytest
import torch

from benchmarks import harness
from benchmarks.run import run_cell
from benchmarks.tests import tiny
from evi_rag_tpu_torch.utils import profiling

SEED = 2_200_000_017
LOOSE = {k: 1e9 for k in ("table_err", "score_err", "topk_gap", "index_err", "loss_gap", "grad_gap", "change_gap")}


@pytest.fixture(autouse=True)
def _clean_registry():
    profiling.reset()
    yield
    profiling.reset()


def _span(name, start_ms, end_ms, parent=-1, call=1):
    profiling.REGISTRY.spans.append(dict(name=name, start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6),
                                         parent=parent, call=call))


def _fill():
    """Two serve calls and three train steps, as the program records them."""
    _span("serve.setup", 0, 4)
    _span("serve.wait", 3, 4, parent=0)
    _span("serve.warmup", 4, 6)
    _span("serve.pack", 6, 20)
    _span("serve.setup", 100, 103, call=2)
    _span("serve.pack", 103, 130, call=2)
    for i, up in enumerate((5.0, 7.0, 9.0)):
        _span("train.upload", 1000 * i, 1000 * i + up, call=3 + i)
        _span("train.forward_backward", 1000 * i + up, 1000 * i + 500, call=3 + i)
    profiling.REGISTRY.counters.update({
        "serve.edges.kernel": 300_000, "serve.edges.plain": 1_000,
        "serve.slots.kernel": 30 * 16 * 1024, "serve.slots.plain": 2 * 16 * 128})


def _ctx(request_s=0.2):
    return dict(spans={"request": [2, request_s]}, counters={}, trace=None, window_s=1.0, config={}, traffic={})


def test_readers_on_a_registry_filled_by_hand():
    _fill()
    assert harness.metric_reader("serve.setup_frac")(_ctx()) == pytest.approx((0.004 + 0.002 + 0.003) / 0.2)
    assert harness.metric_reader("serve.slot_frac")(_ctx()) == pytest.approx(
        301_000 / (30 * 16 * 1024 + 2 * 16 * 128))
    assert harness.metric_reader("train.upload_ms")(_ctx()) == pytest.approx(7.0)


@pytest.mark.parametrize("name", ["serve.setup_frac", "serve.slot_frac", "train.upload_ms"])
def test_readers_give_none_on_an_empty_registry(name):
    assert harness.metric_reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", ["serve.setup_frac", "serve.slot_frac", "train.upload_ms"])
def test_readers_give_none_without_the_programs_registry(name, monkeypatch):
    _fill()
    monkeypatch.delattr(profiling, "totals")  # a program from before the registry
    assert harness.metric_reader(name)(_ctx()) is None


def test_setup_frac_needs_the_harness_request_span():
    _fill()
    assert harness.metric_reader("serve.setup_frac")(dict(_ctx(), spans={})) is None


@pytest.mark.parametrize("workload,names", [("webqsp.serve", ("serve.setup_frac", "serve.slot_frac")),
                                            ("cwq.train", ("train.upload_ms",))])
def test_a_traced_tiny_run_reports_the_programs_metrics(workload, names):
    out = json.loads(run_cell(tiny.cell(workload), workload, SEED, 0.3, True, torch.device("cpu"), limits=LOOSE,
                              log=lambda *a, **k: None))
    got = {n: out["metrics"][n]["value"] for n in names}
    for n, v in got.items():
        assert v > 0 and (v < 1 if n.endswith("_frac") else v < 1e4), (n, v)
