"""The port's registry and profiling hooks.

* ``Registry``: the JAX package's behaviour (register, duplicate and
  unknown names, sorted names), side by side with it.
* ``annotate``: a ``record_function`` range that a profiler trace shows.
* ``trace``: writes a Chrome trace on the CPU and yields the profiler.
* ``device_memory_stats``: ``{}`` for the CPU, as JAX gives for a device
  without stats.
"""

import json

import pytest
import torch

from evi_rag_tpu.utils.registry import Registry as JRegistry
from evi_rag_tpu_torch.utils.profiling import annotate, device_memory_stats, trace
from evi_rag_tpu_torch.utils.registry import Registry as TRegistry


@pytest.mark.parametrize("registry", [JRegistry, TRegistry], ids=["jax", "port"])
def test_registry(registry):
    reg = registry("model")

    @reg.register("b")
    def make_b():
        return "b"

    reg.register("a")(len)
    assert reg.get("b") is make_b and reg.get("a") is len and reg.names() == ["a", "b"]
    with pytest.raises(KeyError, match="already registered"):
        reg.register("a")(str)
    with pytest.raises(KeyError, match=r"unknown model 'c'; available: \['a', 'b'\]"):
        reg.get("c")


def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    with trace(tmp_path / "prof") as prof:
        with annotate("port_span"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    path = tmp_path / "prof" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    assert any(e.key == "port_span" for e in prof.key_averages())


def test_annotate_outside_a_trace_and_memory_stats_on_cpu():
    with annotate("alone"):
        y = torch.ones(3) * 2
    assert float(y.sum()) == 6.0
    assert device_memory_stats("cpu") == {}
