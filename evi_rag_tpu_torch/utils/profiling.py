"""Tracing and profiling hooks, on ``torch.profiler``.

Counterpart of ``evi_rag_tpu/utils/profiling.py``:

* ``annotate(name)``: a ``torch.profiler.record_function`` range (host and
  device timelines of a trace), plus an NVTX range when the current device
  is CUDA;
* ``trace(log_dir)``: a ``torch.profiler.profile`` of the CPU and, where
  there is one, the CUDA activity, written into ``log_dir`` as a Chrome
  trace (``trace.json``); the context yields the profiler, whose
  ``key_averages()`` sum the events by name;
* ``device_memory_stats(device)``: ``torch.cuda.memory_stats`` with JAX's
  ``bytes_in_use`` / ``peak_bytes_in_use`` keys (current and peak allocated
  bytes); ``{}`` for a device without stats (the CPU), as in JAX.
"""

from __future__ import annotations

import contextlib
import pathlib
from typing import Iterator

import torch


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path) -> Iterator[torch.profiler.profile]:
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def device_memory_stats(device: str | torch.device | None = None) -> dict[str, int]:
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    return stats
