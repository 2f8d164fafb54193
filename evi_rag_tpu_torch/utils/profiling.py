"""Tracing and profiling hooks, on ``torch.profiler``.

Counterpart of ``evi_rag_tpu/utils/profiling.py``:

* ``annotate(name)``: a ``torch.profiler.record_function`` range (host and
  device timelines of a trace), plus an NVTX range when the current device
  is CUDA;
* ``trace(log_dir)``: a ``torch.profiler.profile`` of the CPU and, where
  there is one, the CUDA activity, written into ``log_dir`` as a Chrome
  trace (``trace.json``) with the registry's records beside it
  (``spans.json``, below); the context yields the profiler, whose
  ``key_averages()`` sum the events by name;
* ``device_memory_stats(device)``: ``torch.cuda.memory_stats`` with JAX's
  ``bytes_in_use`` / ``peak_bytes_in_use`` keys (current and peak allocated
  bytes); ``{}`` for a device without stats (the CPU), as in JAX.

**The program's spans and counters** (one registry in this module).  The
switch is a running ``torch.profiler`` session: ``enabled()`` is true
exactly while one records (``torch._C._autograd._profiler_enabled()``), and
there is no other.  While it is off, ``span(name)`` returns one shared no-op
context after that single check and ``count`` adds nothing.  While it is
on, a span enters ``annotate(name)`` (so the range sits on the profiler's
clock, beside the device's events) and keeps a record in memory: its name,
start and end (``time.perf_counter_ns``), the index of its parent span
(-1 for none) and the id of the call that holds it (0 for none;
``one_call`` makes each invocation of a function one call; ``spanned(name)``
puts each invocation inside ``span(name)``).  ``totals()`` sums the records
by name (count, seconds, self seconds) and returns the counters;
``reset()`` clears the registry.  The registry is the process's one and
takes no lock: spans and counts come from the thread that drives the
program (the feeder's prefetch thread records none).

An operator traces a run with ``trace(log_dir)``: it resets the registry
when entered and, on exit, writes ``spans.json`` (``{"spans": [records],
"counters": {name: n}}``) beside ``trace.json``.  The names the program
records:

* ``serving.serve_split`` (one call each): spans ``serve.setup``,
  ``serve.warmup``, ``serve.plan``, per window ``serve.pack``,
  ``serve.stage`` and ``serve.drain``, per window and bucket
  ``serve.dispatch``, and ``serve.wait`` around each host wait on the
  card; counters, per route (``kernel``, ``plain``),
  ``serve.edges.<route>`` (real edges) and
  ``serve.slots.<route>`` (edge slots dispatched: group size x m_pad),
  whose ratio is the share of dispatched slots that hold an edge;
* ``ops.score_kernels.per_question_topk``: ``kernel.per_question_topk``
  around its launches (launches stay counted in ``.launches``);
* ``train.retriever_trainer.make_train_step``'s step (one call each):
  ``train.upload``, ``train.forward_backward``, ``train.optimizer``;
* ``ops.segment.sorted_segment_sum``: counter ``segment.sum.chunks``, the
  chunks of each two-pass sum (its static bound, a host int).

Span names are literals and none starts with ``bench.``, the prefix a
benchmark's harness keeps for its own spans.
"""

from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import time
from typing import Any, Callable, Iterator, TypeVar

import torch

F = TypeVar("F", bound=Callable[..., Any])

_profiler_enabled = torch._C._autograd._profiler_enabled


def enabled() -> bool:
    """True exactly while a ``torch.profiler`` session records."""
    return _profiler_enabled()


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


class _Registry:
    def __init__(self) -> None:
        self.spans: list[dict[str, Any]] = []  # name, start_ns, end_ns, parent, call
        self.counters: dict[str, int] = {}
        self.open: list[int] = []              # indices of the spans open now, innermost last
        self.call = 0                          # id of the call open now
        self.calls = 0                         # call ids handed out


REGISTRY = _Registry()


class _NoOp:
    __slots__ = ()

    def __enter__(self) -> None:
        pass

    def __exit__(self, exc_type, exc, tb) -> None:  # named arguments: no tuple packed per span
        pass


_NOOP = _NoOp()


class _Span:
    __slots__ = ("name", "rec", "reg", "index", "ctx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        self.reg = reg = REGISTRY
        self.index = len(reg.spans)
        self.rec = dict(name=self.name, start_ns=0, end_ns=0, parent=reg.open[-1] if reg.open else -1,
                        call=reg.call)
        reg.spans.append(self.rec)
        reg.open.append(self.index)
        self.ctx = annotate(self.name)
        self.ctx.__enter__()
        self.rec["start_ns"] = time.perf_counter_ns()

    def __exit__(self, *exc) -> None:
        self.rec["end_ns"] = time.perf_counter_ns()
        self.ctx.__exit__(*exc)
        if self.reg.open and self.reg.open[-1] == self.index:
            self.reg.open.pop()


def span(name: str):
    """A context that records a span named ``name`` while tracing is on
    (module docstring), else the shared no-op."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name)


def spanned(name: str) -> Callable[[F], F]:
    """A decorator: each invocation of the function inside ``span(name)``."""

    def deco(fn: F) -> F:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper  # type: ignore[return-value]

    return deco


def one_call(fn: F) -> F:
    """``fn`` with the spans of each invocation under one new call id while
    tracing is on."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _profiler_enabled():
            return fn(*args, **kwargs)
        reg = REGISTRY
        outer = reg.call
        reg.calls += 1
        reg.call = reg.calls
        try:
            return fn(*args, **kwargs)
        finally:
            reg.call = outer

    return wrapper  # type: ignore[return-value]


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _profiler_enabled():
        c = REGISTRY.counters
        c[name] = c.get(name, 0) + int(n)


def totals() -> dict[str, Any]:
    """``{"spans": {name: {"count", "s", "self_s"}}, "counters": {name: n}}``
    over the closed spans: self seconds are a span's own less its
    children's."""
    recs = REGISTRY.spans
    child_ns = [0] * len(recs)
    for rec in recs:
        if rec["end_ns"] and rec["parent"] >= 0:
            child_ns[rec["parent"]] += rec["end_ns"] - rec["start_ns"]
    out: dict[str, dict[str, float]] = {}
    for rec, inner in zip(recs, child_ns):
        if not rec["end_ns"]:
            continue
        t = out.setdefault(rec["name"], dict(count=0, s=0.0, self_s=0.0))
        dur = rec["end_ns"] - rec["start_ns"]
        t["count"] += 1
        t["s"] += dur * 1e-9
        t["self_s"] += (dur - inner) * 1e-9
    return dict(spans=out, counters=dict(REGISTRY.counters))


def reset() -> None:
    """Clear the registry's spans, counters and call ids."""
    global REGISTRY
    REGISTRY = _Registry()


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path) -> Iterator[torch.profiler.profile]:
    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    reset()
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    (log_dir / "spans.json").write_text(json.dumps(dict(spans=REGISTRY.spans, counters=REGISTRY.counters)))


def device_memory_stats(device: str | torch.device | None = None) -> dict[str, int]:
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu"))
    if device.type != "cuda":
        return {}
    stats = dict(torch.cuda.memory_stats(device))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak", 0))
    return stats
