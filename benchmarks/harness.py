"""The benchmark's registry, device record, spans, trace reduction and result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell, its configuration (``configs/<name>.json``) and
its traffic mix (``traffic/<name>.json``); the mix's ``kind`` names the
driver (``drivers/<kind>.py``); the cell's limits on its comparison with the
reference are ``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py`` (a function ``read(ctx)`` that returns a number, or
None when the run has nothing for it to read).  Adding a configuration, a
mix of an existing kind, a cell or a metric adds files and edits none.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import importlib.util
import json
import math
import pathlib
import resource
import subprocess
import sys
import time
from typing import Any

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "evi_rag_tpu")  # top-level module names no run may load


def load_spec(root: pathlib.Path = ROOT) -> dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict[str, Any]:
    path = HERE / kind / f"{name}.json"
    if not path.exists():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} ({path})")
    return json.loads(path.read_text())


def config(name: str) -> dict[str, Any]:
    return _json("configs", name)


def traffic(name: str) -> dict[str, Any]:
    return _json("traffic", name)


def limits(workload: str) -> dict[str, float]:
    return _json("limits", workload)


def driver(kind: str):
    return importlib.import_module(f"benchmarks.drivers.{kind}")


def metric_reader(name: str):
    """The ``read(ctx)`` of ``metrics/<name>.py`` (names may hold dots, so
    the file is loaded by path)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmarks_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell(spec: dict[str, Any], workload: str) -> dict[str, Any]:
    """The workload entry with its configuration, traffic and metrics resolved."""
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    w = entries[workload]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if m["moves"] in reported and mine(m)]
    return dict(entry=w, config=config(w["config"]), traffic=traffic(w["traffic"]),
                end_to_end=e2e, per_layer=per_layer)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN`` (compared
    whole: ``evi_rag_tpu_torch`` is not ``evi_rag_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def _smi(query: str, units: bool = True) -> list[str]:
    """The first card's fields of an nvidia-smi query; empty when unread."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return []
    return [x.strip() for x in out.stdout.splitlines()[0].split(",")] if out.returncode == 0 and out.stdout else []


def card_record() -> str:
    """``name, power limit`` of the first card as nvidia-smi reads it."""
    return ", ".join(_smi("name,power.limit")) or "unread"


def conditions(card: bool) -> dict[str, Any]:
    """A snapshot of what paces a window: the card's SM clock, power draw and
    temperature (nvidia-smi, with ``card``) and this process's CPU seconds."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    snap: dict[str, Any] = dict(t=time.perf_counter(), cpu_s=ru.ru_utime + ru.ru_stime)
    if card:
        fields = _smi("clocks.sm,power.draw,temperature.gpu", units=False)
        snap["card"] = dict(zip(("sm_mhz", "power_w", "temp_c"), fields))
    return snap


def conditions_over(a: dict[str, Any], b: dict[str, Any]) -> str:
    """One line on the window between snapshots ``a`` and ``b``: the card's
    readings before and after, and the cores' worth of CPU time this process
    took (the host's own load counters read nothing inside a sandbox)."""
    parts = [f"{key} {a['card'][key]}->{b['card'][key]}" for key in ("sm_mhz", "power_w", "temp_c")
             if key in a.get("card", {}) and key in b.get("card", {})]
    parts.append(f"proc_cpu {(b['cpu_s'] - a['cpu_s']) / max(b['t'] - a['t'], 1e-9):.4f}")
    return " ".join(parts)


class Spans:
    """Host spans of the harness around its calls into the program: count
    and total seconds by name; under a trace each span is also a
    ``record_function`` range named ``bench.<name>``."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.totals: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = None
        if self.traced:
            import torch

            rf = torch.profiler.record_function(f"bench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)
            c = self.totals.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += dt


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, f"{what}_us")() * 1000)


def reduce_trace(prof) -> dict[str, Any] | None:
    """Device busy time, the traced window, device seconds by operation name
    and idle seconds by what the host was doing, from a finished
    ``torch.profiler.profile``.  The window is the ``bench.window`` span;
    an idle gap is labelled by the innermost harness span around its start
    and the outermost program operation running on the host then.  None
    when the trace holds no device operation."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    device, spans, ops = [], [], []
    for ev in raw:
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not annotation and not name.startswith("bench."):  # a span's copy on the device timeline
                device.append((start, start + dur, name))
        elif name.startswith("bench."):
            spans.append((start, start + dur, name[len("bench."):]))
        elif not name.startswith("cuda") and dur > 0:
            ops.append((start, start + dur, name))
    window = [s for s in spans if s[2] == "window"]
    if not device or not window:
        return None
    w0, w1 = window[0][0], window[0][1]
    by_name: dict[str, float] = {}
    intervals = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
        intervals.append((a, b))
    intervals.sort()
    busy, gaps = 0, []
    cur_a, cur_b = None, None
    prev_end = w0
    for a, b in intervals:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
            if a > prev_end:
                gaps.append((prev_end, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
        prev_end = max(prev_end, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    if w1 > prev_end:
        gaps.append((prev_end, w1))

    inner = sorted((s for s in spans if s[2] != "window"), key=lambda s: s[0])
    inner_starts = [s[0] for s in inner]
    ops.sort(key=lambda s: s[0])
    op_starts = [s[0] for s in ops]

    def label(t: int) -> str:
        span = "harness"
        i = bisect.bisect_right(inner_starts, t) - 1
        best = None
        for j in range(i, max(i - 8, -1), -1):  # spans nest a few deep at most
            a, b, name = inner[j]
            if a <= t < b and (best is None or b - a < best[0]):
                best = (b - a, name)
        if best is not None:
            span = best[1]
        op = None
        k = bisect.bisect_right(op_starts, t) - 1
        for j in range(k, max(k - 64, -1), -1):  # the outermost op that holds t
            a, b, name = ops[j]
            if a <= t < b:
                op = name
        return f"{span}/{op}" if op else span

    idle: dict[str, float] = {}
    for a, b in gaps:
        key = label(a)
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9, device_s=by_name,
                breakdown=dict(device_ops=top(by_name), idle_gaps=top(idle)))


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the block (CPU and CUDA activity) when ``enabled``; the
    reduced trace lands in ``out["trace"]``."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    out["trace"] = reduce_trace(prof)


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown: dict | None = None) -> str:
    """The run's last line: the contract's keys, ``checks`` (each number
    compared, with its limit) last."""
    out: dict[str, Any] = dict(correct=bool(correct), attempted=int(attempted), failed=int(failed),
                               metrics=metrics, device=device)
    if breakdown is not None:
        out["breakdown"] = breakdown
    num = lambda x: x if math.isfinite(x) else repr(x)  # noqa: E731  (JSON has no infinity)
    out["checks"] = {k: {"value": num(v), "limit": num(lim)} for k, (v, lim) in checks.items()}
    return json.dumps(out)
