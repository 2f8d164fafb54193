"""Run one cell of the benchmark once.

    python3 -m benchmarks.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for:
makes the cell's inputs from the seed, sets the program up (timed as
``setup_s``), measures for ``--seconds``, compares what the window produced
with the plain reference, and prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks``: each number compared with its
limit).  ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics from a profiled window of at most ``TRACE_SECONDS``
(a host-bound window of tens of seconds holds millions of trace events).
A ``[conditions]`` line on standard error records what paced the window
(``harness.conditions_over``).  Exits non-zero, printing no result, without
the cards, without the program, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

from benchmarks import harness

CACHE = harness.HERE / ".cache"
TRACE_SECONDS = 10.0


def _env() -> None:
    # Build caches at fixed paths inside the checkout; no library may load JAX.
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["USE_TF"] = "0"


def run_cell(c: dict, name: str, seed: int, seconds: float, trace: bool, device, *,
             limits: dict | None = None, log=print) -> str | None:
    """One run of cell ``c`` (``harness.cell``) on ``device``: the result
    line, or None when a forbidden module was loaded."""
    import torch

    drv = harness.driver(c["traffic"]["kind"])
    spans = harness.Spans(traced=trace)
    on_cuda = device.type == "cuda"
    t0 = time.perf_counter()
    if on_cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context exists before its memory record is reset
        torch.cuda.reset_peak_memory_stats(device)
    st = drv.setup(c, seed, device, spans)
    if on_cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    log(f"[bench] {name} seed {seed}: set-up {setup_s:.3f} s", file=sys.stderr)
    traced: dict = {}
    before = harness.conditions(on_cuda)
    with harness.traced(trace, traced):
        with spans("window"):
            res = drv.window(st, min(seconds, TRACE_SECONDS) if trace else seconds, spans)
    log(f"[conditions] {harness.conditions_over(before, harness.conditions(on_cuda))}", file=sys.stderr)
    peak = int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0
    drv.finish(st)
    t1 = time.perf_counter()
    got = drv.readings(st)
    log(f"[bench] comparison with the reference {time.perf_counter() - t1:.3f} s", file=sys.stderr)
    lim = limits if limits is not None else harness.limits(name)
    checks = {k: (float(v), float(lim[k])) for k, v in got.items()}
    correct = all(math.isfinite(v) and v <= b for v, b in checks.values())

    units = {m["name"]: m["unit"] for m in c["end_to_end"] + c["per_layer"]}
    dev = dict(platform="gpu" if on_cuda else "cpu",
               kind=torch.cuda.get_device_name(device) if on_cuda else "cpu",
               count=int(c["entry"]["chips"]), memory_peak_bytes=peak)
    metrics: dict = {}
    breakdown = None
    if not trace:
        values = dict(res["metrics"], setup_s=setup_s)
        for m in c["end_to_end"]:
            metrics[m["name"]] = dict(value=float(values[m["name"]]), unit=m["unit"])
    else:
        tr = traced.get("trace")
        ctx = dict(config=c["config"], traffic=c["traffic"], counters=res["counters"], window_s=res["window_s"],
                   spans=spans.totals, trace=tr)
        for m in c["per_layer"]:
            v = harness.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=units[m["name"]])
        if tr is not None:
            dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
            breakdown = tr["breakdown"]
    bad = harness.forbidden_modules()
    if bad:
        log(f"[bench] refused: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return None
    for k, (v, b) in checks.items():
        log(f"[check] {k} {v!r} limit {b!r} {'ok' if math.isfinite(v) and v <= b else 'FAIL'}", file=sys.stderr)
    return harness.result_line(correct=correct, attempted=res["attempted"], failed=res["failed"], metrics=metrics,
                               device=dev, checks=checks, breakdown=breakdown)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    try:
        import evi_rag_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"[bench] the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    import torch

    c = harness.cell(harness.load_spec(), args.workload)
    chips = int(c["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    print(f"[bench] card {harness.card_record()}; torch {torch.__version__} cuda {torch.version.cuda}",
          file=sys.stderr)
    line = run_cell(c, args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    if line is None:
        return 3
    sys.stdout.flush()
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
