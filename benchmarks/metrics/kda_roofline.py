"""The KDA recurrence kernel's share of its roofline: the least time of the
window's recurrence work (``kimi_counts.kda_bound_s``, from the program's
``kda.*`` counters: prefill and decode each bounded by bytes or operations)
over the device time of the kernels named ``kda_*`` in the trace, in %.
None where the trace holds no such kernel or the program counts no KDA
work."""

from benchmarks import kimi_counts, program_spans
from benchmarks.drivers.reason_kimi import model_config

KERNEL = "kda_"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    busy = sum(v for k, v in tr["device_s"].items() if k.startswith(KERNEL) or f" {KERNEL}" in k)
    tot = program_spans.totals()
    c = tot["counters"] if tot is not None else {}
    if busy <= 0 or not (c.get("kda.tokens.prefill") or c.get("kda.tokens.decode")):
        return None
    return 100.0 * kimi_counts.kda_bound_s(model_config(ctx["config"]), c) / busy
