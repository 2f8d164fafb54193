"""The Kimi-Linear cell's share of the card's bf16 peak: the model FLOP of
the traced window's tokens by the published form and the held share of
the experts (``kimi_counts.flops``, from the program's ``reason.*``,
``moe.*`` and ``kda.*`` counters) over the window, in %.  None where the
program counts no reasoner tokens."""

from benchmarks import counts, kimi_counts, program_spans
from benchmarks.drivers.reason_kimi import model_config


def read(ctx):
    tot = program_spans.totals()
    c = tot["counters"] if tot is not None else {}
    if not c.get("reason.tokens.prefill") or not ctx["window_s"]:
        return None
    return 100.0 * kimi_counts.flops(model_config(ctx["config"]), c) / ctx["window_s"] / counts.PEAK_BF16_FLOPS
