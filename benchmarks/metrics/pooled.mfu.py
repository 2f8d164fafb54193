"""The pooled engine's share of the card's bf16 peak: every call's matrix
FLOP by the model's work (``counts.pooled_flops``, whatever the kernel's
tiling) over the window, in %."""

from benchmarks import counts
from benchmarks.drivers.common import model_dims


def read(ctx):
    c = ctx["counters"]
    d, h, _, _ = model_dims(ctx["config"])
    flops = c["calls"] * counts.pooled_flops(c["queries"], c["candidates"], d, h)
    return 100.0 * flops / ctx["window_s"] / counts.PEAK_BF16_FLOPS
