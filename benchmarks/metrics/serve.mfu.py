"""The serve path's share of the card's bf16 peak: the model's matrix FLOP
on the window's real edges (``counts.serve_flops``, the same whichever
scorer served a bucket) over the window, in %."""

from benchmarks import counts
from benchmarks.drivers.common import model_dims


def read(ctx):
    c = ctx["counters"]
    d, h, s, _ = model_dims(ctx["config"])
    flops = counts.serve_flops(c["real_edges"], c["questions"], d, h, s)
    return 100.0 * flops / ctx["window_s"] / counts.PEAK_BF16_FLOPS
