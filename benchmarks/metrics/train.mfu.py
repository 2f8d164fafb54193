"""The training step's share of the card's bf16 peak: 3 x the forward's
matrix FLOP on the window's real edges, nodes and graphs
(``counts.train_flops``) over the window, in %."""

from benchmarks import counts
from benchmarks.drivers.common import model_dims


def read(ctx):
    c = ctx["counters"]
    d, h, _, _ = model_dims(ctx["config"])
    flops = counts.train_flops(c["real_edges"], c["real_nodes"], c["graphs"], d, h)
    return 100.0 * flops / ctx["window_s"] / counts.PEAK_BF16_FLOPS
