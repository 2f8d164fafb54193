"""The Kimi-Linear decode steps' share of the card's memory roofline: the
bytes the traced window's decode steps must move (``kimi_counts.
decode_bytes``: the held experts each step touched, every step's other
weights, the latent rows read, the KDA and conv states read and written)
over the program's ``reason.decode`` span seconds and 3.35 TB/s, in %.
None where the program records no decode span."""

from benchmarks import counts, kimi_counts, program_spans
from benchmarks.drivers.reason_kimi import model_config


def read(ctx):
    tot = program_spans.totals()
    span = tot["spans"].get("reason.decode") if tot is not None else None
    if not span or not span["count"] or span["s"] <= 0:
        return None
    moved = kimi_counts.decode_bytes(model_config(ctx["config"]), tot["counters"], span["count"])
    return 100.0 * moved / span["s"] / counts.PEAK_BYTES
