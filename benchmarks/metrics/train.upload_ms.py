"""Host milliseconds a training step spends moving its batch to the card
and resolving its id feed (the program's ``train.upload`` span, per step),
over the traced window.  None where the program records no such span."""

from benchmarks import program_spans


def read(ctx):
    tot = program_spans.totals()
    up = tot["spans"].get("train.upload") if tot is not None else None
    return 1e3 * up["s"] / up["count"] if up and up["count"] else None
