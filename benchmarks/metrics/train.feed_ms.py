"""Host milliseconds a step waits on the feeder (``data/feeder.py``
collation behind ``prefetch``), from the harness's span around it."""


def read(ctx):
    n, total = ctx["spans"].get("feed", (0, 0.0))
    return 1e3 * total / n if n else None
