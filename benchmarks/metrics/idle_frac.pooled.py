"""Share of the traced window in which no operation ran on the card."""


def read(ctx):
    tr = ctx["trace"]
    return 1.0 - tr["busy_s"] / tr["window_s"] if tr and tr["window_s"] > 0 else None
