"""Share of the serve engine's scoring time spent in its dispatch loop
(``ServeStats.dispatch_s`` over ``scoring_s``, summed over the window's
requests): host packing, uploads and launches."""


def read(ctx):
    c = ctx["counters"]
    return c["dispatch_s"] / c["scoring_s"] if c.get("scoring_s") else None
