"""Share of the edge slots the serve engine dispatched that hold a real
edge: the program's ``serve.edges.<route>`` over ``serve.slots.<route>``
counters, summed over both routes (kernel 3 and the plain scorer), over the
traced window.  None where the program counts no slots."""

from benchmarks import program_spans

ROUTES = ("kernel", "plain")


def read(ctx):
    tot = program_spans.totals()
    if tot is None:
        return None
    c = tot["counters"]
    slots = sum(c.get(f"serve.slots.{r}", 0) for r in ROUTES)
    return sum(c.get(f"serve.edges.{r}", 0) for r in ROUTES) / slots if slots else None
