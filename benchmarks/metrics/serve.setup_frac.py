"""Share of the harness's ``request`` time that ``serving.serve_split``
spends in its per-call set-up and warm-up (the program's ``serve.setup`` and
``serve.warmup`` spans), over the traced window.  None where the program
records no set-up span."""

from benchmarks import program_spans


def read(ctx):
    tot = program_spans.totals()
    _, request_s = ctx["spans"].get("request", (0, 0.0))
    if tot is None or "serve.setup" not in tot["spans"] or not request_s:
        return None
    spans = tot["spans"]
    return sum(spans[k]["s"] for k in ("serve.setup", "serve.warmup") if k in spans) / request_s
