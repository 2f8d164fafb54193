"""The program's own spans and counters, for the per-layer metrics that
read them: ``evi_rag_tpu_torch.utils.profiling.totals()``.  The program
records only while a ``torch.profiler`` session runs, which in a run is the
traced window alone."""

from __future__ import annotations

from typing import Any


def totals() -> dict[str, Any] | None:
    """``{"spans": {name: {"count", "s", "self_s"}}, "counters": {name: n}}``,
    or None where the program has no such registry."""
    from evi_rag_tpu_torch.utils import profiling

    read = getattr(profiling, "totals", None)
    return read() if read is not None else None
