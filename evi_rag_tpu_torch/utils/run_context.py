"""Run directories + crash-safe task wrapping.

Copy of ``evi_rag_tpu/utils/run_context.py``: the reference's run-dir
convention (``logs/<experiment>_<dataset>/runs/<timestamp>``) and the
``@task_wrapper`` crash logger.
"""

from __future__ import annotations

import datetime
import functools
import json
import pathlib
import traceback
from typing import Any, Callable

from evi_rag_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def resolve_run_name(cfg: dict) -> str:
    exp = cfg.get("experiment_name", cfg.get("task_name", "run"))
    ds = cfg.get("dataset", {}).get("name") if isinstance(cfg.get("dataset"), dict) else None
    return f"{exp}_{ds}" if ds else str(exp)


def make_run_dir(cfg: dict, *, root: str = "logs") -> pathlib.Path:
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    run_dir = pathlib.Path(cfg.get("paths", {}).get("log_dir", root)) / resolve_run_name(cfg) / "runs" / stamp
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "config.json").write_text(json.dumps(cfg, indent=2, default=str))
    return run_dir


def task_wrapper(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Log exceptions to the run dir and always re-raise."""

    @functools.wraps(fn)
    def wrapped(cfg: dict, *args: Any, **kwargs: Any) -> Any:
        run_dir: pathlib.Path | None = kwargs.get("run_dir")
        try:
            return fn(cfg, *args, **kwargs)
        except Exception:
            log.exception("task failed")
            if run_dir is not None:
                (pathlib.Path(run_dir) / "crash.log").write_text(traceback.format_exc())
            raise

    return wrapped
