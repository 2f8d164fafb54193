"""Process-aware logging, the JSONL metric sink and the ``metrics.json``
writer.

The part of ``evi_rag_tpu/utils/logging.py`` the port uses, without JAX: the
process rank comes from ``torch.distributed`` when a group is initialised,
else it is 0.
"""

from __future__ import annotations

import json
import logging
import pathlib
import time
from typing import Any, Mapping


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class _ProcessPrefixFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        record.rank = process_index()
        return True


def get_logger(name: str, *, level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not any(isinstance(f, _ProcessPrefixFilter) for f in logger.filters):
        logger.addFilter(_ProcessPrefixFilter())
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("[%(asctime)s][rank%(rank)s][%(name)s][%(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger


def is_main_process() -> bool:
    return process_index() == 0


class MetricLogger:
    """JSONL metric sink (one row per log call), main process only."""

    def __init__(self, run_dir: str | pathlib.Path, *, filename: str = "metrics.jsonl") -> None:
        self.run_dir = pathlib.Path(run_dir)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.run_dir / filename

    def log(self, metrics: Mapping[str, Any], *, step: int | None = None) -> None:
        if not is_main_process():
            return
        row = {"_time": time.time(), "_step": step, **{k: _scalar(v) for k, v in metrics.items()}}
        with self.path.open("a") as f:
            f.write(json.dumps(row) + "\n")


def _scalar(v: Any) -> Any:
    import numpy as np
    import torch

    if isinstance(v, torch.Tensor) and v.ndim == 0:
        return v.item()
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray) and v.ndim == 0:
        return v.item()
    return v


def save_metrics_json(path: str | pathlib.Path, metrics: Mapping[str, Any]) -> None:
    """Persist a metrics dict (the reference's per-eval ``metrics.json``)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({k: _scalar(v) for k, v in metrics.items()}, indent=2, sort_keys=True))
