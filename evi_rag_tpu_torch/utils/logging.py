"""Process-aware logging + the ``metrics.json`` writer.

The part of ``evi_rag_tpu/utils/logging.py`` the port uses, without JAX: the
process rank comes from ``torch.distributed`` when a group is initialised,
else it is 0.
"""

from __future__ import annotations

import json
import logging
import pathlib
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


def _scalar(v: Any) -> Any:
    import numpy as np

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
