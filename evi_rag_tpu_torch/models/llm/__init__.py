"""Language models of the reasoner: Moonlight-16B-A3B (``deepseek_v3``:
multi-head latent attention and a sparse mixture of experts) and
Kimi-Linear-48B-A3B (``kimi_linear``: KDA linear attention beside MLA
without rotation, and a sparse mixture of experts).

``MODELS`` is the one table of them: a model file's ``model_type`` to its
configuration and the module of this package that runs it."""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Any

from evi_rag_tpu_torch.models.llm.config import KimiLinearConfig, MoonlightConfig

MODELS = {"deepseek_v3": (MoonlightConfig, "moonlight"), "kimi_linear": (KimiLinearConfig, "kimi_linear")}


def read_model_file(d: dict[str, Any]):
    """The model file's configuration, by its ``model_type``."""
    if d.get("model_type") not in MODELS:
        raise ValueError(f"model file: model_type {d.get('model_type')!r} is not one of {sorted(MODELS)}")
    return MODELS[d["model_type"]][0].from_dict(d)


def module_of(cfg) -> ModuleType:
    """The module that runs configuration ``cfg``."""
    name = next(mod for kind, mod in MODELS.values() if isinstance(cfg, kind))
    return importlib.import_module(f"{__name__}.{name}")
