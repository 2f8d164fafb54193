"""The CLI's start-up path: ``.env``, the ``extras`` config section and the
config tree.

Counterpart of ``evi_rag_tpu/cli.py``'s ``load_dotenv``, ``apply_extras`` and
``print_config_tree``, with the same config keys:

* ``extras.deterministic`` -- bit-reproducible runs on the card:
  ``torch.use_deterministic_algorithms(True)`` (a library op with no
  deterministic form raises instead of running), cuDNN deterministic and
  not benchmarking, and ``CUBLAS_WORKSPACE_CONFIG`` (``prepare_process``,
  before anything reaches cuBLAS).  The hand-written kernels
  (``ops/score_kernels.py``) are outside PyTorch's switch; their outputs are
  bit for bit the same from run to run by design.
* ``extras.debug_nans`` -- ``FloatingPointError`` at the first op that
  computes a floating output holding a NaN, in the forward and the backward
  pass (``NanCheckMode``), and at a kernel wrapper whose output holds one
  (``check_kernel_outputs``).  NaN only, as ``jax_debug_nans``: ``-inf``
  (the unfilled top-k slots) passes.
* ``extras.platform`` -- ``cpu`` runs the task as ``device=cpu``; ``gpu`` or
  ``cuda`` on the card; anything else, or a ``device`` that says otherwise,
  is a ``ConfigError``.
* ``extras.print_config`` -- ``print_config_tree`` at task start (default
  on).

Where the port differs from the JAX package:

* Both modes hold for the task only: ``apply_extras`` is a context manager
  that restores the earlier settings on exit, so an in-process caller does
  not inherit them.  ``CUBLAS_WORKSPACE_CONFIG`` stays set, as JAX's
  ``XLA_FLAGS`` edit does: cuBLAS reads it once per process, so a
  deterministic run belongs in a process of its own.
* Ops that only allocate, view, copy, convert, gather or join values are not
  checked for NaN: they produce no NaN their inputs did not hold.  A NaN
  that enters from outside (data, a checkpoint) is reported at the first op
  that computes with it, or at the kernel that reads it.  Allocation is
  skipped because deterministic mode fills new memory with NaN; reading
  such memory before it is written is then reported where it is used.
* JAX's persistent compile cache has no counterpart: eager PyTorch compiles
  nothing per run, and the kernels' build directory (``ops/_build.py``) is
  already the cache.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

from evi_rag_tpu_torch.utils.config import ConfigError
from evi_rag_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

CUBLAS_WORKSPACE_CONFIG = ":4096:8"
PLATFORMS = {"cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}

_aten = torch.ops.aten
# Ops whose floating outputs hold only values their inputs held (or memory
# not yet written): no NaN is computed here.  Views are skipped by schema.
_UNCHECKED = frozenset({
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty, _aten.new_empty_strided,
    _aten.zeros, _aten.zeros_like, _aten.new_zeros, _aten.ones, _aten.ones_like, _aten.new_ones, _aten.arange,
    _aten.resize_, _aten._pin_memory, _aten.lift_fresh_copy, _aten._to_copy, _aten.copy_, _aten.clone,
    _aten.cat, _aten.stack, _aten.index, _aten.index_select, _aten.gather, _aten.index_put, _aten.index_put_,
})


def load_dotenv(path: str | os.PathLike = ".env") -> None:
    """Load ``KEY=VALUE`` lines of ``path`` into ``os.environ`` without
    overriding a variable that is already set (the reference's rootutils
    dotenv behaviour): blank and ``#`` lines skipped, split on the first
    ``=``, whitespace and then ``"`` stripped."""
    f = pathlib.Path(path)
    if not f.exists():
        return
    for line in f.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        os.environ.setdefault(key.strip(), value.strip().strip('"'))


def print_config_tree(cfg: dict) -> None:
    """The config at task start, keys starting with ``_`` left out: a
    ``rich`` tree when ``rich`` imports, else one ``config: <json>`` log
    line."""
    shown = {k: v for k, v in cfg.items() if not k.startswith("_")}
    try:
        import rich
        import rich.tree
    except ImportError:
        log.info("config: %s", json.dumps(shown, default=str))
        return

    def add(node, d):
        for k, v in sorted(d.items()):
            if isinstance(v, dict):
                add(node.add(f"[bold]{k}[/bold]"), v)
            else:
                node.add(f"{k}: {v}")

    tree = rich.tree.Tree("config")
    add(tree, shown)
    rich.print(tree)


def _extras(cfg: dict) -> dict:
    return cfg.get("extras") or {}


def prepare_process(cfg: dict) -> None:
    """What deterministic mode needs before the first cuBLAS call of the
    process: ``CUBLAS_WORKSPACE_CONFIG`` (unless already set)."""
    if _extras(cfg).get("deterministic"):
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE_CONFIG)


def resolve_platform(cfg: dict) -> None:
    """``extras.platform`` -> ``cfg["device"]``; raises ``ConfigError`` on an
    unknown platform or one that contradicts ``device``."""
    platform = _extras(cfg).get("platform")
    if not platform:
        return
    kind = PLATFORMS.get(str(platform).lower())
    if kind is None:
        raise ConfigError(f"extras.platform={platform!r}: the port runs on {sorted(PLATFORMS)}")
    device = cfg.get("device")
    if device is None:
        cfg["device"] = kind
    elif torch.device(device).type != kind:
        raise ConfigError(f"extras.platform={platform!r} contradicts device={device!r}")


class NanCheckMode(TorchDispatchMode):
    """Raise ``FloatingPointError`` at the first op whose floating output
    holds a NaN (forward and backward: autograd's ops pass through the mode
    too), naming the op.  One device sync per checked op.  Tensors on the
    meta device hold no values (a model built there before its weights
    load) and are not checked."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket in _UNCHECKED:
            return out
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex()) and t.numel()
                    and not t.is_meta and bool(torch.isnan(t).any())):
                node = torch._C._current_autograd_node()
                where = f" (backward of {node.name()})" if node is not None else ""
                raise FloatingPointError(f"extras.debug_nans: {func} produced NaN{where}")
        return out


def nan_checks_enabled() -> bool:
    """Whether a ``NanCheckMode`` is active in this thread."""
    return any(isinstance(m, NanCheckMode) for m in _get_current_dispatch_mode_stack())


def check_kernel_outputs(name: str, *outputs: torch.Tensor) -> None:
    """Under ``extras.debug_nans``, raise ``FloatingPointError`` naming the
    kernel if one of its floating outputs holds a NaN (a kernel loaded
    through ``ctypes`` is not an op the mode sees)."""
    if not nan_checks_enabled():
        return
    for t in outputs:
        if t.is_floating_point() and bool(torch.isnan(t).any()):
            raise FloatingPointError(f"extras.debug_nans: kernel {name} produced NaN")


@contextlib.contextmanager
def apply_extras(cfg: dict) -> Iterator[None]:
    """Resolve ``extras.platform`` into ``cfg["device"]`` and hold the
    deterministic and NaN modes that ``extras`` asks for while the block
    runs; the earlier settings come back on exit.  Call ``prepare_process``
    first, before the process's first cuBLAS call."""
    resolve_platform(cfg)
    extras = _extras(cfg)
    with contextlib.ExitStack() as stack:
        if extras.get("deterministic"):
            saved = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)

            def restore() -> None:
                torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2], saved[3]

            stack.callback(restore)
            torch.use_deterministic_algorithms(True)
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        if extras.get("debug_nans"):
            stack.enter_context(NanCheckMode())
        yield
