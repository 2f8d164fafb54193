"""Retriever checkpoints for the port: the feature bundle, the parameter
digest, a weights converter and the port's on-disk format.

Counterpart of ``evi_rag_tpu/train/checkpoint.py``.  The directory layout is
the same ``meta.json`` (schema 1, ``params_sha256``, ``step``,
``has_opt_state``) with the arrays in a ``state.npz`` instead of an orbax
tree, since the port does not depend on orbax: one entry per leaf, keyed by
its path (``params/params/q_gate/kernel``; the optimizer state, when saved,
under ``opt_state/``).  ``params_digest`` gives the same sha256 as the JAX
function for the same parameter tree, so a checkpoint converted from JAX
keeps its digest, and a port-trained one has the digest JAX computes for
the same numbers.

Convert a JAX checkpoint (on a machine that has JAX)::

    from evi_rag_tpu.train.checkpoint import load_checkpoint as load_jax
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint
    tree, meta = load_jax("ckpt/best")
    save_checkpoint("ckpt_torch/best", tree["params"], meta=meta)
"""

from __future__ import annotations

import hashlib
import json
import pathlib
from typing import Any, Iterator

import numpy as np
import torch

from evi_rag_tpu_torch.utils.device import resolve_device

META_FILENAME = "meta.json"
STATE_FILENAME = "state.npz"
SCHEMA_VERSION = 1
# Keys save_checkpoint writes itself; other meta entries pass through.
_OWN_META_KEYS = ("schema_version", "params_sha256", "step", "has_opt_state")

# Parameter names the serving path (and the GFlowNet embedder) needs.
RETRIEVER_FEATURE_KEYS = (
    "entity_proj",
    "relation_proj",
    "query_proj",
    "non_text_entity_emb",
    "q_gate",
    "q_bias",
    "struct_proj",
    "struct_norm",
    "struct_gate",
    "state_net_0",
    "state_norm",
    "state_net_1",
    "score_head",
)


def _leaves(tree: Any, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _keystr(path: tuple[str, ...]) -> str:
    """``jax.tree_util.keystr`` of a dict-key path: ``['params']['q_gate']``."""
    return "".join(f"[{k!r}]" for k in path)


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def params_digest(params: Any) -> str:
    """Stable sha256 over parameter bytes, path-sorted; equal to the JAX
    package's digest of the same tree of nested dicts."""
    h = hashlib.sha256()
    for path, leaf in sorted(_leaves(params), key=lambda kv: _keystr(kv[0])):
        h.update(_keystr(path).encode())
        h.update(_to_numpy(leaf).tobytes())
    return h.hexdigest()


def flatten_tree(tree: Any) -> dict[str, Any]:
    """Nested dicts -> ``{"a/b/c": leaf}`` (keys that hold ``/`` already
    keep it, so flattening a flat dict is the identity)."""
    return {"/".join(p): leaf for p, leaf in _leaves(tree)}


def unflatten_tree(flat: dict[str, Any]) -> dict[str, Any]:
    """``{"a/b/c": leaf}`` -> nested dicts."""
    tree: dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def save_checkpoint(
    path: str | pathlib.Path,
    params: Any,
    *,
    meta: dict[str, Any] | None = None,
    opt_state: Any = None,
    step: int | None = None,
) -> str:
    """Save ``{"params": params}`` (+ ``opt_state`` under ``opt_state/``) as
    ``state.npz`` plus ``meta.json``; returns the params digest.

    Under a process group every rank may call this with the same (shared)
    path; only rank 0 writes.  Data-parallel parameters are the same on
    every rank, so every caller gets the same digest."""
    from evi_rag_tpu_torch.utils.logging import is_main_process

    path = pathlib.Path(path).absolute()
    digest = params_digest(params)
    if not is_main_process():
        return digest
    tree: dict[str, Any] = {"params": params}
    if opt_state is not None:
        tree["opt_state"] = opt_state
    arrays = {key: _to_numpy(leaf) for key, leaf in flatten_tree(tree).items()}
    path.mkdir(parents=True, exist_ok=True)
    with (path / STATE_FILENAME).open("wb") as f:
        np.savez(f, **arrays)
    extra = {k: v for k, v in (meta or {}).items() if k not in _OWN_META_KEYS}
    payload = {
        "schema_version": SCHEMA_VERSION,
        "params_sha256": digest,
        "step": step if step is not None else (meta or {}).get("step"),
        "has_opt_state": opt_state is not None,
        **extra,
    }
    (path / META_FILENAME).write_text(json.dumps(payload, indent=2, default=str))
    return digest


def load_checkpoint(path: str | pathlib.Path) -> tuple[dict[str, Any], dict[str, Any]]:
    """Load (tree of numpy arrays with ``params`` and, when saved,
    ``opt_state``; meta with ``step`` and ``has_opt_state``); verifies the
    params digest."""
    path = pathlib.Path(path).absolute()
    meta_path = path / META_FILENAME
    if not meta_path.exists():
        raise FileNotFoundError(f"checkpoint meta missing: {meta_path}")
    meta = json.loads(meta_path.read_text())
    if meta.get("schema_version") != SCHEMA_VERSION:
        raise ValueError(
            f"checkpoint schema_version {meta.get('schema_version')} != {SCHEMA_VERSION}"
        )
    state = path / STATE_FILENAME
    if not state.exists():
        raise FileNotFoundError(
            f"{state} missing: convert a JAX checkpoint with save_checkpoint first"
        )
    with np.load(state, allow_pickle=False) as npz:
        tree = unflatten_tree({key: npz[key] for key in npz.files})
    got = params_digest(tree["params"])
    want = meta.get("params_sha256")
    if want and got != want:
        raise ValueError(f"checkpoint digest mismatch: {got} != {want}")
    return tree, meta


def export_retriever_features(params: Any, parity_meta: dict[str, int]) -> dict[str, Any]:
    """The retriever feature bundle: exactly the parameters the serving path
    needs plus the ``parity_meta`` feature-geometry contract."""
    inner = params["params"] if "params" in params else params
    missing = [k for k in RETRIEVER_FEATURE_KEYS if k not in inner]
    if missing:
        raise KeyError(f"retriever params missing feature keys: {missing}")
    return {"features": {k: inner[k] for k in RETRIEVER_FEATURE_KEYS}, "parity_meta": dict(parity_meta)}


def validate_parity_meta(expected: dict[str, int], actual: dict[str, int]) -> None:
    """Hard-fail on any feature-geometry mismatch."""
    mismatches = {
        k: (expected.get(k), actual.get(k))
        for k in set(expected) | set(actual)
        if int(expected.get(k, -1)) != int(actual.get(k, -1))
    }
    if mismatches:
        raise ValueError(f"parity_meta mismatch (expected, actual): {mismatches}")


def bundle_from_numpy(
    features: dict[str, Any], *, device: str | torch.device | None = None
) -> dict[str, Any]:
    """Convert a nested dict of numpy arrays (the JAX package's parameters,
    e.g. ``export_retriever_features(...)["features"]``) into the same tree
    of float32 torch tensors on ``device`` (``resolve_device``: the card
    unless ``"cpu"`` is named; raises without one)."""
    device = resolve_device(device)

    def conv(x: Any) -> Any:
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.tensor(np.asarray(x, dtype=np.float32), device=device)

    return conv(features)
