"""Parameter-dict neural-net primitives for the frozen retriever features.

Counterpart of ``evi_rag_tpu/ops/nnfn.py``: plain functions over dicts of
tensors in the flax layout (``kernel`` is ``[in, out]``).  Mixed dtypes
promote as JAX promotes them (bf16 with f32 gives f32), so the two packages
round at the same points.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F


def tree_to(tree: Any, device: torch.device) -> Any:
    """Nested dict of numpy arrays / tensors -> the same tree of float32
    tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree, dtype=torch.float32).to(device)


def _matmul(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, k.dtype)
    return x.to(dt) @ k.to(dt)


def dense(p: Any, x: torch.Tensor) -> torch.Tensor:
    return _matmul(x, p["kernel"]) + p["bias"]


def dense_split(p: Any, parts: tuple[torch.Tensor, ...], dtype: torch.dtype) -> torch.Tensor:
    """``dense`` over a conceptual concat input, applied per kernel row-slice
    with f32 accumulation and one rounding to ``dtype`` at the end.

    Every part and kernel slice is cast to ``dtype`` first; the product of two
    bf16 values is exact in f32, so an f32 matmul of the cast operands is the
    bf16 product with f32 accumulation.
    """
    acc = p["bias"].float()
    off = 0
    kernel = p["kernel"]
    for x in parts:
        d = x.shape[-1]
        k = kernel[off : off + d].to(dtype).float()
        acc = acc + x.to(dtype).float() @ k
        off += d
    if off != kernel.shape[0]:
        raise ValueError(f"parts sum to {off} rows, kernel has {kernel.shape[0]}")
    return acc.to(dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, the reference's ``nn.GELU()``."""
    return F.gelu(x)


def projector(p: Any, x: torch.Tensor) -> torch.Tensor:
    """EmbeddingProjector: Linear + tanh."""
    return torch.tanh(dense(p["proj"], x))


def layernorm(p: Any, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
