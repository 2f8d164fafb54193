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

from evi_rag_tpu_torch.utils.profiling import count


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


def _mm_f32(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor | None = None) -> torch.Tensor:
    """``acc + a @ b`` (``a @ b`` without ``acc``) in f32, for bf16 2-D ``a``
    and ``b``: on CUDA one cuBLAS bf16 GEMM on the tensor cores that sums and
    writes in f32 (``torch.mm`` / ``torch.addmm`` with ``out_dtype``);
    elsewhere the f32 product of the upcast operands.  The product of two bf16 values is exact
    in f32, so both compute the same products and differ only in the order
    of their f32 sums."""
    if a.is_cuda:
        if acc is None:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.addmm(acc, a, b, out_dtype=torch.float32)
    y = a.float() @ b.float()
    return y if acc is None else acc + y


class DenseSplitBF16(torch.autograd.Function):
    """``dense_split`` at bf16 with its own backward, every product through
    ``_mm_f32``: ``apply(kernel, bias, *parts)``.

    Forward: each part and kernel row-slice is cast to bf16 once, ``bias +
    sum(part @ slice)`` is summed in f32 and rounded to bf16 once; the bf16
    parts and slices are saved, not f32 copies.  Backward, with ``g`` the
    (bf16) output gradient: ``g @ slice.T`` rounded to bf16 and returned in
    the part's dtype, ``part.T @ g`` rounded to bf16 into the slice's rows,
    ``sum(g)`` in f32 for the bias: what autograd gives for the f32 chain
    ``x.to(bf16).float() @ slice.to(bf16).float()`` (``dense_split_f32``),
    whose operands are as bf16-exact as these: on the CPU the same values
    bit for bit, on the card the same products summed in another order.
    """

    @staticmethod
    def forward(ctx, kernel: torch.Tensor, bias: torch.Tensor, *parts: torch.Tensor) -> torch.Tensor:
        widths = [x.shape[-1] for x in parts]
        if sum(widths) != kernel.shape[0]:
            raise ValueError(f"parts sum to {sum(widths)} rows, kernel has {kernel.shape[0]}")
        xs = [x.reshape(-1, d).to(torch.bfloat16) for x, d in zip(parts, widths)]
        ks = [k.to(torch.bfloat16) for k in kernel.split(widths)]
        acc = bias.float()
        for x, k in zip(xs, ks):
            acc = _mm_f32(x, k, acc)
        ctx.save_for_backward(*xs, *ks)
        ctx.meta = (kernel.dtype, [(x.shape, x.dtype) for x in parts])
        return acc.to(torch.bfloat16).reshape(*parts[0].shape[:-1], -1)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        kernel_dtype, part_meta = ctx.meta
        saved = ctx.saved_tensors
        xs, ks = saved[: len(part_meta)], saved[len(part_meta):]
        g = grad_out.reshape(-1, grad_out.shape[-1]).to(torch.bfloat16)
        want_parts = ctx.needs_input_grad[2:]
        grad_parts = [
            _mm_f32(g, k.t()).to(torch.bfloat16).to(dt).reshape(shape) if want else None
            for k, (shape, dt), want in zip(ks, part_meta, want_parts)
        ]
        grad_kernel = grad_bias = None
        if ctx.needs_input_grad[0]:
            grad_kernel = torch.cat([_mm_f32(x.t(), g).to(torch.bfloat16) for x in xs]).to(kernel_dtype)
        if ctx.needs_input_grad[1]:
            grad_bias = g.float().sum(0)
        return grad_kernel, grad_bias, *grad_parts


def dense_split(p: Any, parts: tuple[torch.Tensor, ...], dtype: torch.dtype) -> torch.Tensor:
    """``dense`` over a conceptual concat input, applied per kernel row-slice
    with f32 accumulation and one rounding to ``dtype`` at the end.

    Every part and kernel slice is cast to ``dtype`` first.  At bf16 on CUDA
    the products run on the tensor cores (``DenseSplitBF16``: cuBLAS bf16
    GEMMs that sum and write in f32, forward and backward); otherwise as
    ``dense_split_f32``.  The product of two bf16 values is exact in f32, so
    the two routes compute the same products with the same one rounding, and
    differ only in the order of their f32 sums.  Counters (while tracing):
    ``nnfn.dense_split.tc`` / ``nnfn.dense_split.f32``, one per call.
    """
    if dtype is torch.bfloat16 and parts[0].is_cuda:
        count("nnfn.dense_split.tc")
        return DenseSplitBF16.apply(p["kernel"], p["bias"], *parts)
    count("nnfn.dense_split.f32")
    return dense_split_f32(p, parts, dtype)


def dense_split_f32(p: Any, parts: tuple[torch.Tensor, ...], dtype: torch.dtype) -> torch.Tensor:
    """``dense_split`` as f32 matmuls under autograd: each operand cast to
    ``dtype`` and back to f32, so that at bf16 the f32 matmul of the cast
    operands is the bf16 product with f32 accumulation."""
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
