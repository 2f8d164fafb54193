"""Per-question fused scoring + exact top-k: Hopper kernel wrapper and its
plain PyTorch version.

Counterpart of ``evi_rag_tpu/ops/pallas_score.py``'s
``pallas_per_question_topk`` (TPU kernel ``_per_question_topk_kernel``).  The
kernel is ``csrc/per_question_topk.cu``; see the note there for its design
and bound.

* ``per_question_topk`` launches the kernel for CUDA tensors and counts the
  launch in ``per_question_topk.launches``.  For CPU tensors it returns the
  plain version; any other device raises.  There is no fallback from the
  kernel to the plain version.
* ``per_question_topk_reference`` is the plain version: the same arithmetic
  (bf16 operands, f32 sums, exact erf GELU, the same rounding points) in
  PyTorch ops.  The tests and ``chip_smoke.py`` hold the kernel against it.

Unlike the Pallas kernel, neither uses the tanh GELU: both use the exact
form, as the XLA path does (``ops/query.py``).
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch
import torch.nn.functional as F

from evi_rag_tpu_torch.ops.nnfn import dense, layernorm, projector

KERNEL_SOURCE = "per_question_topk.cu"


def prep_weights(feats: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Split and cast the retriever feature weights for the kernel (W1 in
    bf16, the one type the kernel takes; the rest f32).

    Mirrors ``_prep_weights``: W1 row blocks (inter, struct, err, dist), the
    struct-projection halves, and the exact serving fold
    ``w2s = W2 @ w_score``, ``b2s = b2 @ w_score + b_score`` (no
    nonlinearity separates ``state_net_1`` from ``score_head``).  The struct
    projection stays f32, as on the XLA path.  ``w1t`` (``kernel_w1_layout``,
    present when D % 64 == 0) and ``ws`` (``[S, D]``) are the kernel's
    layouts.
    """
    d = feats["q_gate"]["kernel"].shape[0]
    w1 = feats["state_net_0"]["kernel"]
    ws = feats["struct_proj"]["kernel"].float()
    s = ws.shape[0]
    if w1.shape[0] != 3 * d + 1:
        raise ValueError(f"state_net_0 rows {w1.shape[0]} != 3*{d}+1")
    if s % 2 != 0:
        raise ValueError("struct dim must be even (head/tail halves)")
    w2f = feats["state_net_1"]["kernel"].float()
    wscf = feats["score_head"]["kernel"].float()  # [H, 1]
    out = {
        "w1_inter": w1[:d].to(torch.bfloat16),
        "w1_struct": w1[d : 2 * d].to(torch.bfloat16),
        "w1_err": w1[2 * d : 3 * d].to(torch.bfloat16),
        "w1_dist": w1[3 * d :].float(),  # [1, H]
        "b1": feats["state_net_0"]["bias"].float(),
        "ln1_scale": feats["state_norm"]["scale"].float(),
        "ln1_bias": feats["state_norm"]["bias"].float(),
        "w2s": w2f @ wscf,  # [H, 1]
        "b2s": feats["state_net_1"]["bias"].float() @ wscf + feats["score_head"]["bias"].float(),
        "ws_top": ws[: s // 2],
        "ws_bot": ws[s // 2 :],
        "bs": feats["struct_proj"]["bias"].float(),
        "lns_scale": feats["struct_norm"]["scale"].float(),
        "lns_bias": feats["struct_norm"]["bias"].float(),
        "wg_kernel": feats["struct_gate"]["kernel"].float(),  # [D, 1]
        "wg_bias": feats["struct_gate"]["bias"].float(),
    }
    out["ws"] = ws.contiguous()
    if d % 64 == 0:  # the kernel's D; other widths only take the plain version
        out["w1t"] = kernel_w1_layout(torch.cat([out["w1_inter"], out["w1_struct"], out["w1_err"]]))
    return out


def kernel_w1_layout(w1: torch.Tensor) -> torch.Tensor:
    """``W1[:3D]`` ([3D, H]) in the kernel's layout: transposed to [H, 3D],
    and within each block of 16 k the order of k = 8a + 2t + b changed to
    (t, a, b), so the four values an ``mma.sync`` lane t needs for one k16
    step (k = 2t, 2t+1, 8+2t, 9+2t) are one 8-byte load."""
    w1t = w1.t()
    h, kk = w1t.shape
    return w1t.reshape(h, kk // 16, 2, 4, 2).permute(0, 1, 3, 2, 4).reshape(h, kk).contiguous()


def query_gate_bias(feats: dict[str, Any], q_emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[G, D] bf16 (gate, bias) of the raw question embeddings."""
    qp = projector(feats["query_proj"], q_emb.float())
    gate = torch.sigmoid(dense(feats["q_gate"], qp)).to(torch.bfloat16)
    bias = torch.tanh(dense(feats["q_bias"], qp)).to(torch.bfloat16)
    return gate.contiguous(), bias.contiguous()


def per_question_scores_reference(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [G, D]
    head_repr: torch.Tensor,   # [G, M, D]
    rel_repr: torch.Tensor,
    tail_repr: torch.Tensor,
    struct_raw: torch.Tensor,  # [G, M, S]
    lengths: torch.Tensor,     # [G] valid-prefix lengths
    *,
    weights: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """[G, M] f32 twin-view scores, -inf past each question's prefix, with
    the kernel's arithmetic."""
    feats = bundle["features"]
    w = weights if weights is not None else prep_weights(feats)
    gate, bias = query_gate_bias(feats, q_emb)
    bf = lambda x: x.to(torch.bfloat16).float()
    h, r, t = bf(head_repr), bf(rel_repr), bf(tail_repr)
    rc = r * gate.float()[:, None, :] + bias.float()[:, None, :]
    s = bf(struct_raw)
    hs = s.shape[-1] // 2
    sh, st = s[..., :hs], s[..., hs:]
    proj_f = sh @ w["ws_top"] + st @ w["ws_bot"] + w["bs"]
    proj_b = sh @ w["ws_bot"] + st @ w["ws_top"] + w["bs"]
    w1i, w1s, w1e = w["w1_inter"].float(), w["w1_struct"].float(), w["w1_err"].float()

    def direction(hd: torch.Tensor, tl: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
        sc = F.gelu(layernorm({"scale": w["lns_scale"], "bias": w["lns_bias"]}, proj))
        nav = torch.sigmoid(sc @ w["wg_kernel"] + w["wg_bias"])
        inter = hd * rc * tl * nav
        err = hd + rc - tl
        dist = -torch.sqrt((err * err).sum(dim=-1, keepdim=True) + 1e-12)
        z = bf(inter) @ w1i + bf(sc) @ w1s + bf(err) @ w1e + dist * w["w1_dist"] + w["b1"]
        z = F.gelu(layernorm({"scale": w["ln1_scale"], "bias": w["ln1_bias"]}, z))
        return (z @ w["w2s"])[..., 0] + w["b2s"]

    stacked = torch.stack([direction(h, t, proj_f), direction(t, h, proj_b)])
    scores = (torch.softmax(stacked, dim=0) * stacked).sum(dim=0)
    pos = torch.arange(scores.shape[1], device=scores.device)
    valid = pos[None, :] < lengths.to(scores.device)[:, None]
    return torch.where(valid, scores, torch.full_like(scores, float("-inf")))


def topk_desc(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis ordered (score desc, index asc), as
    ``jax.lax.top_k`` orders ties; ids are int32."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def per_question_topk_reference(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,
    head_repr: torch.Tensor,
    rel_repr: torch.Tensor,
    tail_repr: torch.Tensor,
    struct_raw: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k: int,
    weights: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ([G, k] f32, [G, k] int32)."""
    scores = per_question_scores_reference(
        bundle, q_emb, head_repr, rel_repr, tail_repr, struct_raw, lengths, weights=weights
    )
    return topk_desc(scores, k)


_FORWARD = None


def _forward_fn():
    """The kernel's C entry, typed (built and loaded on first use)."""
    global _FORWARD
    if _FORWARD is None:
        from evi_rag_tpu_torch.ops._build import load_library

        lib = load_library(KERNEL_SOURCE)
        fn = lib.pqt_forward
        fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pqt_error_string.argtypes = [ctypes.c_int]
        lib.pqt_error_string.restype = ctypes.c_char_p
        lib.pqt_max_k.restype = ctypes.c_int
        _FORWARD = lib
    return _FORWARD


def _check(
    name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device, align: int = 8
) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % align != 0:
        raise ValueError(f"{name} must be contiguous and {align}-byte aligned")


def per_question_topk(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [G, D] raw question embeddings (f32)
    head_repr: torch.Tensor,   # [G, M, D] bf16
    rel_repr: torch.Tensor,    # [G, M, D] bf16
    tail_repr: torch.Tensor,   # [G, M, D] bf16
    struct_raw: torch.Tensor,  # [G, M, S] bf16
    lengths: torch.Tensor,     # [G] int32 valid-prefix lengths
    *,
    k: int,
    weights: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-question top-k of the twin-view scores: ([G, k] f32 scores,
    [G, k] int32 local ids), ordered (score desc, index asc); slots past a
    question's length come back as -inf.

    CUDA tensors launch ``csrc/per_question_topk.cu``; CPU tensors take the
    plain version (``per_question_topk_reference``).  ``weights`` is
    ``prep_weights(bundle["features"])``, computed here when not given.
    """
    dev = head_repr.device
    if dev.type == "cpu":
        return per_question_topk_reference(
            bundle, q_emb, head_repr, rel_repr, tail_repr, struct_raw, lengths, k=k, weights=weights
        )
    if dev.type != "cuda":
        raise ValueError(f"per_question_topk runs on cuda or cpu tensors, got {dev}")
    g_n, m, d = head_repr.shape
    s = struct_raw.shape[-1]
    bf16 = torch.bfloat16
    for name, x in (("head_repr", head_repr), ("rel_repr", rel_repr), ("tail_repr", tail_repr)):
        _check(name, x, bf16, (g_n, m, d), dev)
    _check("struct_raw", struct_raw, bf16, (g_n, m, s), dev)
    _check("lengths", lengths, torch.int32, (g_n,), dev, align=4)
    _check("q_emb", q_emb, torch.float32, (g_n, d), dev)
    if d % 64 or d > 1024:
        raise ValueError(f"kernel needs D % 64 == 0 and D <= 1024, got D={d}")
    if s % 2 or s > 32:
        raise ValueError(f"kernel needs an even struct width <= 32, got S={s}")
    lib = _forward_fn()
    if not 1 <= k <= min(m, lib.pqt_max_k()):
        raise ValueError(f"kernel needs 1 <= k <= min(M={m}, {lib.pqt_max_k()}), got k={k}")
    feats = bundle["features"]
    w = weights if weights is not None else prep_weights(feats)
    h_dim = w["w1t"].shape[0]
    if h_dim % 8 or h_dim > 1024:
        raise ValueError(f"kernel needs H % 8 == 0 and H <= 1024, got H={h_dim}")
    f32 = torch.float32
    # The kernel's f32 weights, in its argument order, with their shapes.
    f32_weights = [
        ("w1_dist", (1, h_dim)), ("b1", (h_dim,)), ("ln1_scale", (h_dim,)), ("ln1_bias", (h_dim,)),
        ("w2s", (h_dim, 1)), ("b2s", (1,)), ("ws", (s, d)), ("bs", (d,)), ("lns_scale", (d,)),
        ("lns_bias", (d,)), ("wg_kernel", (d, 1)), ("wg_bias", (1,)),
    ]
    for name, shape in f32_weights:
        _check(name, w[name], f32, shape, dev)
    _check("w1t", w["w1t"], bf16, (h_dim, 3 * d), dev)
    gate, bias = query_gate_bias(feats, q_emb)
    scores = torch.empty((g_n, m), dtype=f32, device=dev)
    vals = torch.empty((g_n, k), dtype=f32, device=dev)
    ids = torch.empty((g_n, k), dtype=torch.int32, device=dev)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = lib.pqt_forward(
        ptr(lengths), ptr(head_repr), ptr(rel_repr), ptr(tail_repr), ptr(struct_raw),
        ptr(gate), ptr(bias), ptr(w["w1t"]), *(ptr(w[name]) for name, _ in f32_weights),
        ptr(scores), ptr(vals), ptr(ids), g_n, m, d, h_dim, s, k,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if rc != 0:
        raise RuntimeError(f"per_question_topk launch failed: {lib.pqt_error_string(rc).decode()}")
    per_question_topk.launches += 1
    return vals, ids


per_question_topk.launches = 0
