"""Twin-view scoring kernels for Hopper: wrappers and their plain PyTorch
versions.

Counterpart of ``evi_rag_tpu/ops/pallas_score.py``.  Each wrapper replaces
one Pallas TPU kernel:

==========================  ==============================  =========================
wrapper                     TPU kernel (wrappers)           CUDA source (``csrc/``)
==========================  ==============================  =========================
``per_question_topk``       ``_per_question_topk_kernel``   ``per_question_topk.cu``
                            (``pallas_per_question_topk``)
``score_bidirectional``,    ``_score_kernel``               ``score_bidirectional.cu``
``query_topk_per_query``    (``pallas_score_bidirectional``,
                            ``pallas_query_topk``)
``query_topk_fused``        ``_fused_topk_kernel``          ``pooled_query.cu``
                            (``pallas_query_topk_fused``)
==========================  ==============================  =========================

The device code they share is ``csrc/twin_score.cuh``; see the notes in the
sources for each design and bound.

* A wrapper launches its kernel for CUDA tensors and counts the launch in
  ``<wrapper>.launches`` (``query_topk_per_query`` counts through
  ``score_bidirectional``).  For CPU tensors it returns the plain version
  and counts nothing; any other device raises.  There is no fallback from
  a kernel to its plain version.
* The plain versions (``*_reference``) repeat the kernels' arithmetic (bf16
  operands, f32 sums, exact erf GELU, the same rounding points) in PyTorch
  ops.  The tests and ``chip_smoke.py`` hold the kernels against them.

Unlike the Pallas kernels, none uses the tanh GELU: all use the exact form,
as the XLA path does (``ops/query.py``).
"""

from __future__ import annotations

import ctypes
from typing import Any

import torch
import torch.nn.functional as F

from evi_rag_tpu_torch.ops.nnfn import dense, layernorm, projector

KERNEL_SOURCE = "per_question_topk.cu"
SCORE_SOURCE = "score_bidirectional.cu"
POOLED_SOURCE = "pooled_query.cu"
KERNEL_SOURCES = (KERNEL_SOURCE, SCORE_SOURCE, POOLED_SOURCE)
MAX_K = 1024              # the select launch's limit (kMaxK in twin_score.cuh)
_CHUNK_ELEMS = 1 << 27    # plain pooled versions: [B, chunk, D] temporaries of at most this many


def prep_weights(feats: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Split and cast the retriever feature weights for the kernels (W1 in
    bf16, the one type the kernels take; the rest f32).

    Mirrors ``_prep_weights``: W1 row blocks (inter, struct, err, dist), the
    struct-projection halves, and the exact serving fold
    ``w2s = W2 @ w_score``, ``b2s = b2 @ w_score + b_score`` (no
    nonlinearity separates ``state_net_1`` from ``score_head``).  The struct
    projection stays f32, as on the XLA path.  ``w1t`` (``kernel_w1_layout``,
    present when D % 64 == 0) and ``ws`` (``[S, D]``) are the kernels'
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
    if d % 64 == 0:  # the kernels' D; other widths only take the plain versions
        out["w1t"] = kernel_w1_layout(torch.cat([out["w1_inter"], out["w1_struct"], out["w1_err"]]))
    return out


def kernel_w1_layout(w1: torch.Tensor) -> torch.Tensor:
    """``W1[:3D]`` ([3D, H]) in the kernels' layout: transposed to [H, 3D],
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


def _bf(x: torch.Tensor) -> torch.Tensor:
    """The f32 values of ``x`` rounded to bf16."""
    return x.to(torch.bfloat16).float()


def _struct_contexts(w: dict[str, torch.Tensor], struct_raw: torch.Tensor):
    """(sc_f, nav_f), (sc_b, nav_b): the struct context (f32, exact GELU)
    and nav gate of both directions; bwd swaps the struct halves."""
    s = _bf(struct_raw)
    hs = s.shape[-1] // 2
    sh, st = s[..., :hs], s[..., hs:]
    out = []
    for proj in (sh @ w["ws_top"] + st @ w["ws_bot"] + w["bs"], sh @ w["ws_bot"] + st @ w["ws_top"] + w["bs"]):
        sc = F.gelu(layernorm({"scale": w["lns_scale"], "bias": w["lns_bias"]}, proj))
        out.append((sc, torch.sigmoid(sc @ w["wg_kernel"] + w["wg_bias"])))
    return out


def _head(w: dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
    """gelu(LN_H(z)) @ w2s + b2s, the folded score head of one direction."""
    z = F.gelu(layernorm({"scale": w["ln1_scale"], "bias": w["ln1_bias"]}, z))
    return (z @ w["w2s"])[..., 0] + w["b2s"]


def _combine(fwd: torch.Tensor, bwd: torch.Tensor) -> torch.Tensor:
    stacked = torch.stack([fwd, bwd])
    return (torch.softmax(stacked, dim=0) * stacked).sum(dim=0)


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
    the kernels' arithmetic."""
    feats = bundle["features"]
    w = weights if weights is not None else prep_weights(feats)
    gate, bias = query_gate_bias(feats, q_emb)
    h, r, t = _bf(head_repr), _bf(rel_repr), _bf(tail_repr)
    rc = r * gate.float()[:, None, :] + bias.float()[:, None, :]
    (sc_f, nav_f), (sc_b, nav_b) = _struct_contexts(w, struct_raw)
    w1i, w1s, w1e = w["w1_inter"].float(), w["w1_struct"].float(), w["w1_err"].float()

    def direction(hd: torch.Tensor, tl: torch.Tensor, sc: torch.Tensor, nav: torch.Tensor) -> torch.Tensor:
        inter = hd * rc * tl * nav
        err = hd + rc - tl
        dist = -torch.sqrt((err * err).sum(dim=-1, keepdim=True) + 1e-12)
        z = _bf(inter) @ w1i + _bf(sc) @ w1s + _bf(err) @ w1e + dist * w["w1_dist"] + w["b1"]
        return _head(w, z)

    scores = _combine(direction(h, t, sc_f, nav_f), direction(t, h, sc_b, nav_b))
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
    """Plain PyTorch version of the per-question kernel: ([G, k] f32, [G, k] int32)."""
    scores = per_question_scores_reference(
        bundle, q_emb, head_repr, rel_repr, tail_repr, struct_raw, lengths, weights=weights
    )
    return topk_desc(scores, k)


def _chunks(b: int, m: int, d: int):
    """Candidate slices of the plain pooled versions, sized so that a
    [B, chunk, D] f32 temporary stays within ``_CHUNK_ELEMS``."""
    step = max(16, _CHUNK_ELEMS // max(b * d, 1))
    return [slice(c0, min(c0 + step, m)) for c0 in range(0, m, step)]


def score_bidirectional_reference(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [B, D]
    head_repr: torch.Tensor,   # [M, D] shared by every query
    rel_repr: torch.Tensor,
    tail_repr: torch.Tensor,
    struct_raw: torch.Tensor,  # [M, S]
    *,
    weights: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """[B, M] f32 twin-view scores of every query over the shared candidates:
    the per-question arithmetic, with each query's candidate set the same."""
    w = weights if weights is not None else prep_weights(bundle["features"])
    b, d = q_emb.shape
    parts = []
    for sl in _chunks(b, head_repr.shape[0], d):
        ex = lambda x: x[sl].unsqueeze(0).expand(b, *x[sl].shape)
        n = sl.stop - sl.start
        lengths = torch.full((b,), n, dtype=torch.int32, device=head_repr.device)
        parts.append(per_question_scores_reference(
            bundle, q_emb, ex(head_repr), ex(rel_repr), ex(tail_repr), ex(struct_raw), lengths, weights=w
        ))
    return torch.cat(parts, dim=1)


def fused_scores_reference(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [B, D]
    head_repr: torch.Tensor,   # [M, D] shared by every query
    rel_repr: torch.Tensor,
    tail_repr: torch.Tensor,
    struct_raw: torch.Tensor,  # [M, S]
    *,
    weights: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """[B, M] f32 scores in the factorised form of the fused kernel
    (``csrc/pooled_query.cu``), at its rounding points:

    per candidate ``prod = bf16(h*t*r)``, ``hmt = bf16(h-t)``, ``zh = hmt @ W1e``,
    ``zs = bf16(sc) @ W1s`` and ``nav`` (both directions); per (query,
    candidate) ``u = bf16(prod*gate + (h*t)*bias)``, ``r_ctx = bf16(r*gate + bias)``,
    ``zi = u @ W1i``, ``zr = r_ctx @ W1e``, ``err = bf16(r_ctx +- hmt)`` and

        z_f = nav_f*zi + zs_f + (zr + zh) + dist_f*w1d + b1
        z_b = nav_b*zi + zs_b + (zr - zh) + dist_b*w1d + b1

    then the folded head of each direction and the combine.
    """
    feats = bundle["features"]
    w = weights if weights is not None else prep_weights(feats)
    gate, bias = query_gate_bias(feats, q_emb)
    g, bb = gate.float()[:, None, :], bias.float()[:, None, :]
    w1i, w1s, w1e = w["w1_inter"].float(), w["w1_struct"].float(), w["w1_err"].float()
    b, d = q_emb.shape
    parts = []
    for sl in _chunks(b, head_repr.shape[0], d):
        h, r, t = _bf(head_repr[sl]), _bf(rel_repr[sl]), _bf(tail_repr[sl])
        ht = h * t                        # exact in f32
        prod = _bf(ht * r)
        hmt = _bf(h - t)
        zh = hmt @ w1e
        (sc_f, nav_f), (sc_b, nav_b) = _struct_contexts(w, struct_raw[sl])
        zs_f, zs_b = _bf(sc_f) @ w1s, _bf(sc_b) @ w1s
        rc = _bf(r * g + bb)              # [B, C, D]
        u = _bf(prod * g + ht * bb)
        zi, zr = u @ w1i, rc @ w1e
        dist = lambda e: -torch.sqrt((e * e).sum(dim=-1, keepdim=True) + 1e-12)
        dist_f, dist_b = dist(_bf(rc + hmt)), dist(_bf(rc - hmt))
        z_f = nav_f * zi + zs_f + (zr + zh) + dist_f * w["w1_dist"] + w["b1"]
        z_b = nav_b * zi + zs_b + (zr - zh) + dist_b * w["w1_dist"] + w["b1"]
        parts.append(_combine(_head(w, z_f), _head(w, z_b)))
    return torch.cat(parts, dim=1)


def query_topk_fused_reference(
    bundle: dict[str, Any], q_emb: torch.Tensor, index: Any, *, k: int,
    weights: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``query_topk_fused``: ([B, k] f32, [B, k] int32)."""
    scores = fused_scores_reference(
        bundle, q_emb, index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw, weights=weights
    )
    return topk_desc(scores, k)


_LIBS: dict[str, ctypes.CDLL] = {}
# Argument types of each library's C entries (pointers and the stream as
# c_void_p, sizes as c_int), after its name prefix.
_ENTRIES = {
    KERNEL_SOURCE: ("pqt", {"forward": [ctypes.c_void_p] * 23 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}),
    SCORE_SOURCE: ("sb", {
        "forward": [ctypes.c_void_p] * 20 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "select": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    }),
    POOLED_SOURCE: ("pq", {"forward": [ctypes.c_void_p] * 22 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}),
}


def _lib(source: str) -> ctypes.CDLL:
    """A kernel library with its C entries typed (built and loaded on first use)."""
    if source not in _LIBS:
        from evi_rag_tpu_torch.ops._build import load_library

        lib = load_library(source)
        prefix, entries = _ENTRIES[source]
        for name, argtypes in entries.items():
            fn = getattr(lib, f"{prefix}_{name}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        lib.error_string = err
        _LIBS[source] = lib
    return _LIBS[source]


def _launch(source: str, entry: str, name: str, *args: Any) -> None:
    lib = _lib(source)
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {lib.error_string(rc).decode()}")


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


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _device_of(name: str, x: torch.Tensor) -> torch.device:
    """cpu or cuda; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
    return x.device


def _check_k(k: int, m: int) -> None:
    if not 1 <= k <= min(m, MAX_K):
        raise ValueError(f"the kernels need 1 <= k <= min(M={m}, {MAX_K}), got k={k}")


_F32_WEIGHTS = ("w1_dist", "b1", "ln1_scale", "ln1_bias", "w2s", "b2s", "ws", "bs", "lns_scale",
                "lns_bias", "wg_kernel", "wg_bias")  # the C entries' order, after w1t


def _kernel_weights(
    bundle: dict[str, Any], weights: dict[str, torch.Tensor] | None, d: int, s: int, dev: torch.device
) -> dict[str, torch.Tensor]:
    """The prepared weights, after checking every weight the kernels read.
    The caller holds them until its launch is enqueued (the allocator may
    hand freed memory to the next allocation)."""
    if d % 64 or d > 1024:
        raise ValueError(f"kernel needs D % 64 == 0 and D <= 1024, got D={d}")
    if s % 2 or s > 32:
        raise ValueError(f"kernel needs an even struct width <= 32, got S={s}")
    w = weights if weights is not None else prep_weights(bundle["features"])
    h_dim = w["w1t"].shape[0]
    if h_dim % 8 or h_dim > 1024:
        raise ValueError(f"kernel needs H % 8 == 0 and H <= 1024, got H={h_dim}")
    shapes = [(1, h_dim), (h_dim,), (h_dim,), (h_dim,), (h_dim, 1), (1,), (s, d), (d,), (d,), (d,),
              (d, 1), (1,)]
    _check("w1t", w["w1t"], torch.bfloat16, (h_dim, 3 * d), dev)
    for name, shape in zip(_F32_WEIGHTS, shapes):
        _check(name, w[name], torch.float32, shape, dev)
    return w


def _weight_args(w: dict[str, torch.Tensor]) -> list[Any]:
    """Pointers to w1t and the f32 weights, in the C entries' order."""
    return [_ptr(w["w1t"])] + [_ptr(w[name]) for name in _F32_WEIGHTS]


def _check_pooled(q_emb, head_repr, rel_repr, tail_repr, struct_raw, dev) -> tuple[int, int, int, int]:
    """(B, M, D, S) of a pooled call, after the kernels' checks: bf16
    candidate rows, f32 queries, all on ``dev``."""
    m, d = head_repr.shape
    b, s = q_emb.shape[0], struct_raw.shape[-1]
    for name, x in (("head_repr", head_repr), ("rel_repr", rel_repr), ("tail_repr", tail_repr)):
        _check(name, x, torch.bfloat16, (m, d), dev)
    _check("struct_raw", struct_raw, torch.bfloat16, (m, s), dev)
    _check("q_emb", q_emb, torch.float32, (b, d), dev)
    if not 1 <= b <= 65535:
        raise ValueError(f"kernel needs 1 <= B <= 65535 queries, got {b}")
    return b, m, d, s


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
    dev = _device_of("per_question_topk", head_repr)
    if dev.type == "cpu":
        return per_question_topk_reference(
            bundle, q_emb, head_repr, rel_repr, tail_repr, struct_raw, lengths, k=k, weights=weights
        )
    g_n, m, d = head_repr.shape
    s = struct_raw.shape[-1]
    bf16 = torch.bfloat16
    for name, x in (("head_repr", head_repr), ("rel_repr", rel_repr), ("tail_repr", tail_repr)):
        _check(name, x, bf16, (g_n, m, d), dev)
    _check("struct_raw", struct_raw, bf16, (g_n, m, s), dev)
    _check("lengths", lengths, torch.int32, (g_n,), dev, align=4)
    _check("q_emb", q_emb, torch.float32, (g_n, d), dev)
    w = _kernel_weights(bundle, weights, d, s, dev)
    h_dim = w["w1t"].shape[0]
    _check_k(k, m)
    gate, bias = query_gate_bias(bundle["features"], q_emb)
    scores = torch.empty((g_n, m), dtype=torch.float32, device=dev)
    vals = torch.empty((g_n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((g_n, k), dtype=torch.int32, device=dev)
    _launch(
        KERNEL_SOURCE, "pqt_forward", "per_question_topk",
        _ptr(lengths), _ptr(head_repr), _ptr(rel_repr), _ptr(tail_repr), _ptr(struct_raw),
        _ptr(gate), _ptr(bias), *_weight_args(w), _ptr(scores), _ptr(vals), _ptr(ids),
        g_n, m, d, h_dim, s, k, _stream(dev),
    )
    per_question_topk.launches += 1
    return vals, ids


def score_bidirectional(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [B, D] raw query embeddings (f32)
    head_repr: torch.Tensor,   # [M, D] bf16, shared by every query
    rel_repr: torch.Tensor,    # [M, D] bf16
    tail_repr: torch.Tensor,   # [M, D] bf16
    struct_raw: torch.Tensor,  # [M, S] bf16
    *,
    weights: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """[B, M] f32 twin-view scores of every query over one shared candidate
    set (``pallas_score_bidirectional`` with the query axis written out).

    CUDA tensors launch ``csrc/score_bidirectional.cu``; CPU tensors take
    the plain version (``score_bidirectional_reference``).
    """
    dev = _device_of("score_bidirectional", head_repr)
    if dev.type == "cpu":
        return score_bidirectional_reference(
            bundle, q_emb, head_repr, rel_repr, tail_repr, struct_raw, weights=weights
        )
    b, m, d, s = _check_pooled(q_emb, head_repr, rel_repr, tail_repr, struct_raw, dev)
    w = _kernel_weights(bundle, weights, d, s, dev)
    h_dim = w["w1t"].shape[0]
    gate, bias = query_gate_bias(bundle["features"], q_emb)
    scores = torch.empty((b, m), dtype=torch.float32, device=dev)
    _launch(
        SCORE_SOURCE, "sb_forward", "score_bidirectional",
        _ptr(head_repr), _ptr(rel_repr), _ptr(tail_repr), _ptr(struct_raw),
        _ptr(gate), _ptr(bias), *_weight_args(w), _ptr(scores), b, m, d, h_dim, s, _stream(dev),
    )
    score_bidirectional.launches += 1
    return scores


def query_topk_per_query(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [B, D] f32
    index: Any,                # ops.query.TripleIndex, bf16 rows
    *,
    k: int,
    weights: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k per query over the index (``pallas_query_topk``): the dense
    scores of ``score_bidirectional``, then an exact select.  Returns
    ([B, k] f32, [B, k] int32) ordered (score desc, index asc)."""
    _device_of("query_topk_per_query", index.head_repr)
    _check_k(k, index.num_candidates)
    scores = score_bidirectional(
        bundle, q_emb, index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw, weights=weights
    )
    if scores.device.type == "cpu":
        return topk_desc(scores, k)
    b, m = scores.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    _launch(SCORE_SOURCE, "sb_select", "query_topk_per_query",
            _ptr(scores), _ptr(vals), _ptr(ids), b, m, k, _stream(scores.device))
    return vals, ids


def query_topk_fused(
    bundle: dict[str, Any],
    q_emb: torch.Tensor,       # [B, D] f32
    index: Any,                # ops.query.TripleIndex, bf16 rows
    *,
    k: int,
    weights: dict[str, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k per query over the index through the factorised kernel
    (``pallas_query_topk_fused``): the query-independent terms are computed
    once per candidate tile for all B queries.  Returns ([B, k] f32,
    [B, k] int32) ordered (score desc, index asc).

    CUDA tensors launch ``csrc/pooled_query.cu`` (scores, then an exact
    select); CPU tensors take the plain version (``query_topk_fused_reference``).
    """
    dev = _device_of("query_topk_fused", index.head_repr)
    _check_k(k, index.num_candidates)
    if dev.type == "cpu":
        return query_topk_fused_reference(bundle, q_emb, index, k=k, weights=weights)
    h, r, t, st = index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw
    b, m, d, s = _check_pooled(q_emb, h, r, t, st, dev)
    w = _kernel_weights(bundle, weights, d, s, dev)
    h_dim = w["w1t"].shape[0]
    gate, bias = query_gate_bias(bundle["features"], q_emb)
    scores = torch.empty((b, m), dtype=torch.float32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    _launch(
        POOLED_SOURCE, "pq_forward", "query_topk_fused",
        _ptr(h), _ptr(r), _ptr(t), _ptr(st), _ptr(gate), _ptr(bias), *_weight_args(w),
        _ptr(scores), _ptr(vals), _ptr(ids), b, m, d, h_dim, s, k, _stream(dev),
    )
    query_topk_fused.launches += 1
    return vals, ids


per_question_topk.launches = 0
score_bidirectional.launches = 0
query_topk_fused.launches = 0
