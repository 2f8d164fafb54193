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

The device code they share is ``csrc/twin_score.cuh`` (the struct rows,
the combine, the select) and ``csrc/twin_wgmma.cuh`` (the wgmma mainloop:
bulk-copied W1 tiles, H split across a thread-block cluster); see the notes
in the sources for each design and bound.

* A wrapper launches its kernel for CUDA tensors and counts the launch in
  ``<wrapper>.launches`` (``query_topk_per_query`` counts through
  ``score_bidirectional``).  For CPU tensors it returns the plain version
  and counts nothing; any other device raises.  There is no fallback from
  a kernel to its plain version.
* The kernels take D % 64 == 0, D <= 1024, H % 8 == 0, H <= 1024, an even
  S <= 32 and k <= 1024 (the Pallas kernels take any).  ``kernel_supports``
  states these limits in one place: a router (``serving.serve_split``)
  asks it before it sends a shape to a kernel, and a wrapper called on a
  shape outside them raises.
* A pooled call over more than ``MAX_QUERIES`` queries (the launch grid's
  limit) is launched once per ``query_chunks`` range, each launch counted,
  and the results are joined: the output equals one launch over all
  queries, as the Pallas route takes any B.
* Under ``extras.debug_nans`` a wrapper raises ``FloatingPointError``
  naming its kernel when a floating output holds a NaN
  (``utils.extras.check_kernel_outputs``; ``-inf`` passes).  The plain
  versions run on the CPU under the same check.
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
from evi_rag_tpu_torch.utils.extras import check_kernel_outputs, nan_checks_enabled

KERNEL_SOURCE = "per_question_topk.cu"
SCORE_SOURCE = "score_bidirectional.cu"
POOLED_SOURCE = "pooled_query.cu"
KERNEL_SOURCES = (KERNEL_SOURCE, SCORE_SOURCE, POOLED_SOURCE)
MAX_K = 1024              # the select launch's limit (kMaxK in twin_score.cuh)
MAX_D = MAX_H = 1024      # kMaxD, kMaxH (twin_dims_ok in twin_score.cuh)
MAX_S = 32                # kMaxS
MAX_QUERIES = 65535       # queries of one pooled launch (the grid's y limit); larger calls are chunked
SLICE_N = 128             # H columns per CTA of the pooled kernels (kSliceN in twin_wgmma.cuh)
TILE_K = 64               # k per W1 tile (kChunkK)
EDGE_TILE = 128           # edges per tile of the wgmma kernels (kEdgesCTA)
SCRATCH_BYTES = 1 << 30   # per-call scratch limit; M (pooled) or G (per question) is chunked to keep within it
PQT_CLUSTERS = 0          # per_question_topk's clusters: 0 = as many as the card holds at once (persistent)
_CHUNK_ELEMS = 1 << 27    # plain pooled versions: [B, chunk, D] temporaries of at most this many


def prep_weights(feats: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Split and cast the retriever feature weights for the kernels (W1 in
    bf16, the one type the kernels take; the rest f32).

    Mirrors ``_prep_weights``: W1 row blocks (inter, struct, err, dist), the
    struct-projection halves, and the exact serving fold
    ``w2s = W2 @ w_score``, ``b2s = b2 @ w_score + b_score`` (no
    nonlinearity separates ``state_net_1`` from ``score_head``).  The struct
    projection stays f32, as on the XLA path.  ``w1_tiles`` (``w1_tiles``,
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
        out["w1_tiles"] = w1_tiles(torch.cat([out["w1_inter"], out["w1_struct"], out["w1_err"]]))
    return out


def w1_tiles(w1: torch.Tensor, slice_n: int = SLICE_N) -> torch.Tensor:
    """``W1[:3D]`` ([3D, H]) as the kernels' tile image
    ``[ceil(H / slice_n), 3D / 64, slice_n, 64]``: tile (c, kc) holds
    ``W1[64 kc : 64 kc + 64, slice_n c : slice_n c + slice_n]`` transposed
    (row n = column ``slice_n c + n`` of W1, 64 k contiguous: 128 bytes in
    bf16), with the 16-byte unit j of row n stored at unit ``j ^ (n % 8)``.
    That is the shared-memory image of a K-major, 128-byte-swizzle ``wgmma``
    B operand, so one bulk copy moves a tile.  Columns past H are zero."""
    kk, h = w1.shape
    if kk % TILE_K or slice_n % 8:
        raise ValueError(f"w1 rows {kk} must be a multiple of {TILE_K}, slice width {slice_n} of 8")
    ch = -(-h // slice_n)
    wt = torch.zeros(ch * slice_n, kk, dtype=w1.dtype, device=w1.device)
    wt[:h] = w1.t()
    tiles = wt.reshape(ch, slice_n, kk // TILE_K, 8, 8).permute(0, 2, 1, 3, 4)  # [c, kc, n, unit, 8]
    n = torch.arange(slice_n, device=w1.device)[:, None]
    unit = torch.arange(8, device=w1.device)[None, :] ^ (n % 8)  # stored unit p holds unit p ^ (n % 8)
    return tiles[:, :, n, unit, :].reshape(ch, kk // TILE_K, slice_n, TILE_K).contiguous()


def sc_image(sc_f: torch.Tensor, sc_b: torch.Tensor) -> torch.Tensor:
    """The per-question kernel's struct scratch, laid out as its pre-pass
    writes it on the card (``struct_rows_kernel`` with lengths, in
    ``csrc/twin_wgmma.cuh``): plain version of the layout.

    ``sc_f``, ``sc_b`` are [G, M, D] (the struct contexts of both
    directions).  The result is [G * ceil(M / 128), D / 64, 2, 2, 64, 64]:
    per tile of 128 edges and chunk of 64 columns, the 32 KB A-chunk image a
    slot holds on a struct step, [warpgroup e // 64][direction][row e % 64]
    [64 k], with the 16-byte unit j of row r stored at unit j ^ (r % 8) (the
    128-byte swizzle), so that one bulk copy fills the slot.  Rows of edges
    past M are zero here (the kernel leaves them unwritten: no score reads
    them)."""
    g, m, d = sc_f.shape
    t = -(-m // EDGE_TILE)
    rows = torch.zeros(g, t * EDGE_TILE, 2, d, dtype=sc_f.dtype, device=sc_f.device)
    rows[:, :m, 0], rows[:, :m, 1] = sc_f, sc_b
    # [g, t, wg, row, dir, chunk, unit, 8] -> [g, t, chunk, wg, dir, row, unit, 8]
    img = rows.reshape(g, t, 2, EDGE_TILE // 2, 2, d // TILE_K, 8, 8).permute(0, 1, 5, 2, 4, 3, 6, 7)
    r = torch.arange(EDGE_TILE // 2, device=sc_f.device)[:, None]
    unit = torch.arange(8, device=sc_f.device)[None, :] ^ (r % 8)  # stored unit p holds unit p ^ (r % 8)
    img = img[:, :, :, :, :, r, unit, :]
    return img.reshape(g * t, d // TILE_K, 2, 2, EDGE_TILE // 2, TILE_K).contiguous()


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
    KERNEL_SOURCE: ("pqt", {"forward": [ctypes.c_void_p] * 25 + [ctypes.c_int] * 7 + [ctypes.c_void_p]}),
    SCORE_SOURCE: ("sb", {
        "forward": [ctypes.c_void_p] * 22 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
        "select": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    }),
    POOLED_SOURCE: ("pq", {
        "forward": [ctypes.c_void_p] * 23 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    }),
}


def type_entries(lib: ctypes.CDLL, source: str) -> ctypes.CDLL:
    """Set the argument and result types of ``source``'s C entries on ``lib``."""
    prefix, entries = _ENTRIES[source]
    for name, argtypes in entries.items():
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    err = getattr(lib, f"{prefix}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    lib.error_string = err
    return lib


def _lib(source: str) -> ctypes.CDLL:
    """A kernel library with its C entries typed (built and loaded on first use)."""
    if source not in _LIBS:
        from evi_rag_tpu_torch.ops._build import load_library

        _LIBS[source] = type_entries(load_library(source), source)
    return _LIBS[source]


def _launch(source: str, entry: str, name: str, dev: torch.device, *args: Any) -> None:
    """Call a C entry with ``dev`` as the current device, so that a launch
    for tensors on ``cuda:1`` runs on that card (and sets its attributes
    there), whatever the caller's current device."""
    lib = _lib(source)
    with torch.cuda.device(dev):
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


def _ptr(x: torch.Tensor, offset: int = 0) -> ctypes.c_void_p:
    """The address of element ``offset`` of ``x``'s storage view."""
    return ctypes.c_void_p(x.data_ptr() + offset * x.element_size())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _device_of(name: str, x: torch.Tensor) -> torch.device:
    """cpu or cuda; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {x.device}")
    return x.device


# The kernels' shape limits: per dimension, (what it needs, test).
_LIMITS = {
    "D": (("D % 64 == 0", lambda v: v % 64 == 0), (f"D <= {MAX_D}", lambda v: 0 < v <= MAX_D)),
    "H": (("H % 8 == 0", lambda v: v % 8 == 0), (f"H <= {MAX_H}", lambda v: 0 < v <= MAX_H)),
    "S": (("S % 2 == 0", lambda v: v % 2 == 0), (f"S <= {MAX_S}", lambda v: 0 < v <= MAX_S)),
    "k": ((f"1 <= k <= {MAX_K}", lambda v: 1 <= v <= MAX_K),),
}


def _unmet(dim: str, value: int) -> list[str]:
    return [need for need, ok in _LIMITS[dim] if not ok(value)]


def kernel_limit(d: int, h: int, s: int, k: int) -> str | None:
    """The first of the kernels' shape limits that embedding width ``d``,
    hidden width ``h``, struct width ``s`` and top ``k`` break, as
    ``"D=96: kernel needs D % 64 == 0"``; None when the kernels take the
    shape."""
    for dim, value in (("D", d), ("H", h), ("S", s), ("k", k)):
        unmet = _unmet(dim, value)
        if unmet:
            return f"{dim}={value}: kernel needs {' and '.join(unmet)}"
    return None


def kernel_supports(d: int, h: int, s: int, k: int) -> bool:
    """Whether the kernels take this (D, H, S, k) (k <= M aside): the limits
    that ``_kernel_weights`` and ``_check_k`` raise on."""
    return kernel_limit(d, h, s, k) is None


def query_chunks(b: int) -> list[tuple[int, int]]:
    """(start, stop) query ranges of at most ``MAX_QUERIES``: one pooled
    launch each (one range for B <= ``MAX_QUERIES``, B = 0 included)."""
    return [(b0, min(b0 + MAX_QUERIES, b)) for b0 in range(0, max(b, 1), MAX_QUERIES)]


def _check_k(k: int, m: int) -> None:
    if _unmet("k", k) or k > m:
        raise ValueError(f"the kernels need 1 <= k <= min(M={m}, {MAX_K}), got k={k}")


_F32_WEIGHTS = ("w1_dist", "b1", "ln1_scale", "ln1_bias", "w2s", "b2s", "ws", "bs", "lns_scale",
                "lns_bias", "wg_kernel", "wg_bias")  # the C entries' order, after w1_tiles


def _kernel_weights(
    bundle: dict[str, Any], weights: dict[str, torch.Tensor] | None, d: int, s: int, dev: torch.device
) -> dict[str, torch.Tensor]:
    """The prepared weights, after checking every weight the kernels read.
    The caller holds them until its launch is enqueued (the allocator may
    hand freed memory to the next allocation)."""
    if _unmet("D", d):
        raise ValueError(f"kernel needs D % 64 == 0 and D <= 1024, got D={d}")
    if _unmet("S", s):
        raise ValueError(f"kernel needs an even struct width <= 32, got S={s}")
    w = weights if weights is not None else prep_weights(bundle["features"])
    h_dim = w["w1_dist"].shape[-1]
    if _unmet("H", h_dim):
        raise ValueError(f"kernel needs H % 8 == 0 and H <= 1024, got H={h_dim}")
    shapes = [(1, h_dim), (h_dim,), (h_dim,), (h_dim,), (h_dim, 1), (1,), (s, d), (d,), (d,), (d,),
              (d, 1), (1,)]
    _check("w1_tiles", w["w1_tiles"], torch.bfloat16, (-(-h_dim // SLICE_N), 3 * d // TILE_K, SLICE_N, TILE_K),
           dev, align=16)
    for name, shape in zip(_F32_WEIGHTS, shapes):
        _check(name, w[name], torch.float32, shape, dev)
    return w


def _weight_args(w: dict[str, torch.Tensor]) -> list[Any]:
    """Pointers to the W1 tiles and the f32 weights, in the C entries' order."""
    return [_ptr(w["w1_tiles"])] + [_ptr(w[name]) for name in _F32_WEIGHTS]


def scratch_bytes_per_edge(d: int, h: int, fused: bool) -> int:
    """Device scratch of the kernels per candidate: sc [2, D] bf16 and nav
    [2] f32 (all three), plus c [2, H] f32 (the factorised kernel)."""
    return 2 * d * 2 + 2 * 4 + (2 * h * 4 if fused else 0)


def _edge_chunks(m: int, per_edge: int) -> list[tuple[int, int]]:
    """(start, stop) candidate ranges whose scratch stays within
    ``SCRATCH_BYTES`` (multiples of 128 edges, at least one tile)."""
    step = max(128, SCRATCH_BYTES // per_edge // 128 * 128)
    return [(c0, min(c0 + step, m)) for c0 in range(0, m, step)]


def _question_chunks(g: int, m: int, per_edge: int) -> list[tuple[int, int]]:
    """(start, stop) question ranges of ``per_question_topk`` whose scratch
    (M candidates per question) stays within ``SCRATCH_BYTES`` (at least one
    question per chunk)."""
    step = max(1, SCRATCH_BYTES // (m * per_edge))
    return [(g0, min(g0 + step, g)) for g0 in range(0, g, step)]


def _select(scores: torch.Tensor, k: int, name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of each row of [B, M] f32 scores on the card (the select
    launch of ``csrc/score_bidirectional.cu``): ([B, k] f32, [B, k] int32)."""
    b, m = scores.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    _launch(SCORE_SOURCE, "sb_select", name, scores.device, _ptr(scores), _ptr(vals), _ptr(ids), b, m, k,
            _stream(scores.device))
    return vals, ids


def _pooled_scores(source: str, entry: str, name: str, bundle, q_emb, rows, weights, fused: bool) -> torch.Tensor:
    """[B, M] f32 scores of one pooled kernel, launched once per candidate
    chunk with scratch reused across chunks."""
    h, r, t, st = rows
    dev = h.device
    b, m, d, s = _check_pooled(q_emb, h, r, t, st, dev)
    w = _kernel_weights(bundle, weights, d, s, dev)
    h_dim = w["w1_dist"].shape[-1]
    gate, bias = query_gate_bias(bundle["features"], q_emb)
    scores = torch.empty((b, m), dtype=torch.float32, device=dev)
    chunks = _edge_chunks(m, scratch_bytes_per_edge(d, h_dim, fused))
    n = chunks[0][1]
    scratch = [torch.empty((n, 2, d), dtype=torch.bfloat16, device=dev),
               torch.empty((n, 2), dtype=torch.float32, device=dev)]
    if fused:
        scratch.append(torch.empty((n, 2, h_dim), dtype=torch.float32, device=dev))
    for c0, c1 in chunks:
        _launch(
            source, entry, name, dev,
            _ptr(h, c0 * d), _ptr(r, c0 * d), _ptr(t, c0 * d), _ptr(st, c0 * s), _ptr(gate), _ptr(bias),
            *_weight_args(w), *(_ptr(x) for x in scratch), _ptr(scores, c0), m,
            b, c1 - c0, d, h_dim, s, _stream(dev),
        )
    return scores


def _check_pooled(q_emb, head_repr, rel_repr, tail_repr, struct_raw, dev) -> tuple[int, int, int, int]:
    """(B, M, D, S) of a pooled call, after the kernels' checks: bf16
    candidate rows, f32 queries, all on ``dev``."""
    m, d = head_repr.shape
    b, s = q_emb.shape[0], struct_raw.shape[-1]
    for name, x in (("head_repr", head_repr), ("rel_repr", rel_repr), ("tail_repr", tail_repr)):
        _check(name, x, torch.bfloat16, (m, d), dev)
    _check("struct_raw", struct_raw, torch.bfloat16, (m, s), dev)
    _check("q_emb", q_emb, torch.float32, (b, d), dev)
    if not 1 <= b <= MAX_QUERIES:
        raise ValueError(f"kernel needs 1 <= B <= {MAX_QUERIES} queries, got {b}")
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
    Device scratch per call: sc and nav of every candidate (M rounded up to
    whole tiles of 128), ``scratch_bytes_per_edge(D, H, False)`` bytes each
    (4 KB + 8 B at D = 1024: 128 MiB at G = 16, M = 2048), G cut into
    question chunks so that it stays within ``SCRATCH_BYTES`` (1 GiB),
    besides the [G, M] f32 scores.
    """
    dev = _device_of("per_question_topk", head_repr)
    if dev.type == "cpu":
        vals, ids = per_question_topk_reference(
            bundle, q_emb, head_repr, rel_repr, tail_repr, struct_raw, lengths, k=k, weights=weights
        )
        check_kernel_outputs("per_question_topk", vals)
        return vals, ids
    g_n, m, d = head_repr.shape
    s = struct_raw.shape[-1]
    bf16 = torch.bfloat16
    for name, x in (("head_repr", head_repr), ("rel_repr", rel_repr), ("tail_repr", tail_repr)):
        _check(name, x, bf16, (g_n, m, d), dev)
    _check("struct_raw", struct_raw, bf16, (g_n, m, s), dev)
    _check("lengths", lengths, torch.int32, (g_n,), dev, align=4)
    _check("q_emb", q_emb, torch.float32, (g_n, d), dev)
    w = _kernel_weights(bundle, weights, d, s, dev)
    h_dim = w["w1_dist"].shape[-1]
    _check_k(k, m)
    if not 1 <= g_n <= 65535:
        raise ValueError(f"kernel needs 1 <= G <= 65535 questions, got {g_n}")
    gate, bias = query_gate_bias(bundle["features"], q_emb)
    scores = torch.empty((g_n, m), dtype=torch.float32, device=dev)
    vals = torch.empty((g_n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((g_n, k), dtype=torch.int32, device=dev)
    m_tiles = -(-m // EDGE_TILE) * EDGE_TILE  # sc is kept as whole tiles of edges (A-chunk images)
    chunks = _question_chunks(g_n, m_tiles, scratch_bytes_per_edge(d, h_dim, False))
    sc = torch.empty(((chunks[0][1] - chunks[0][0]) * m_tiles, 2, d), dtype=bf16, device=dev)
    nav = torch.empty(((chunks[0][1] - chunks[0][0]) * m, 2), dtype=torch.float32, device=dev)
    for g0, g1 in chunks:
        _launch(
            KERNEL_SOURCE, "pqt_forward", "per_question_topk", dev,
            _ptr(lengths, g0), _ptr(head_repr, g0 * m * d), _ptr(rel_repr, g0 * m * d),
            _ptr(tail_repr, g0 * m * d), _ptr(struct_raw, g0 * m * s), _ptr(gate, g0 * d), _ptr(bias, g0 * d),
            *_weight_args(w), _ptr(sc), _ptr(nav), _ptr(scores, g0 * m), _ptr(vals, g0 * k), _ptr(ids, g0 * k),
            g1 - g0, m, d, h_dim, s, k, PQT_CLUSTERS, _stream(dev),
        )
    per_question_topk.launches += 1
    if nan_checks_enabled():  # the scores of each question's prefix too: a NaN may rank below -inf
        valid = torch.arange(m, device=dev)[None, :] < lengths[:, None]
        check_kernel_outputs("per_question_topk", vals, scores[valid])
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

    CUDA tensors launch ``csrc/score_bidirectional.cu`` once per chunk of
    candidates (per ``query_chunks`` range); CPU tensors take the plain version
    (``score_bidirectional_reference``).  Device scratch per call: sc and
    nav, ``scratch_bytes_per_edge(D, H, False)`` bytes per candidate (4 KB +
    8 B at D = 1024: 512 MiB at M = 131,072), M chunked so that it stays
    within ``SCRATCH_BYTES`` (1 GiB), besides the [B, M] f32 scores.
    """
    dev = _device_of("score_bidirectional", head_repr)
    rows = (head_repr, rel_repr, tail_repr, struct_raw)
    parts = []
    for b0, b1 in query_chunks(q_emb.shape[0]):
        if dev.type == "cpu":
            parts.append(score_bidirectional_reference(bundle, q_emb[b0:b1], *rows, weights=weights))
        else:
            parts.append(_pooled_scores(SCORE_SOURCE, "sb_forward", "score_bidirectional", bundle,
                                        q_emb[b0:b1], rows, weights, fused=False))
            score_bidirectional.launches += 1
    scores = parts[0] if len(parts) == 1 else torch.cat(parts)
    check_kernel_outputs("score_bidirectional", scores)
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
    return _select(scores, k, "query_topk_per_query")


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

    CUDA tensors launch ``csrc/pooled_query.cu`` once per chunk of
    candidates (scores), then one exact select, per ``query_chunks`` range;
    CPU tensors take the plain
    version (``query_topk_fused_reference``).  Device scratch per call: sc,
    nav and the per-edge terms c, ``scratch_bytes_per_edge(D, H, True)``
    bytes per candidate (12 KB + 8 B at D = H = 1024), M chunked so that it
    stays within ``SCRATCH_BYTES`` (1 GiB: chunks of 87,296 candidates at
    that width), besides the [B, M] f32 scores (64 MiB at B = 128,
    M = 131,072).
    """
    dev = _device_of("query_topk_fused", index.head_repr)
    _check_k(k, index.num_candidates)
    vals, ids = [], []
    for b0, b1 in query_chunks(q_emb.shape[0]):
        if dev.type == "cpu":
            v, i = query_topk_fused_reference(bundle, q_emb[b0:b1], index, k=k, weights=weights)
            check_kernel_outputs("query_topk_fused", v)
        else:
            rows = (index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
            scores = _pooled_scores(POOLED_SOURCE, "pq_forward", "query_topk_fused", bundle, q_emb[b0:b1], rows,
                                    weights, fused=True)
            query_topk_fused.launches += 1
            check_kernel_outputs("query_topk_fused", scores)
            v, i = _select(scores, k, "query_topk_fused")
        vals.append(v)
        ids.append(i)
    if len(vals) == 1:
        return vals[0], ids[0]
    return torch.cat(vals), torch.cat(ids)


per_question_topk.launches = 0
score_bidirectional.launches = 0
query_topk_fused.launches = 0
