"""The KDA (Kimi Delta Attention) recurrence with the short convolutions and
gate activations that feed it: ``scan`` runs it over each sequence's own
run of tokens, from and into a recurrent-state and a conv-state cache.

For a CUDA tensor it launches the hand-written kernel of
``csrc/kda_recurrence.cu`` (``kda_scan_kernel``, heads of 128, 4 conv taps)
on the current stream, so that a captured decode step holds it, and counts
the launch in ``scan.launches``; on the CPU the plain route below computes
the same thing token by token.  Both read a
sequence's states once and write them once, convolve in f32 and round the
activated q, k, v to the projections' type (as the published convolution
does), normalise q and k per head (L2, eps 1e-6), scale the output by
``scale`` and sum in f32; a run of length 0 is skipped.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

SOURCE = "kda_recurrence.cu"
DIM = 128            # the kernel's head width (d_k = d_v)
TAPS = 4             # the kernel's conv taps
NORM_EPS = 1e-6

_LIB: list[ctypes.CDLL] = []


def _lib() -> ctypes.CDLL:
    if not _LIB:
        from evi_rag_tpu_torch.ops._build import load_library

        lib = load_library(SOURCE)
        lib.kda_scan.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        lib.kda_scan.restype = ctypes.c_int
        lib.kda_error_string.argtypes = [ctypes.c_int]
        lib.kda_error_string.restype = ctypes.c_char_p
        _LIB.append(lib)
    return _LIB[0]


def scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, taps: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
         f: torch.Tensor, b: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor, state: torch.Tensor,
         conv: torch.Tensor, slots: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor,
         scale: float) -> torch.Tensor:
    """o [N, H, d] (q's type) of flat tokens.  ``q``, ``k``, ``v`` [N, P]
    are the projections before the convolutions (P = H d), ``taps`` their
    depthwise taps [P, W] each, ``f`` [N, P] the decay's low-rank
    projection (before ``dt_bias`` [P]), ``b`` [N, H] beta's (before the
    sigmoid), ``a_log`` [H] (f32 both).  Run ``i`` is tokens ``starts[i]``
    .. ``starts[i] + lens[i] - 1``, from row ``slots[i]`` of ``state``
    [B, H, d, d] (f32, d_k by d_v) and of ``conv`` [B, W - 1, 3P] (the last
    raw q, k, v projections, oldest first), both updated in place.
    ``slots``, ``starts``, ``lens`` are int32; tokens outside every run keep
    an undefined output."""
    if q.is_cuda:
        return _scan_cuda(q, k, v, taps, f, b, a_log, dt_bias, state, conv, slots, starts, lens, scale)
    return scan_plain(q, k, v, taps, f, b, a_log, dt_bias, state, conv, slots, starts, lens, scale)


def _scan_cuda(q, k, v, taps, f, b, a_log, dt_bias, state, conv, slots, starts, lens, scale):
    n, width = q.shape
    h = a_log.shape[0]
    d = width // h
    if d != DIM or taps[0].shape[1] != TAPS:
        raise ValueError(f"kda_scan takes heads of {DIM} and {TAPS} conv taps, not {d} and {taps[0].shape[1]}")
    want = dict(q=(q, torch.bfloat16, (n, width)), k=(k, torch.bfloat16, (n, width)), v=(v, torch.bfloat16, (n, width)),
                q_taps=(taps[0], torch.bfloat16, (width, TAPS)), k_taps=(taps[1], torch.bfloat16, (width, TAPS)),
                v_taps=(taps[2], torch.bfloat16, (width, TAPS)), f=(f, torch.bfloat16, (n, width)),
                b=(b, torch.bfloat16, (n, h)), a_log=(a_log, torch.float32, (h,)),
                dt_bias=(dt_bias, torch.float32, (width,)), state=(state, torch.float32, (state.shape[0], h, d, d)),
                conv=(conv, torch.bfloat16, (state.shape[0], TAPS - 1, 3 * width)),
                slots=(slots, torch.int32, lens.shape), starts=(starts, torch.int32, lens.shape),
                lens=(lens, torch.int32, lens.shape))
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != tuple(shape) or not x.is_contiguous() or x.device != q.device:
            raise ValueError(f"kda_scan: {name} must be a contiguous {dtype} {tuple(shape)} on {q.device}, "
                             f"not {x.dtype} {tuple(x.shape)} on {x.device}")
    o = torch.empty_like(q)
    lib = _lib()
    ptrs = [ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, *taps, f, b, a_log, dt_bias, state, conv, slots, starts,
                                                    lens, o)]
    with torch.cuda.device(q.device):
        rc = lib.kda_scan(*ptrs, int(lens.shape[0]), h, d, TAPS, float(scale),
                          ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"kda_scan launch failed: {lib.kda_error_string(rc).decode()}")
    scan.launches += 1
    return o.view(n, h, d)


def l2norm(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + NORM_EPS)


def scan_plain(q, k, v, taps, f, b, a_log, dt_bias, state, conv, slots, starts, lens, scale):
    """``scan`` in torch, token by token (every head at once)."""
    n, width = q.shape
    h = a_log.shape[0]
    d, w = width // h, taps[0].shape[1]
    o = torch.zeros(n, h, d, dtype=torch.float32, device=q.device)
    decay = torch.exp(-a_log.exp()[:, None] * F.softplus(f.float().view(n, h, d) + dt_bias.view(h, d)))
    beta = torch.sigmoid(b.float())
    for slot, start, m in zip(slots.tolist(), starts.tolist(), lens.tolist()):
        if m <= 0:
            continue
        acts = []
        for j, (raw, tap) in enumerate(zip((q, k, v), taps)):
            hist = torch.cat((conv[slot, :, j * width:(j + 1) * width], raw[start:start + m]))   # [w - 1 + m, P]
            y = sum(hist[i:i + m].float() * tap[:, i].float() for i in range(w))
            conv[slot, :, j * width:(j + 1) * width] = hist[m:]
            acts.append(F.silu(y).to(raw.dtype).float().view(m, h, d))
        qn, kn, vv = l2norm(acts[0]), l2norm(acts[1]), acts[2]
        s = state[slot].float()
        for t in range(m):
            s = s * decay[start + t][:, :, None]
            u = beta[start + t][:, None] * (vv[t] - torch.einsum("hk,hkv->hv", kn[t], s))
            s = s + kn[t][:, :, None] * u[:, None, :]
            o[start + t] = torch.einsum("hk,hkv->hv", qn[t], s) * scale
        state[slot] = s.to(state.dtype)
    return o.to(q.dtype)


scan.launches = 0
