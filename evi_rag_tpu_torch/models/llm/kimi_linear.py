"""Kimi-Linear-48B-A3B (``kimi_linear``) for inference: KDA linear attention
beside MLA without rotation, 3 to 1, and a sparse mixture of experts.

The layer equations are those of the Kimi Linear technical report
(arXiv:2510.26692) and its published modelling file.  A layer listed in
``linear_attn_config["kda_layers"]`` (1-indexed) is a KDA layer; for a
token x, with H heads of d (P = H d):

* q, k, v = SiLU(conv(x W_q)), SiLU(conv(x W_k)), SiLU(conv(x W_v)), each
  conv depthwise and causal over ``short_conv_kernel_size`` taps of its P
  channels (no bias), in f32, the result in the model's type;
* beta = sigmoid(x W_b), one a head; g = -exp(A_log[h]) softplus(x W_fa W_fb
  + dt_bias), the log-decay of each channel, in f32;
* per head the recurrence over the L2-normalised q and k, with the state
  S [d, d] in f32 and o = S^T q^ d^-1/2;

the projections are GEMMs here, the rest of these lines one call of
``ops/kda.py::scan`` (on a card the hand-written kernel);
* y = RMSNorm_head(o) * sigmoid(x W_ga W_gb), the norm's weight shared by
  the heads; out = y W_o.

The other layers are ``models/llm/moonlight.py``'s MLA with the rotation
left out (``cos`` / ``sin`` None: scores over q_nope|q_pe against
k_nope|k_pe, scale (dn + dr)^-1/2), and every layer's MLP or MoE is Moonlight's: the
router scores all ``router_experts`` and the layer computes its held
experts' part.

The cache (``Cache``) holds two kinds of state side by side: the latent
rows of the MLA layers [MLA layers, B, T, r + dr], and for each KDA layer
the recurrent state [B, H, d, d] (f32) and the conv state, the last
(taps - 1) projections of q, k and v side by side [B, taps - 1, 3P].
Prefill of a chunk of right-padded sequences (flat real tokens, each
sequence from position 0) runs the recurrence over each sequence's own
tokens, so every sequence's state ends at its own length; decode runs
runs of one token.  Span: ``kda.scan`` around each prefill launch of the
recurrence (``utils/profiling.py``).

Weights (``init_weights``), [out, in] like ``nn.Linear``: ``embed``,
``norm``, ``lm_head``; per layer ``i`` under ``layers.{i}.``:
``input_norm``, ``post_norm``; a KDA layer ``q_proj``, ``k_proj``,
``v_proj`` [P, D], ``q_conv``, ``k_conv``, ``v_conv`` [P, taps], ``b_proj``
[H, D], ``f_a`` [d, D], ``f_b`` [P, d], ``A_log`` [H] and ``dt_bias`` [P]
(both f32), ``g_a`` [d, D], ``g_b`` [P, d], ``o_norm`` [d], ``o_proj``
[D, P]; an MLA layer Moonlight's ``q_proj``, ``kv_a``, ``kv_norm``,
``kv_b``, ``o_proj``; the MLP or MoE as in Moonlight, the router
[router_experts, D] and the experts [n_routed_experts, ...].
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext

import torch
import torch.nn.functional as F

from evi_rag_tpu_torch.models.llm import moonlight
from evi_rag_tpu_torch.models.llm.config import KimiLinearConfig
from evi_rag_tpu_torch.ops import kda as kda_ops
from evi_rag_tpu_torch.utils import profiling

INIT_STD = 0.02
CONV_STD = 0.25
ROUTER_BIAS_STD = 0.05
A_RANGE = (1.0, 16.0)      # exp(A_log) ~ U(1, 16)
DT_RANGE = (0.001, 0.1)    # softplus(dt_bias) ~ U(0.001, 0.1)


@dataclasses.dataclass
class Cache:
    """A batch's state: ``latent`` [MLA layers, B, T, r + dr], ``state``
    [KDA layers, B, H, d, d] f32, ``conv`` [KDA layers, B, taps - 1, 3P];
    ``rows`` arange(B) and ``ones`` [B] (int32), decode's runs."""

    latent: torch.Tensor
    state: torch.Tensor
    conv: torch.Tensor
    rows: torch.Tensor
    ones: torch.Tensor


def new_cache(cfg: KimiLinearConfig, bsz: int, t_max: int, dtype, device) -> Cache:
    """Zeros (a sequence starts from an empty state; masked latent rows must
    not hold a NaN)."""
    n_kda, n_mla = len(cfg.kda_layers), len(cfg.mla_layers)
    h, d = cfg.kda_heads, cfg.kda_dim
    return Cache(latent=torch.zeros(n_mla, bsz, t_max, cfg.latent_dim, dtype=dtype, device=device),
                 state=torch.zeros(n_kda, bsz, h, d, d, dtype=torch.float32, device=device),
                 conv=torch.zeros(n_kda, bsz, cfg.conv_size - 1, 3 * cfg.kda_width, dtype=dtype, device=device),
                 rows=torch.arange(bsz, dtype=torch.int32, device=device),
                 ones=torch.ones(bsz, dtype=torch.int32, device=device))


def init_weights(cfg: KimiLinearConfig, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Random weights from ``seed``, drawn on ``device``: matrices N(0, 0.02),
    conv taps N(0, 0.25), norm scales 1, exp(A_log) ~ U(1, 16) and
    softplus(dt_bias) ~ U(0.001, 0.1) in f32 (decays that forget in a few
    tokens beside decays that hold across thousands), the router bias
    N(0, 0.05) in f32."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    d, h = cfg.hidden_size, cfg.num_attention_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim
    kh, kd, P = cfg.kda_heads, cfg.kda_dim, cfg.kda_width

    def mat(*shape, std=INIT_STD):
        return torch.randn(*shape, generator=gen, device=device, dtype=dtype).mul_(std)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    def uniform(n, lo, hi):
        return torch.rand(n, generator=gen, device=device).mul_(hi - lo).add_(lo)

    w = {"embed": mat(cfg.vocab_size, d)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        w[p + "input_norm"] = ones(d)
        w[p + "post_norm"] = ones(d)
        if cfg.is_kda(i):
            for name in ("q", "k", "v"):
                w[p + name + "_proj"] = mat(P, d)
                w[p + name + "_conv"] = mat(P, cfg.conv_size, std=CONV_STD)
            w[p + "b_proj"] = mat(kh, d)
            w[p + "f_a"] = mat(kd, d)
            w[p + "f_b"] = mat(P, kd)
            w[p + "A_log"] = uniform(kh, *A_RANGE).log_()
            dt = uniform(P, *DT_RANGE)
            w[p + "dt_bias"] = dt + torch.log(-torch.expm1(-dt))  # softplus^-1
            w[p + "g_a"] = mat(kd, d)
            w[p + "g_b"] = mat(P, kd)
            w[p + "o_norm"] = ones(kd)
            w[p + "o_proj"] = mat(d, P)
        else:
            w[p + "q_proj"] = mat(h * cfg.qk_head_dim, d)
            w[p + "kv_a"] = mat(r + dr, d)
            w[p + "kv_norm"] = ones(r)
            w[p + "kv_b"] = mat(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r)
            w[p + "o_proj"] = mat(d, h * cfg.v_head_dim)
        if cfg.is_moe(i):
            e, ie = cfg.n_routed_experts, cfg.moe_intermediate_size
            w[p + "router"] = mat(cfg.router_experts, d).float()  # the router runs in f32 (bf16 values)
            w[p + "router_bias"] = torch.randn(cfg.router_experts, generator=gen, device=device).mul_(ROUTER_BIAS_STD)
            w[p + "experts.gate_up"] = mat(e, 2 * ie, d)
            w[p + "experts.down"] = mat(e, d, ie)
            w[p + "shared.gate_up"] = mat(2 * cfg.shared_width, d)
            w[p + "shared.down"] = mat(d, cfg.shared_width)
        else:
            w[p + "gate_up"] = mat(2 * cfg.intermediate_size, d)
            w[p + "down"] = mat(d, cfg.intermediate_size)
    w["norm"] = ones(d)
    w["lm_head"] = mat(cfg.vocab_size, d)
    return w


def kda(x, w, p, cfg: KimiLinearConfig, state, conv, slots, starts, lens, prefill: bool = False):
    """A KDA layer over flat normed tokens ``x`` [N, D]: run ``i`` is
    tokens ``starts[i]`` .. ``starts[i] + lens[i] - 1`` from row ``slots[i]``
    of ``state`` [B, H, d, d] and ``conv`` [B, taps - 1, 3P], both advanced
    in place (``ops/kda.py``: the convolutions, gate activations and the
    recurrence; inside span ``kda.scan`` in ``prefill``); returns the out
    projection [N, D]."""
    n, h, d = x.shape[0], cfg.kda_heads, cfg.kda_dim
    q, k, v = (x @ w[p + name + "_proj"].t() for name in ("q", "k", "v"))
    f = (x @ w[p + "f_a"].t()) @ w[p + "f_b"].t()
    taps = tuple(w[p + name + "_conv"] for name in ("q", "k", "v"))
    b = x @ w[p + "b_proj"].t()
    with profiling.span("kda.scan") if prefill else nullcontext():
        o = kda_ops.scan(q, k, v, taps, f, b, w[p + "A_log"], w[p + "dt_bias"], state, conv, slots, starts, lens,
                         d ** -0.5)
    gate = ((x @ w[p + "g_a"].t()) @ w[p + "g_b"].t()).float().view(n, h, d)
    y = F.rms_norm(o.float(), (d,), eps=cfg.rms_norm_eps) * w[p + "o_norm"].float() * torch.sigmoid(gate)
    return y.to(x.dtype).reshape(n, h * d) @ w[p + "o_proj"].t()


def _slots(cfg: KimiLinearConfig) -> dict[int, int]:
    """Each layer's index among the layers of its kind."""
    return {**{i: j for j, i in enumerate(cfg.kda_layers)}, **{i: j for j, i in enumerate(cfg.mla_layers)}}


def prefill(w, cfg: KimiLinearConfig, ids: torch.Tensor, seq: torch.Tensor, pos: torch.Tensor,
            pad_index: torch.Tensor, b: int, lc: int, cache: Cache, last: torch.Tensor,
            rec: moonlight.Record | None = None) -> torch.Tensor:
    """``moonlight.prefill`` for this model: the prompts' latent rows, KDA
    states and conv states into ``cache`` at (seq, pos) / seq; the logits
    of the tokens at ``last``."""
    x = F.embedding(ids, w["embed"])
    slot = _slots(cfg)
    at_last = pos[last]
    runs = (seq[last].int(), (last - at_last).int(), (at_last + 1).int())   # each sequence's row, start, length
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        hn = moonlight.rms_norm(x, w[p + "input_norm"], cfg.rms_norm_eps)
        if cfg.is_kda(i):
            x = x + kda(hn, w, p, cfg, cache.state[slot[i]], cache.conv[slot[i]], *runs, prefill=True)
        else:
            x = x + moonlight.attend_expanded(hn, w, p, cfg, None, None, cache.latent[slot[i]], (seq, pos),
                                              pad_index, b, lc)
        x = x + moonlight.ffn(moonlight.rms_norm(x, w[p + "post_norm"], cfg.rms_norm_eps), w, i, cfg, rec)
    return moonlight.rms_norm(x[last], w["norm"], cfg.rms_norm_eps) @ w["lm_head"].t()


def decode(w, cfg: KimiLinearConfig, tokens: torch.Tensor, pos: torch.Tensor, cache: Cache,
           rec: moonlight.Record | None = None) -> torch.Tensor:
    """One step of ``tokens`` [B] at ``pos`` [B] through the cache; the
    logits [B, V]."""
    x = F.embedding(tokens, w["embed"])
    slot = _slots(cfg)
    rows = (torch.arange(tokens.shape[0], device=tokens.device), pos)
    masked = (torch.arange(cache.latent.shape[2], device=pos.device)[None, :] > pos[:, None])[:, None, :]
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        hn = moonlight.rms_norm(x, w[p + "input_norm"], cfg.rms_norm_eps)
        if cfg.is_kda(i):
            x = x + kda(hn, w, p, cfg, cache.state[slot[i]], cache.conv[slot[i]], cache.rows, cache.rows, cache.ones)
        else:
            x = x + moonlight.attend_absorbed(hn, w, p, cfg, None, None, cache.latent[slot[i]], rows, masked)
        x = x + moonlight.ffn(moonlight.rms_norm(x, w[p + "post_norm"], cfg.rms_norm_eps), w, i, cfg, rec,
                              static=True)
    return moonlight.rms_norm(x, w["norm"], cfg.rms_norm_eps) @ w["lm_head"].t()

