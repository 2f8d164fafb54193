"""Moonlight-16B-A3B (``deepseek_v3``) for inference: multi-head latent
attention over a latent cache, and a sparse mixture of experts.

The layer equations are those of Hugging Face's ``DeepseekV3`` modelling:

* RMSNorm in f32, scaled by its weight in the model's type;
* attention: q = x W_q (no low-rank q), split per head into a 128-wide
  part without position and a 64-wide rope part; the kv projection gives a
  512-wide latent c (RMS-normalised) and one 64-wide rope key shared by the
  heads; k_nope and v come from c through ``kv_b``; rope pairs neighbouring
  dims (x[2i], x[2i + 1]) and lays the result out evens first, as HF's
  interleaved rope does; softmax scale (128 + 64)^-0.5;
* the MoE of layers from ``first_k_dense_replace``: sigmoid router scores
  computed in f32; the experts chosen by score + ``e_score_correction_bias``
  (``noaux_tc`` with one group), weighted by the scores without the bias,
  renormalised over the chosen and scaled by ``routed_scaling_factor``;
  y = shared(x) + sum_i w_i expert_i(x); every MLP is down(silu(gate x) *
  up x).

Two forms of attention compute the same thing.  Prefill takes the expanded
form (k and v per head from the latent, causal attention over the prompt).
Decode takes the absorbed form: W_UK is folded into q (q_lat = q_nope W_UK
per head), scores are [q_lat, q_rope] against the cached rows [c, k_rope],
the probabilities average c, and W_UV maps the result to each head's v.
A cache row is c and the rope key: (512 + 64) values a token and layer.

Routed experts run as grouped products: the (token, expert) pairs sorted by
expert, one ``torch._grouped_mm`` for the fused gate and up projections and
one for the down projection, per layer.  The expert layer is told which
experts it holds (``cfg.n_routed_experts`` of the ``cfg.router_experts`` the
router scores, ids from 0): it routes over all of them and computes the part
of the result its own experts give (Moonlight holds all 64).

The attention, router and expert functions serve Kimi-Linear's MLA and MoE
layers too (``models/llm/kimi_linear.py``), whose MLA has no rotation: given
``cos`` / ``sin`` None, the rope parts of q and of the cache row pass
unrotated.

Weights (``init_weights``) live in one dict, [out, in] like ``nn.Linear``:
``embed`` [V, D], ``norm`` [D], ``lm_head`` [V, D]; per layer ``i`` under
``layers.{i}.``: ``input_norm``, ``post_norm`` [D], ``q_proj``
[H (dn + dr), D], ``kv_a`` [r + dr, D], ``kv_norm`` [r], ``kv_b``
[H (dn + dv), r], ``o_proj`` [D, H dv]; a dense layer ``gate_up`` [2 I, D]
(gate rows first) and ``down`` [D, I]; an MoE layer ``router`` [E, D],
``router_bias`` [E] (both f32; the router holds bf16 values), ``experts.gate_up`` [E, 2 I_e, D],
``experts.down`` [E, D, I_e], ``shared.gate_up`` [2 I_s, D] and
``shared.down`` [D, I_s].
"""

from __future__ import annotations

from contextlib import nullcontext

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from evi_rag_tpu_torch.models.llm.config import MoonlightConfig

INIT_STD = 0.02
ROUTER_BIAS_STD = 0.05


def init_weights(cfg: MoonlightConfig, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Random weights from ``seed``, drawn on ``device``: every matrix
    N(0, 0.02), every norm scale 1, the router bias N(0, 0.05) in f32 (uneven
    routing that does not collapse)."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    d, h = cfg.hidden_size, cfg.num_attention_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_head_dim

    def mat(*shape):
        return torch.randn(*shape, generator=g, device=device, dtype=dtype).mul_(INIT_STD)

    def ones(n):
        return torch.ones(n, device=device, dtype=dtype)

    w = {"embed": mat(cfg.vocab_size, d)}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        w[p + "input_norm"] = ones(d)
        w[p + "post_norm"] = ones(d)
        w[p + "q_proj"] = mat(h * cfg.qk_head_dim, d)
        w[p + "kv_a"] = mat(r + dr, d)
        w[p + "kv_norm"] = ones(r)
        w[p + "kv_b"] = mat(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), r)
        w[p + "o_proj"] = mat(d, h * cfg.v_head_dim)
        if cfg.is_moe(i):
            e, ie = cfg.n_routed_experts, cfg.moe_intermediate_size
            w[p + "router"] = mat(e, d).float()  # the router runs in f32 (bf16 values)
            w[p + "router_bias"] = torch.randn(e, generator=g, device=device).mul_(ROUTER_BIAS_STD)
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


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return weight * F.rms_norm(x.float(), (x.shape[-1],), eps=eps).to(x.dtype)


def rope_tables(cfg: MoonlightConfig, pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin [..., dr] (f32) at integer positions ``pos``."""
    dr = cfg.qk_rope_head_dim
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(0, dr, 2, device=pos.device, dtype=torch.float32) / dr))
    ang = pos.float()[..., None] * inv
    ang = torch.cat((ang, ang), -1)
    return ang.cos(), ang.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2i], x[2i + 1]) of the last dim; the result lies
    evens first.  ``cos`` / ``sin`` broadcast against ``x``."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2).float()
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat((-x2, x1), -1) * sin


def new_cache(cfg: MoonlightConfig, bsz: int, t_max: int, dtype, device) -> torch.Tensor:
    """The latent cache [layers, B, T, r + dr] of a batch.  Zeros: rows past
    a sequence's end are masked, and a masked row must not hold a NaN for
    the probabilities' zeros to meet."""
    return torch.zeros(cfg.num_hidden_layers, bsz, t_max, cfg.latent_dim, dtype=dtype, device=device)


def mlp(x: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    gu = x @ gate_up.t()
    g, u = gu.chunk(2, -1)
    return (F.silu(g) * u) @ down.t()


def route(x: torch.Tensor, w: dict[str, torch.Tensor], p: str, cfg: MoonlightConfig):
    """(expert ids [N, k], weights [N, k] f32): chosen by score + bias,
    weighted by the score, renormalised and scaled."""
    scores = torch.sigmoid(x.float() @ w[p + "router"].t())
    ids = torch.topk(scores + w[p + "router_bias"], cfg.num_experts_per_tok, dim=-1, sorted=False).indices
    wts = scores.gather(1, ids)
    if cfg.norm_topk_prob:
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    return ids, wts * cfg.routed_scaling_factor


class Record:
    """What a forward keeps of its MoE layers, in order: ``load`` each
    layer's tokens per expert [E], ``routes`` each layer's chosen experts
    [N, k]; a kind not asked for stays None."""

    def __init__(self, load: bool = False, routes: bool = False):
        self.load = [] if load else None
        self.routes = [] if routes else None


def moe(x: torch.Tensor, w: dict[str, torch.Tensor], p: str, cfg: MoonlightConfig,
        rec: Record | None = None, static: bool = False) -> torch.Tensor:
    """Shared experts plus the routed experts held here of flat tokens ``x``
    [N, D]: pairs sorted by expert, two grouped products, the routing weight
    applied between them (the down projection is linear); each token's k
    results summed in a fixed order (f32 sums), a pair routed to an expert
    not held adding nothing.  With every expert held nothing here waits on
    the card.  With a share, the held pairs (sorted first) are counted on
    the host, one wait a layer, and only they are gathered; ``static``
    (a step captured in a CUDA graph) gathers every pair instead and zeroes
    those past the held ones."""
    n, k, held = x.shape[0], cfg.num_experts_per_tok, cfg.n_routed_experts
    ids, wts = route(x, w, p, cfg)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(cfg.router_experts, dtype=torch.long, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))  # bincount would wait for the card to size its output
    if rec is not None and rec.load is not None:
        rec.load.append(counts)
    if rec is not None and rec.routes is not None:
        rec.routes.append(ids)
    offs = torch.cumsum(counts[:held], 0).to(torch.int32)
    share = held < cfg.router_experts
    rows = order if not share or static else order[:int(offs[-1])]
    gu = torch._grouped_mm(x[rows // k], w[p + "experts.gate_up"].transpose(-2, -1), offs=offs)
    g, u = gu.chunk(2, -1)
    act = F.silu(g) * u * wts.reshape(-1)[rows, None].to(x.dtype)
    ys = torch._grouped_mm(act, w[p + "experts.down"].transpose(-2, -1), offs=offs)
    if share and static:  # rows past the last offset hold whatever the products left there
        ys = torch.where(torch.arange(n * k, device=x.device)[:, None] < offs[-1], ys, 0)
    y = ys.new_zeros(n * k, ys.shape[1]) if share and not static else torch.empty_like(ys)
    y[rows] = ys
    return mlp(x, w[p + "shared.gate_up"], w[p + "shared.down"]) + y.view(n, k, -1).sum(1)


def ffn(x: torch.Tensor, w: dict[str, torch.Tensor], i: int, cfg: MoonlightConfig, rec: Record | None,
        static: bool = False):
    p = f"layers.{i}."
    if cfg.is_moe(i):
        return moe(x, w, p, cfg, rec, static)
    return mlp(x, w[p + "gate_up"], w[p + "down"])


def latent(x: torch.Tensor, w: dict[str, torch.Tensor], p: str, cfg: MoonlightConfig,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Cache rows [N, r + dr] of normed tokens ``x``: the normalised latent
    and the rope key at the tokens' positions (unrotated, ``cos`` None)."""
    r = cfg.kv_lora_rank
    kv = x @ w[p + "kv_a"].t()
    c = rms_norm(kv[:, :r], w[p + "kv_norm"], cfg.rms_norm_eps)
    return torch.cat((c, kv[:, r:] if cos is None else apply_rope(kv[:, r:], cos, sin).to(x.dtype)), -1)


def queries(x: torch.Tensor, w: dict[str, torch.Tensor], p: str, cfg: MoonlightConfig,
            cos: torch.Tensor, sin: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(q_nope [N, H, dn], q_rope [N, H, dr]) of normed tokens ``x``
    (q_rope unrotated, ``cos`` None)."""
    h, dn = cfg.num_attention_heads, cfg.qk_nope_head_dim
    q = (x @ w[p + "q_proj"].t()).view(-1, h, cfg.qk_head_dim)
    if cos is None:
        return q[..., :dn], q[..., dn:]
    return q[..., :dn], apply_rope(q[..., dn:], cos[:, None], sin[:, None]).to(x.dtype)


def attend_expanded(x, w, p, cfg, cos, sin, cache, slot, pad_index, b: int, lc: int):
    """Causal attention of flat normed prompt tokens ``x`` [N, D], expanded
    form.  Token j lies at ``pad_index[j]`` of a right-padded [b, lc] block
    (each sequence from position 0).  Writes the tokens' cache rows into
    ``cache`` [B, T, r + dr] at ``slot`` (sequence, position); returns the
    o projection [N, D]."""
    h, dn, dv, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    q_nope, q_rope = queries(x, w, p, cfg, cos, sin)
    rows = latent(x, w, p, cfg, cos, sin)
    cache[slot] = rows
    kv = (rows[:, :r] @ w[p + "kv_b"].t()).view(-1, h, dn + dv)
    n = x.shape[0]
    q = torch.cat((q_nope, q_rope), -1)
    k = torch.cat((kv[..., :dn], rows[:, None, r:].expand(n, h, -1)), -1)
    pad = lambda t: t.new_zeros(b * lc, h, t.shape[-1]).index_copy_(0, pad_index, t).view(b, lc, h, -1).transpose(1, 2)  # noqa: E731
    # v widened with zeros to q's width, so that flash attention takes it:
    # cuDNN's, chosen otherwise on a card, plans each new shape on the host.
    v = F.pad(kv[..., dn:], (0, cfg.qk_head_dim - dv))
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]) if x.is_cuda else nullcontext():
        o = F.scaled_dot_product_attention(pad(q), pad(k), pad(v), is_causal=True, scale=cfg.qk_head_dim ** -0.5)
    o = o[..., :dv].transpose(1, 2).reshape(b * lc, h * dv).index_select(0, pad_index)
    return o @ w[p + "o_proj"].t()


def attend_absorbed(x, w, p, cfg, cos, sin, cache, slot, masked):
    """One decode token per sequence (normed ``x`` [B, D]; ``slot`` =
    (arange(B), positions)), absorbed form: writes its cache row into
    ``cache`` [B, T, r + dr] at its position and attends over rows 0..pos of
    its own sequence (``masked`` [B, 1, T]: the rows past it).  Returns the
    o projection [B, D]."""
    h, dn, dv, r = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    bsz = x.shape[0]
    q_nope, q_rope = queries(x, w, p, cfg, cos, sin)
    cache[slot] = latent(x, w, p, cfg, cos, sin)
    wkv = w[p + "kv_b"].view(h, dn + dv, r)
    q_lat = torch.bmm(q_nope.transpose(0, 1), wkv[:, :dn]).transpose(0, 1)        # [B, H, r]
    s = torch.bmm(torch.cat((q_lat, q_rope), -1), cache.transpose(1, 2)).float()  # [B, H, T]
    s = s.masked_fill(masked, float("-inf"))
    prob = torch.softmax(s * cfg.qk_head_dim ** -0.5, -1).to(x.dtype)
    o_lat = torch.bmm(prob, cache[..., :r])                                        # [B, H, r]
    o = torch.bmm(o_lat.transpose(0, 1), wkv[:, dn:].transpose(1, 2))            # [H, B, dv]
    return o.transpose(0, 1).reshape(bsz, h * dv) @ w[p + "o_proj"].t()


def prefill(w, cfg: MoonlightConfig, ids: torch.Tensor, seq: torch.Tensor, pos: torch.Tensor,
            pad_index: torch.Tensor, b: int, lc: int, cache: torch.Tensor, last: torch.Tensor,
            rec: Record | None = None) -> torch.Tensor:
    """Forward of flat prompt tokens ``ids`` [N] of sequences ``seq`` at
    positions ``pos`` (places ``pad_index`` in a right-padded [b, lc]
    block): writes every layer's cache rows into ``cache`` [layers, B, T,
    r + dr] at (seq, pos) and returns the logits of the tokens at ``last``
    [b] (each sequence's last)."""
    x = F.embedding(ids, w["embed"])
    cos, sin = rope_tables(cfg, pos)
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        x = x + attend_expanded(rms_norm(x, w[p + "input_norm"], cfg.rms_norm_eps), w, p, cfg, cos, sin,
                                cache[i], (seq, pos), pad_index, b, lc)
        x = x + ffn(rms_norm(x, w[p + "post_norm"], cfg.rms_norm_eps), w, i, cfg, rec)
    return rms_norm(x[last], w["norm"], cfg.rms_norm_eps) @ w["lm_head"].t()


def decode(w, cfg: MoonlightConfig, tokens: torch.Tensor, pos: torch.Tensor, cache: torch.Tensor,
           rec: Record | None = None) -> torch.Tensor:
    """One step: ``tokens`` [B] at ``pos`` [B] through every layer's cache
    ``cache`` [layers, B, T, r + dr], T past the batch's last position
    (rows past each sequence's position are masked); returns the logits
    [B, V]."""
    x = F.embedding(tokens, w["embed"])
    cos, sin = rope_tables(cfg, pos)
    slot = (torch.arange(tokens.shape[0], device=tokens.device), pos)
    masked = (torch.arange(cache.shape[2], device=pos.device)[None, :] > pos[:, None])[:, None, :]
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        x = x + attend_absorbed(rms_norm(x, w[p + "input_norm"], cfg.rms_norm_eps), w, p, cfg, cos, sin,
                                cache[i], slot, masked)
        x = x + ffn(rms_norm(x, w[p + "post_norm"], cfg.rms_norm_eps), w, i, cfg, rec, static=True)
    return rms_norm(x, w["norm"], cfg.rms_norm_eps) @ w["lm_head"].t()
