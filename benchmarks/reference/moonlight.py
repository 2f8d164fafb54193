"""Moonlight-16B-A3B (``deepseek_v3``) in plain PyTorch: the yardstick the
program's logits are held to.

A full causal forward over each sequence, in float32 with TF32 off: no
cache, no batching, no kernel; the MoE per token over all experts' router
scores, each expert applied to the tokens that chose it.  A caller may give
the experts another forward took instead: with random weights one rounding
flips near-tied choices, a flip moves that token's layer output by O(1)
and attention spreads it to every later token, so the reference then
follows the compared forward's choices and reports how far each lies below
its own (the route gap).  Written from the published description (Hugging Face ``DeepseekV3``: RMSNorm; MLA with
q = x W_q, a normalised kv latent, k_nope and v from it through ``kv_b``, a
rope key shared by the heads, rope on neighbouring pairs laid out evens
first, softmax scale (dn + dr)^-0.5; sigmoid routing chosen by score + bias
and weighted by the renormalised, scaled scores without it; shared experts
added; SiLU-gated MLPs).

Departures from the published model: every product and sum in float32 (the
published model runs in bfloat16, its router in float32); no multi-token
prediction layer (``num_nextn_predict_layers`` 0); one routing group
(``n_group`` = ``topk_group`` = 1, where group-limited choice is the plain
top-k); no rope scaling (the configuration gives none).

Weights come as a mapping of the names below, in any type; each layer's
are upcast to float32 when the layer runs (``weight_cast`` first rounds
each matrix, as the control does): ``embed``, ``norm``, ``lm_head``; per
layer ``layers.{i}.``: ``input_norm``, ``post_norm``, ``q_proj``, ``kv_a``,
``kv_norm``, ``kv_b``, ``o_proj``; ``gate_up`` (gate rows, then up rows)
and ``down`` in the dense layers; ``router``, ``router_bias``,
``experts.gate_up`` [E, 2 I, D], ``experts.down`` [E, D, I],
``shared.gate_up``, ``shared.down`` in the MoE layers.  Matrices are
[out, in].

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Mapping, Sequence

import torch


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: TF32 off while the reference runs."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32)
    m.allow_tf32, torch.backends.cudnn.allow_tf32 = False, False
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale a tensor (its
    largest magnitude to 448): the control's weights."""
    s = t.abs().max().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def _rope(x, pos, dim, theta):
    """Rotate pairs (x[2i], x[2i+1]) by pos * theta^(-2i/dim); the result
    lies evens first (HF's interleaved layout)."""
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32, device=x.device) / dim)
    ang = pos[:, None].float() * inv                      # [L, dim / 2]
    cos, sin = ang.cos(), ang.sin()
    if x.dim() == 3:
        cos, sin = cos[:, None], sin[:, None]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.cat((a * cos - b * sin, b * cos + a * sin), -1)


def _mlp(x, gate_up, down):
    g, u = gate_up.chunk(2, 0)
    return (torch.nn.functional.silu(x @ g.t()) * (x @ u.t())) @ down.t()


def _attention(x, lw, c):
    L = x.shape[0]
    h, dn, dr, dv, r = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                        c["v_head_dim"], c["kv_lora_rank"])
    pos = torch.arange(L, device=x.device)
    q = (x @ lw["q_proj"].t()).view(L, h, dn + dr)
    q = torch.cat((q[..., :dn], _rope(q[..., dn:], pos, dr, c["rope_theta"])), -1)
    kv_a = x @ lw["kv_a"].t()
    lat = _norm(kv_a[:, :r], lw["kv_norm"], c["rms_norm_eps"])
    k_rope = _rope(kv_a[:, r:], pos, dr, c["rope_theta"])
    kv = (lat @ lw["kv_b"].t()).view(L, h, dn + dv)
    k = torch.cat((kv[..., :dn], k_rope[:, None, :].expand(L, h, dr)), -1)
    v = kv[..., dn:]
    s = torch.einsum("qhd,khd->hqk", q, k) * (dn + dr) ** -0.5
    s = s.masked_fill(torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
    o = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    return o.reshape(L, h * dv) @ lw["o_proj"].t()


def _moe(x, lw, c, given=None):
    """(output, the experts taken [L, k], route gap): the experts ``given``
    [L, k] where there are some, else the top k by score + bias; the gap is
    the widest margin by which a given expert's score + bias lies below the
    k-th best (0 without ``given``)."""
    scores = torch.sigmoid(x @ lw["router"].t())                       # [L, E]
    choice = scores + lw["router_bias"]
    k = c["num_experts_per_tok"]
    gap = 0.0
    if given is None:
        chosen = torch.topk(choice, k, dim=-1).indices
    else:
        chosen = given.to(x.device)
        kth = torch.topk(choice, k, dim=-1).values[:, -1:]
        gap = float((kth - choice.gather(1, chosen)).clamp(min=0).max())
    wts = scores.gather(1, chosen)
    if c["norm_topk_prob"]:
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    wts = wts * c["routed_scaling_factor"]
    out = _mlp(x, lw["shared.gate_up"], lw["shared.down"])
    for e in range(c["n_routed_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            y = _mlp(x[tok], lw["experts.gate_up"][e], lw["experts.down"][e])
            out = out.index_add(0, tok, y * wts[tok, slot][:, None])
    return out, chosen, gap


def forward(weights: Mapping[str, torch.Tensor], config: Mapping, seqs: Sequence[torch.Tensor],
            starts: Sequence[int], weight_cast: Callable[[torch.Tensor], torch.Tensor] | None = None,
            routes: Sequence[torch.Tensor] | None = None):
    """A full causal forward of each sequence of ids: (the f32 logits
    [len - start, V] at its positions ``start`` .. len - 1, the experts each
    position took [MoE layers, len, k], the route gap).  ``routes`` (one
    [MoE layers, len, k] a sequence) makes every MoE layer take the given
    experts; the route gap is then the widest margin by which a given
    expert's score + bias lies below the k-th best of this forward's own
    scores (0 without ``routes``).  The layers run one at a time over all
    sequences (one layer's f32 weights at a time)."""
    c = config
    eps = c["rms_norm_eps"]
    cast = weight_cast or (lambda t: t)

    def get(name):
        t = weights[name].float()
        return cast(t) if t.dim() >= 2 else t

    with exact_f32(), torch.no_grad():
        emb = get("embed")
        xs = [emb[s.to(emb.device)] for s in seqs]
        del emb
        taken: list[list[torch.Tensor]] = [[] for _ in seqs]
        gap = 0.0
        for i in range(c["num_hidden_layers"]):
            p = f"layers.{i}."
            names = [k[len(p):] for k in weights if k.startswith(p)]
            lw = {k: get(p + k) for k in names}
            moe = i >= c["first_k_dense_replace"]
            for j, x in enumerate(xs):
                x = x + _attention(_norm(x, lw["input_norm"], eps), lw, c)
                hn = _norm(x, lw["post_norm"], eps)
                if moe:
                    given = None if routes is None else routes[j][i - c["first_k_dense_replace"]]
                    y, chosen, g = _moe(hn, lw, c, given)
                    taken[j].append(chosen)
                    gap = max(gap, g)
                else:
                    y = _mlp(hn, lw["gate_up"], lw["down"])
                xs[j] = x + y
            del lw
        norm, head = get("norm"), get("lm_head")
        out = [_norm(x[s:], norm, eps) @ head.t() for x, s in zip(xs, starts)]
        return out, [torch.stack(t) if t else None for t in taken], gap
