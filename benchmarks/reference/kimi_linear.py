"""Kimi-Linear-48B-A3B (``kimi_linear``) in plain PyTorch: the yardstick the
program's logits and KDA states are held to.

A full causal forward over each sequence, in float32 with TF32 off: no
cache, no batching, no kernel.  Written from the Kimi Linear technical
report (arXiv:2510.26692) and the published modelling file.  For a token x
of a KDA layer (``linear_attn_config["kda_layers"]``, 1-indexed), H heads of
d, P = H d:

* q, k, v = SiLU(conv(x W_q)), SiLU(conv(x W_k)), SiLU(conv(x W_v)): each
  conv depthwise and causal over ``short_conv_kernel_size`` taps, no bias;
* q^, k^ = q, k per head over sqrt(sum of squares + 1e-6) (the published
  kernels' L2 norm);
* beta = sigmoid(x W_b) a head; g = -exp(A_log[h]) softplus(x W_fa W_fb +
  dt_bias) a channel;
* token by token, per head, S [d_k, d_v]: S <- diag(exp g) S; S <- S +
  beta k^ (v - S^T k^)^T; o = S^T q^ d^-1/2;
* y = RMSNorm_head(o) * sigmoid(x W_ga W_gb) (the norm's weight shared by
  the heads); out = y W_o.

The other layers are MLA without rotation (``mla_use_nope``): q = x W_q (no
low-rank q) split per head into q_nope and q_pe; the kv projection gives a
latent (RMS-normalised) and one k_pe shared by the heads; k_nope and v come
from the latent through ``kv_b``; scores over q_nope|q_pe against
k_nope|k_pe at scale (dn + dr)^-1/2, causal, taken in blocks of queries so
that ~9k positions fit.  Every layer from ``first_k_dense_replace`` is an
MoE: sigmoid scores over all ``router_experts`` (absent: ``num_experts``),
the top ``num_experts_per_token`` by score + bias, weighted by the scores,
renormalised over the chosen (``moe_renormalize``) and scaled by
``routed_scaling_factor``; the held experts (ids below ``num_experts``)
applied to the tokens that chose them, the others adding nothing (this
card's share of the deployment); the shared expert added.  MLPs are
down(silu(gate x) * up x).  RMSNorm everywhere else as in the published
model.

A caller may give the experts another forward took (one rounding flips
near-tied choices of random weights): the reference then follows them and
reports the widest margin by which a given expert's score + bias lies below
its own k-th best (the route gap), and ``state_cast`` rounds the KDA state
after every token (a control).

Departures from the published model: every product and sum in float32 (the
published model runs in bfloat16, its router, gates and recurrence in
float32); no multi-token prediction layer; one routing group (where
group-limited choice is the plain top-k).

Weights come as a mapping of the names of ``models/llm/kimi_linear.py``'s
docstring, in any type, each layer's upcast to float32 as it runs
(``weight_cast`` first rounds each weight of two or more dims, as the
control does).  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Callable, Mapping, Sequence

import torch
import torch.nn.functional as F

from benchmarks.reference.moonlight import _mlp, _norm, e4m3, exact_f32

__all__ = ["forward", "e4m3", "exact_f32", "bf16_round"]

NORM_EPS = 1e-6
BLOCK = 1024


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through bfloat16: the state control."""
    return t.to(torch.bfloat16).float()


def _l2(x):
    return x * torch.rsqrt(x.pow(2).sum(-1, keepdim=True) + NORM_EPS)


def _conv(x, taps):
    """Depthwise causal conv of ``x`` [L, P] with ``taps`` [P, W]."""
    L, W = x.shape[0], taps.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[m:m + L] * taps[:, m] for m in range(W))


def _kda(x, lw, c, at: int, state_cast):
    """(a KDA layer's out projection [L, D], the state after token ``at``)."""
    lin = c["linear_attn_config"]
    L, h, d = x.shape[0], int(lin["num_heads"]), int(lin["head_dim"])
    q, k, v = (F.silu(_conv(x @ lw[n + "_proj"].t(), lw[n + "_conv"])).view(L, h, d) for n in ("q", "k", "v"))
    q, k = _l2(q) * d ** -0.5, _l2(k)
    beta = torch.sigmoid(x @ lw["b_proj"].t())
    g = -lw["A_log"].exp()[:, None] * F.softplus(((x @ lw["f_a"].t()) @ lw["f_b"].t()).view(L, h, d)
                                                 + lw["dt_bias"].view(h, d))
    decay = g.exp()[..., None]                                   # [L, h, d, 1]
    bv, bk = (beta[..., None] * v)[:, :, None], (beta[..., None] * k)[:, :, None]   # [L, h, 1, d]
    k, q = k[..., None], q[:, :, None]                           # [L, h, d, 1], [L, h, 1, d]
    s = torch.zeros(h, d, d, device=x.device)
    kept = None
    o = []
    for t in range(L):
        s = s * decay[t]
        u = torch.baddbmm(bv[t], bk[t], s, alpha=-1)             # beta (v - S^T k^)
        s = torch.baddbmm(s, k[t], u)
        if state_cast is not None:
            s = state_cast(s)
        o.append(torch.bmm(q[t], s))
        if t == at:
            kept = s.clone()
    o = torch.cat(o, 1).transpose(0, 1)
    gate = torch.sigmoid(((x @ lw["g_a"].t()) @ lw["g_b"].t()).view(L, h, d))
    y = _norm(o, lw["o_norm"], c["rms_norm_eps"]) * gate
    return y.reshape(L, h * d) @ lw["o_proj"].t(), kept


def _mla(x, lw, c):
    L = x.shape[0]
    h, dn, dr, dv, r = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                        c["v_head_dim"], c["kv_lora_rank"])
    q = (x @ lw["q_proj"].t()).view(L, h, dn + dr)
    kv_a = x @ lw["kv_a"].t()
    lat = _norm(kv_a[:, :r], lw["kv_norm"], c["rms_norm_eps"])
    kv = (lat @ lw["kv_b"].t()).view(L, h, dn + dv)
    k = torch.cat((kv[..., :dn], kv_a[:, None, r:].expand(L, h, dr)), -1)
    v = kv[..., dn:]
    o = torch.empty(L, h, dv, device=x.device)
    for a in range(0, L, BLOCK):
        b = min(a + BLOCK, L)
        s = torch.einsum("qhd,khd->hqk", q[a:b], k[:b]) * (dn + dr) ** -0.5
        later = torch.arange(b, device=x.device)[None, :] > torch.arange(a, b, device=x.device)[:, None]
        o[a:b] = torch.einsum("hqk,khd->qhd", torch.softmax(s.masked_fill(later, float("-inf")), -1), v[:b])
    return o.reshape(L, h * dv) @ lw["o_proj"].t()


def _moe(x, lw, c, given=None):
    """(output, the experts taken [L, k], route gap), as
    ``reference/moonlight.py``'s, over the held experts only."""
    scores = torch.sigmoid(x @ lw["router"].t())
    choice = scores + lw["router_bias"]
    k = c["num_experts_per_token"]
    gap = 0.0
    if given is None:
        chosen = torch.topk(choice, k, dim=-1).indices
    else:
        chosen = given.to(x.device)
        kth = torch.topk(choice, k, dim=-1).values[:, -1:]
        gap = float((kth - choice.gather(1, chosen)).clamp(min=0).max())
    wts = scores.gather(1, chosen)
    if c["moe_renormalize"]:
        wts = wts / (wts.sum(-1, keepdim=True) + 1e-20)
    wts = wts * c["routed_scaling_factor"]
    out = _mlp(x, lw["shared.gate_up"], lw["shared.down"])
    for e in range(c["num_experts"]):
        tok, slot = torch.nonzero(chosen == e, as_tuple=True)
        if tok.numel():
            y = _mlp(x[tok], lw["experts.gate_up"][e], lw["experts.down"][e])
            out = out.index_add(0, tok, y * wts[tok, slot][:, None])
    return out, chosen, gap


def forward(weights: Mapping[str, torch.Tensor], config: Mapping, seqs: Sequence[torch.Tensor],
            starts: Sequence[int], weight_cast: Callable[[torch.Tensor], torch.Tensor] | None = None,
            routes: Sequence[torch.Tensor] | None = None,
            state_cast: Callable[[torch.Tensor], torch.Tensor] | None = None):
    """A full causal forward of each sequence of ids: (the f32 logits
    [len - start, V] at positions ``start`` .. len - 1, the experts each
    position took [MoE layers, len, k], the route gap, the KDA states
    [KDA layers, H, d, d] after position ``start``).  ``routes`` (one
    [MoE layers, len, k] a sequence) makes every MoE layer take the given
    experts.  The layers run one at a time over all sequences."""
    c = config
    eps = c["rms_norm_eps"]
    cast = weight_cast or (lambda t: t)
    kda_layers = {i - 1 for i in c["linear_attn_config"]["kda_layers"]}

    def get(name):
        t = weights[name].float()
        return cast(t) if t.dim() >= 2 else t

    with exact_f32(), torch.no_grad():
        emb = get("embed")
        xs = [emb[s.to(emb.device)] for s in seqs]
        del emb
        taken: list[list[torch.Tensor]] = [[] for _ in seqs]
        states: list[list[torch.Tensor]] = [[] for _ in seqs]
        gap = 0.0
        for i in range(c["num_hidden_layers"]):
            p = f"layers.{i}."
            lw = {k[len(p):]: get(k) for k in weights if k.startswith(p)}
            moe = i >= c["first_k_dense_replace"]
            for j, x in enumerate(xs):
                hn = _norm(x, lw["input_norm"], eps)
                if i in kda_layers:
                    y, s = _kda(hn, lw, c, starts[j], state_cast)
                    states[j].append(s)
                else:
                    y = _mla(hn, lw, c)
                x = x + y
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
        return (out, [torch.stack(t) if t else None for t in taken], gap,
                [torch.stack(s) if s else None for s in states])
