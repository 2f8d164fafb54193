"""The retriever in plain PyTorch: the yardstick that decides ``correct``.

Written from the model's description (EVI-RAG's geometry-mode
bidirectional triple scorer, ``configs/retriever/production.yaml``), in
float32 arithmetic with the configuration's compute type applied where the
model rounds: a ``Dense`` layer with a compute type rounds its input, kernel
and bias to it and its output; a ``LayerNorm`` takes f32 statistics and
returns the compute type; the first state layer takes its four inputs
rounded, sums in f32 and rounds once; the text projectors and the score
head run in f32.  Products of rounded operands are exact in f32 and summed
in f32 (TF32 is switched off while the reference runs).

``Prec("bfloat16")`` is the configuration's compute type.  The control is
the same reference with ``Prec("float8_e4m3fn")``: the step below it.
Rounding passes the gradient straight through, so the reference trains in
either type with autograd.

Nothing here imports the program.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
import torch.nn.functional as F


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g, None


class Prec:
    """Rounding to one compute type; values stay float32 tensors."""

    def __init__(self, name: str = "bfloat16"):
        self.name = name
        self.dtype = getattr(torch, name)

    def r(self, x: torch.Tensor) -> torch.Tensor:
        return _Round.apply(x.float(), self.dtype)


@contextlib.contextmanager
def exact_f32():
    """f32 products in f32: no TF32, no reduced-precision bf16 sums."""
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32, m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32, torch.backends.cudnn.allow_tf32 = False, False
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved


def project(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Text projector: tanh(x W + b) in f32."""
    return torch.tanh(x.float() @ p["proj"]["kernel"] + p["proj"]["bias"])


def dense(p: dict, x: torch.Tensor, prec: Prec) -> torch.Tensor:
    y = prec.r(prec.r(x) @ prec.r(p["kernel"]))
    return prec.r(y + prec.r(p["bias"]))


def layernorm(p: dict, x: torch.Tensor, prec: Prec, eps: float = 1e-5) -> torch.Tensor:
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return prec.r((x - mean) * (torch.rsqrt(var + eps) * p["scale"]) + p["bias"])


def gelu(x: torch.Tensor, prec: Prec) -> torch.Tensor:
    return prec.r(F.gelu(x))


def query_terms(P: dict, q_emb: torch.Tensor, prec: Prec, round_input: bool = False):
    """(gate, bias) [.., D] of raw question embeddings (rounded to ``prec``
    first where the model takes them in its compute type: in training)."""
    qp = project(P["query_proj"], prec.r(q_emb) if round_input else q_emb)
    gate = prec.r(torch.sigmoid(dense(P["q_gate"], qp, prec)))
    bias = prec.r(torch.tanh(dense(P["q_bias"], qp, prec)))
    return gate, bias


def entity_rows(P: dict, table: torch.Tensor, rows: torch.Tensor, prec: Prec | None = None) -> torch.Tensor:
    """Projected entity rows (row 0, the non-text row, takes the projected
    learned non-text embedding); ``prec`` rounds the raw rows first."""
    x = table[rows.long()]
    out = project(P["entity_proj"], x if prec is None else prec.r(x))
    nt = project(P["entity_proj"], P["non_text_entity_emb"][None, :])[0]
    return torch.where((rows == 0)[:, None], nt[None, :], out)


def relation_rows(P: dict, table: torch.Tensor, rows: torch.Tensor, prec: Prec | None = None) -> torch.Tensor:
    x = table[rows.long()]
    return project(P["relation_proj"], x if prec is None else prec.r(x))


def direction(P: dict, h, r_ctx, t, struct_raw, prec: Prec, keep=None, p_drop: float = 0.0) -> torch.Tensor:
    """[...] logits of one direction."""
    sc = gelu(layernorm(P["struct_norm"], dense(P["struct_proj"], struct_raw, prec), prec), prec)
    nav = prec.r(torch.sigmoid(dense(P["struct_gate"], sc, prec)))
    inter = h * r_ctx * t * nav
    err = h + r_ctx - t
    dist = -torch.sqrt((err * err).sum(dim=-1, keepdim=True) + 1e-12)
    w = P["state_net_0"]["kernel"]
    d = h.shape[-1]
    z = (prec.r(inter) @ prec.r(w[:d]) + prec.r(sc) @ prec.r(w[d:2 * d]) + prec.r(err) @ prec.r(w[2 * d:3 * d])
         + prec.r(dist) * prec.r(w[3 * d:]) + prec.r(P["state_net_0"]["bias"]))
    z = gelu(layernorm(P["state_norm"], prec.r(z), prec), prec)
    if keep is not None:
        z = prec.r(torch.where(keep, z / (1.0 - p_drop), torch.zeros_like(z)))
    z = dense(P["state_net_1"], z, prec)
    return (z @ P["score_head"]["kernel"] + P["score_head"]["bias"])[..., 0]


def twin_scores(P: dict, gate, bias, h, r, t, struct_raw, prec: Prec, keep=(None, None), p_drop: float = 0.0,
                extra=None) -> torch.Tensor:
    """Both directions (the backward one swaps head and tail and the struct
    halves), each plus ``extra`` (hide-and-seek), combined by a two-way
    softmax."""
    r_ctx = r * gate + bias
    half = struct_raw.shape[-1] // 2
    swap = torch.cat([struct_raw[..., half:], struct_raw[..., :half]], dim=-1)
    fwd = direction(P, h, r_ctx, t, struct_raw, prec, keep[0], p_drop)
    bwd = direction(P, t, r_ctx, h, swap, prec, keep[1], p_drop)
    if extra is not None:
        fwd, bwd = fwd + extra, bwd + extra
    s = torch.stack([fwd, bwd])
    return (torch.softmax(s, dim=0) * s).sum(dim=0)


def node_struct(edge_index: torch.Tensor, num_nodes: int, topic: torch.Tensor, rounds: int,
                reverse_rounds: int) -> torch.Tensor:
    """[N, 2 (1 + R + Rr)] DDE features: the topic one-hot (topic, other
    node) and its mean over in-neighbours ``rounds`` times (head -> tail),
    then over out-neighbours ``reverse_rounds`` times, laid out channel by
    channel."""
    x = torch.zeros((num_nodes, 2), dtype=torch.float32, device=edge_index.device)
    x[:, 1] = 1.0
    x[topic.long(), 0] = 1.0
    x[topic.long(), 1] = 0.0
    heads, tails = edge_index[0].long(), edge_index[1].long()
    maps = [x]
    for n_r, src, dst in ((rounds, heads, tails), (reverse_rounds, tails, heads)):
        cnt = torch.zeros(num_nodes, device=x.device).index_add_(0, dst, torch.ones_like(dst, dtype=torch.float32))
        h = x
        for _ in range(n_r):
            s = torch.zeros_like(x).index_add_(0, dst, h[src])
            h = s / cnt.clamp(min=1.0)[:, None]
            maps.append(h)
    return torch.stack(maps, dim=-1).reshape(num_nodes, -1)


def edge_struct(edge_index: torch.Tensor, num_nodes: int, topic: torch.Tensor, rounds: int,
                reverse_rounds: int) -> torch.Tensor:
    """[E, S] edge struct features: the head's node features, then the tail's."""
    ns = node_struct(edge_index, num_nodes, topic, rounds, reverse_rounds)
    return torch.cat([ns[edge_index[0].long()], ns[edge_index[1].long()]], dim=-1)


def question_scores(P: dict, q: dict, tables: tuple, q_row: int, prec: Prec, rounds: int = 2,
                    reverse_rounds: int = 2) -> torch.Tensor:
    """[E] scores of every edge of one question (a ``gen.question`` dict with
    ``rows``, its nodes' embedding-table rows) as served: the tables
    projected in f32, then the model at ``prec``."""
    ent, rel, qtab = tables
    dev = ent.device
    ei = torch.as_tensor(q["edge_index"], device=dev).long()
    node_rep = prec.r(entity_rows(P, ent, torch.as_tensor(q["rows"], device=dev)))
    h, t = node_rep[ei[0]], node_rep[ei[1]]
    r = prec.r(relation_rows(P, rel, torch.as_tensor(q["relations"], device=dev)))
    st = prec.r(edge_struct(ei, len(q["rows"]), torch.as_tensor(q["topics"], device=dev), rounds, reverse_rounds))
    gate, bias = query_terms(P, qtab[q_row][None, :], prec)
    return twin_scores(P, gate, bias, h, r, t, st, prec)


def pooled_scores(P: dict, q_emb: torch.Tensor, head: torch.Tensor, rel: torch.Tensor, tail: torch.Tensor,
                  struct_raw: torch.Tensor, prec: Prec, chunk: int = 2048) -> torch.Tensor:
    """[B, M] scores of every query over shared candidate rows (projected,
    f32), ``chunk`` candidates at a time."""
    gate, bias = query_terms(P, q_emb, prec)
    g, b = gate[:, None, :], bias[:, None, :]
    out = []
    for c0 in range(0, head.shape[0], chunk):
        sl = slice(c0, c0 + chunk)
        h, r, t = (prec.r(x[sl])[None] for x in (head, rel, tail))
        out.append(twin_scores(P, g, b, h, r, t, prec.r(struct_raw[sl])[None], prec))
    return torch.cat(out, dim=1)


def topk(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k ordered (score desc, index asc)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def flat(tree: dict, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, path))
        else:
            out[path] = v
    return out


def unflat(items: dict[str, Any]) -> dict:
    tree: dict = {}
    for path, v in items.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree
