"""The retriever: a question-conditioned per-edge (triple) scorer, as a
``torch.nn.Module``.

Counterpart of ``evi_rag_tpu/models/retriever.py``.  Per edge (h, r, t) and
question q: project the frozen text embeddings (Linear + tanh, a learned
embedding for non-text entities), build DDE struct features from the topic
one-hot, contextualise the relation ``r_ctx = r * sigmoid(Wg q) + tanh(Wb q)``,
score both directions through the geometry features (DistMult interaction
gated by a structural nav gate, TransE error, its negative norm) and an MLP
head, and combine the two views with softmax weights.  Training adds dropout
and the hide-and-seek bias.

**Parameters are flax's.**  ``named_parameters()`` maps one to one onto the
JAX package's ``params/<module>/<leaf>`` (``flax_path``), with every
``kernel`` stored ``[in, out]``, so the digest, the checkpoint format, the
serving feature bundle and the optimizer's glob patterns need no transpose.
``params_to_numpy`` / ``load_params`` carry parameters across.
``init_parameters`` draws flax's initial distributions from an explicit
``torch.Generator``.

**Dtypes are flax's, layer by layer** (``compute_dtype="bfloat16"``):
``Dense(dtype=bf16)`` (``q_gate``, ``q_bias``, ``struct_proj``,
``struct_gate``, ``state_net_1``) casts input, kernel and bias to bf16; the
projectors and ``score_head`` have no dtype and promote (a bf16 input with
f32 parameters runs in f32); ``LayerNorm(dtype=bf16)`` takes its statistics
in f32 (mean and mean of squares) and returns bf16; ``state_net_0`` is
``ops.nnfn.dense_split`` (bf16 operands, f32 sums), the form serving uses.
On the card its bf16 products, forward and backward, run on the tensor cores
as bf16 GEMMs that sum and write in f32, with one rounding to bf16 at the end
(``ops.nnfn.DenseSplitBF16``): the product of two bf16 values is exact in
f32, so they compute the f32 route's products, summed in another order.

**Random draws** (dropout keep masks, one per direction, and the
hide-and-seek uniforms) come from ``make_draws`` with an explicit generator,
or are passed in precomputed (``draws=``), so that a test can feed JAX's
draws and a rematerialised forward recomputes with the same masks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from evi_rag_tpu_torch.models.batches import RetrieverBatch
from evi_rag_tpu_torch.models.dde import build_node_struct_features
from evi_rag_tpu_torch.ops.nnfn import dense_split, gelu_exact
from evi_rag_tpu_torch.ops.segment import gather_rows

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# flax lecun_normal: a normal truncated to +-2 std, scaled so that its std
# is sqrt(1 / fan_in) (the constant is the std of a unit normal cut at +-2).
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class RetrieverOutput:
    logits: torch.Tensor           # [E]
    logits_fwd: torch.Tensor       # [E]
    logits_bwd: torch.Tensor       # [E]
    edge_embeddings: torch.Tensor  # [E, H]


class Dense(nn.Module):
    """flax ``nn.Dense``: ``kernel [in, out]``, ``bias [out]`` (none with
    ``use_bias=False``).  With a ``dtype`` every operand is cast to it;
    without one they promote."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype | None = None,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype is not None else torch.promote_types(x.dtype, self.kernel.dtype)
        y = torch.matmul(x.to(dt), self.kernel.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class SplitInputDense(nn.Module):
    """``Dense`` over a conceptual concat input, applied per kernel row-slice
    (``ops.nnfn.dense_split``): the ``[E, sum(d_i)]`` concat is never built."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, parts: tuple[torch.Tensor, ...]) -> torch.Tensor:
        return dense_split({"kernel": self.kernel, "bias": self.bias}, parts, self.dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: statistics in f32 as
    ``var = max(0, E[x^2] - E[x]^2)``, then ``(x - mean) * (rsqrt(var + eps)
    * scale) + bias`` in f32, returned in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias
        return y.to(self.dtype)


class EmbeddingProjector(nn.Module):
    """Linear + tanh projection of frozen text embeddings (promoting)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.proj = Dense(in_features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.proj(x))


class Retriever(nn.Module):
    """Geometry-mode bidirectional triple scorer (the JAX module's fields)."""

    def __init__(
        self,
        emb_dim: int = 1024,
        hidden_dim: int = 1024,
        num_topics: int = 2,
        dde_rounds: int = 2,
        dde_reverse_rounds: int = 2,
        dropout_p: float = 0.1,
        direction_mode: str = "bidirectional",
        compute_dtype: str = "float32",
        hide_seek_enabled: bool = False,
        hide_seek_p_near: float = 0.0,
        hide_seek_p_far: float = 0.0,
        hide_seek_bias_near: float = 0.0,
        hide_seek_bias_far: float = 0.0,
        hide_seek_apply_in_eval: bool = False,
    ):
        super().__init__()
        if direction_mode not in ("forward", "backward", "bidirectional"):
            raise ValueError(f"invalid direction_mode {direction_mode!r}")
        if num_topics != 2:
            raise ValueError("num_topics must be 2 (seed vs non-seed)")
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be float32|bfloat16, got {compute_dtype!r}")
        self.emb_dim, self.hidden_dim, self.num_topics = emb_dim, hidden_dim, num_topics
        self.dde_rounds, self.dde_reverse_rounds = dde_rounds, dde_reverse_rounds
        self.dropout_p, self.direction_mode, self.compute_dtype = dropout_p, direction_mode, compute_dtype
        self.hide_seek_enabled = hide_seek_enabled
        self.hide_seek_p_near, self.hide_seek_p_far = hide_seek_p_near, hide_seek_p_far
        self.hide_seek_bias_near, self.hide_seek_bias_far = hide_seek_bias_near, hide_seek_bias_far
        self.hide_seek_apply_in_eval = hide_seek_apply_in_eval

        d, h, cd = emb_dim, hidden_dim, _DTYPES[compute_dtype]
        self.entity_proj = EmbeddingProjector(d, d)
        self.relation_proj = EmbeddingProjector(d, d)
        self.query_proj = EmbeddingProjector(d, d)
        self.non_text_entity_emb = nn.Parameter(torch.empty(d))
        self.q_gate = Dense(d, d, cd)
        self.q_bias = Dense(d, d, cd)
        self.struct_proj = Dense(2 * self.topic_struct_dim, d, cd)
        self.struct_norm = LayerNorm(d, cd)
        self.struct_gate = Dense(d, 1, cd)
        self.state_net_0 = SplitInputDense(3 * d + 1, h, cd)
        self.state_norm = LayerNorm(h, cd)
        self.state_net_1 = Dense(h, h, cd)
        self.score_head = Dense(h, 1)

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def topic_struct_dim(self) -> int:
        return self.num_topics * (1 + self.dde_rounds + self.dde_reverse_rounds)

    def parity_meta(self) -> dict[str, int]:
        """Feature-geometry contract exported into checkpoints."""
        return {"use_topic_pe": 1, "num_topics": self.num_topics,
                "dde_rounds": self.dde_rounds, "dde_reverse_rounds": self.dde_reverse_rounds}

    # ------------------------------------------------------------------ draws

    def _directions(self) -> tuple[bool, bool]:
        return (self.direction_mode in ("forward", "bidirectional"),
                self.direction_mode in ("backward", "bidirectional"))

    def _hide_seek_active(self, train: bool) -> bool:
        return (self.hide_seek_enabled and (train or self.hide_seek_apply_in_eval)
                and (self.hide_seek_p_near > 0.0 or self.hide_seek_p_far > 0.0)
                and (self.hide_seek_bias_near != 0.0 or self.hide_seek_bias_far != 0.0))

    def make_draws(self, batch: RetrieverBatch, *, train: bool,
                   generator: torch.Generator | None = None) -> dict[str, Any]:
        """The forward's random draws: ``dropout`` = one bool keep mask
        ``[E, H]`` per scored direction (fwd, bwd; None where a direction is
        not scored), ``hide_seek`` = ``[E]`` uniforms.  Empty when the
        forward draws nothing."""
        e, dev = batch.graph.num_edges, batch.question_emb.device
        draws: dict[str, Any] = {}
        if train and self.dropout_p > 0.0:
            keep = 1.0 - self.dropout_p
            draws["dropout"] = tuple(
                torch.rand(e, self.hidden_dim, device=dev, generator=generator) < keep if want else None
                for want in self._directions()
            )
        if self._hide_seek_active(train):
            draws["hide_seek"] = torch.rand(e, device=dev, generator=generator)
        return draws

    # ---------------------------------------------------------------- forward

    def forward(self, batch: RetrieverBatch, *, train: bool = False,
                draws: dict[str, Any] | None = None,
                generator: torch.Generator | None = None) -> RetrieverOutput:
        if draws is None:
            draws = self.make_draws(batch, train=train, generator=generator)
        gb = batch.graph
        heads, tails = gb.heads.long(), gb.tails.long()
        cd = self.cdtype

        query_repr = gather_rows(self.query_proj(batch.question_emb.to(cd)), gb.edge_batch)  # [E, D] f32
        node_repr = self.entity_proj(batch.node_emb.to(cd))                             # [N, D] f32
        non_text = self.entity_proj(self.non_text_entity_emb[None, :])[0]
        node_repr = torch.where(batch.node_is_nontext[:, None], non_text[None, :], node_repr)
        head_repr, tail_repr = gather_rows(node_repr, heads), gather_rows(node_repr, tails)
        relation_repr = self.relation_proj(batch.edge_emb.to(cd))                      # [E, D] f32

        node_struct = build_node_struct_features(
            batch.topic_one_hot.float(), gb.edge_index,
            num_rounds=self.dde_rounds, num_reverse_rounds=self.dde_reverse_rounds,
            edge_mask=gb.edge_mask,
        ).to(cd)
        ns_h, ns_t = node_struct[heads], node_struct[tails]

        r_ctx = relation_repr * torch.sigmoid(self.q_gate(query_repr)) + torch.tanh(self.q_bias(query_repr))
        keep = draws.get("dropout", (None, None))

        def score(h_r, t_r, struct_raw, keep_mask):
            struct_ctx = gelu_exact(self.struct_norm(self.struct_proj(struct_raw)))
            nav_gate = torch.sigmoid(self.struct_gate(struct_ctx))
            interaction = h_r * r_ctx * t_r * nav_gate
            error_vec = h_r + r_ctx - t_r
            err32 = error_vec.float()
            dist = (-torch.sqrt((err32 * err32).sum(dim=-1, keepdim=True) + 1e-12)).to(error_vec.dtype)
            feats = gelu_exact(self.state_norm(self.state_net_0((interaction, struct_ctx, error_vec, dist))))
            if train and self.dropout_p >= 1.0:
                feats = torch.zeros_like(feats)
            elif train and self.dropout_p > 0.0:
                feats = torch.where(keep_mask, feats / (1.0 - self.dropout_p), torch.zeros_like(feats))
            feats = self.state_net_1(feats)
            return self.score_head(feats)[..., 0].float(), feats

        want_fwd, want_bwd = self._directions()
        logits_fwd = feats_fwd = logits_bwd = feats_bwd = None
        if want_fwd:
            logits_fwd, feats_fwd = score(head_repr, tail_repr, torch.cat([ns_h, ns_t], dim=-1), keep[0])
        if want_bwd:
            logits_bwd, feats_bwd = score(tail_repr, head_repr, torch.cat([ns_t, ns_h], dim=-1), keep[1])

        if "hide_seek" in draws:
            bias = self.hide_seek_bias(batch, draws["hide_seek"])
            logits_fwd = logits_fwd + bias if logits_fwd is not None else None
            logits_bwd = logits_bwd + bias if logits_bwd is not None else None

        if self.direction_mode == "bidirectional":
            stacked = torch.stack([logits_fwd, logits_bwd], dim=0)
            weights = torch.softmax(stacked, dim=0)
            logits = (weights * stacked).sum(dim=0)
            edge_embeddings = weights[0][:, None] * feats_fwd + weights[1][:, None] * feats_bwd
        elif self.direction_mode == "forward":
            logits, edge_embeddings, logits_bwd = logits_fwd, feats_fwd, logits_fwd
        else:
            logits, edge_embeddings, logits_fwd = logits_bwd, feats_bwd, logits_bwd
        return RetrieverOutput(logits=logits, logits_fwd=logits_fwd, logits_bwd=logits_bwd,
                               edge_embeddings=edge_embeddings)

    def hide_seek_bias(self, batch: RetrieverBatch, u: torch.Tensor) -> torch.Tensor:
        """Stochastic near/far demotion: an edge with ``u < p`` (p by
        near/far) gets its bias."""
        near = batch.edge_is_near
        drop = u < torch.where(near, torch.tensor(self.hide_seek_p_near, device=u.device),
                               torch.tensor(self.hide_seek_p_far, device=u.device))
        bias = torch.where(near, torch.tensor(self.hide_seek_bias_near, device=u.device),
                           torch.tensor(self.hide_seek_bias_far, device=u.device))
        return torch.where(drop, bias, torch.zeros_like(bias))


# ---------------------------------------------------------------- parameters

def flax_path(name: str) -> str:
    """``named_parameters()`` name -> the flax parameter path."""
    return "params/" + name.replace(".", "/")


def init_parameters(model: Retriever, generator: torch.Generator) -> None:
    """flax's initial distributions, drawn in ``named_parameters()`` order
    from ``generator``: Dense kernels lecun_normal, biases zeros, LayerNorm
    scale ones and bias zeros, ``non_text_entity_emb`` normal(1.0)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "non_text_entity_emb":
                p.copy_(torch.randn(p.shape, generator=generator, dtype=p.dtype, device=generator.device))
            elif leaf == "kernel":
                std = math.sqrt(1.0 / p.shape[0]) / _TRUNC_STD
                draw = torch.empty(p.shape, dtype=p.dtype, device=generator.device)
                nn.init.trunc_normal_(draw, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                p.copy_(draw)
            elif leaf == "scale":
                p.fill_(1.0)
            else:
                p.zero_()


def params_tree(model: nn.Module) -> dict[str, Any]:
    """The module's parameters as the flax variable tree
    ``{"params": {module: {leaf: tensor}}}`` of the live tensors."""
    tree: dict[str, Any] = {}
    for name, p in model.named_parameters():
        node = tree
        *parents, leaf = flax_path(name).split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = p
    return tree


def params_to_numpy(model: nn.Module) -> dict[str, Any]:
    """The flax variable tree of the module as nested numpy arrays (the JAX
    package's parameter format)."""

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return node.detach().float().cpu().numpy()

    return conv(params_tree(model))


def load_params(model: nn.Module, tree: dict[str, Any]) -> None:
    """Copy a flax variable tree (nested numpy arrays or tensors, with or
    without the outer ``params`` level) into the module; every parameter
    must be present with its shape."""
    inner = tree["params"] if "params" in tree else tree
    with torch.no_grad():
        for name, p in model.named_parameters():
            node = inner
            for k in name.split("."):
                if not isinstance(node, dict) or k not in node:
                    raise KeyError(f"parameter {flax_path(name)} missing from the tree")
                node = node[k]
            src = node if isinstance(node, torch.Tensor) else torch.from_numpy(np.array(node))
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{flax_path(name)}: shape {tuple(src.shape)} != {tuple(p.shape)}")
            p.copy_(src.to(dtype=p.dtype, device=p.device))
