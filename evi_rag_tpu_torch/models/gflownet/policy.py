"""Edge policy with candidate-masked single-head attention pooling, as an
``nn.Module``.

Counterpart of ``evi_rag_tpu/models/gflownet/policy.py``.  Per step the
state attends over its graph's candidate edges (one head, scaled dot
product), the pooled context refines the state, the edge head scores
[state | edge] pairs and the stop head scores the refined state.  Everything
runs densely over the padded edge axis; invalid edges get ``NEG_INF`` (the
finite float32 minimum, so ``torch.where`` never meets an infinity).  The
last layers are zero-initialised.

``precompute_steps`` hoists the per-step edge-axis matmuls (attention k/v
and the edge half of the edge head's LayerNorm + Dense) into one batched
``[T, E, H]`` launch each; ``apply_precomputed`` then splits the LayerNorm
over the concat exactly as the JAX module does (f32 statistics with the
fast variance E[x^2] - E[x]^2).  The canonical ``forward`` is the per-step
form.

``compute_dtype`` follows flax's dtype rules layer by layer (the port's
``Dense`` / ``LayerNorm``); logits and everything the sampler and the loss
read stay f32.  Dropout draws are arguments: ``keep_edge`` / ``keep_head``
bool keep masks (``[T, E, H]`` for ``precompute_steps``, ``[E, H]`` for
``forward``), as ``make_policy_draws`` makes them, so that a test can feed
JAX's masks.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from evi_rag_tpu_torch.models.retriever import Dense, LayerNorm
from evi_rag_tpu_torch.ops.nnfn import gelu_exact
from evi_rag_tpu_torch.ops.segment import NEG_INF, gather_rows, segment_softmax, segment_sum

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PolicyStepTensors:
    """Per-rollout-step policy tensors hoisted out of the step loop (leading
    axis T; ``at(t)`` slices one step)."""

    k: torch.Tensor        # [T, E, H] attention keys (compute dtype)
    v: torch.Tensor        # [T, E, H] attention values (compute dtype)
    p_edge: torch.Tensor   # [T, E, H] (edge_repr * gamma_e) @ W0_e (compute dtype)
    sum_e: torch.Tensor    # [T, E] f32 per-row sum of the edge half
    sumsq_e: torch.Tensor  # [T, E] f32 per-row sum of squares of the edge half
    drop2: torch.Tensor | None        # [T, E, H] bool edge-head keep mask (None: no dropout)
    drop2_scale: torch.Tensor | None  # [T] 1 / keep (compute dtype)

    def at(self, t: int) -> "PolicyStepTensors":
        return PolicyStepTensors(**{f.name: None if getattr(self, f.name) is None else getattr(self, f.name)[t]
                                    for f in dataclasses.fields(self)})

    def flat(self) -> "PolicyStepTensors":
        """All T steps as one step over T * E rows (step t's edge rows at
        t * E ...), for ``apply_precomputed`` with segment ids offset by
        t * G; ``drop2_scale`` (the same value at every step) becomes a
        scalar."""
        def fold(x: torch.Tensor) -> torch.Tensor:
            return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

        return PolicyStepTensors(
            k=fold(self.k), v=fold(self.v), p_edge=fold(self.p_edge), sum_e=fold(self.sum_e),
            sumsq_e=fold(self.sumsq_e), drop2=None if self.drop2 is None else fold(self.drop2),
            drop2_scale=None if self.drop2_scale is None else self.drop2_scale[0])


def make_policy_draws(num_steps: int, num_edges: int, hidden: int, dropout: float, *,
                      generator: torch.Generator | None, device) -> dict[str, torch.Tensor]:
    """The policy's dropout keep masks for a rollout in train mode:
    ``keep_edge`` (edge representation) and ``keep_head`` (edge-head
    activation), each ``[T, E, H]`` bool with P(keep) = 1 - dropout."""
    keep = 1.0 - dropout
    shape = (num_steps, num_edges, hidden)
    return {name: torch.rand(shape, generator=generator, device=device) < keep
            for name in ("keep_edge", "keep_head")}


class GFlowNetEdgePolicy(nn.Module):
    def __init__(self, hidden_dim: int, dropout: float = 0.1, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise ValueError(f"compute_dtype must be float32|bfloat16, got {compute_dtype!r}")
        self.hidden_dim, self.dropout, self.compute_dtype = hidden_dim, dropout, compute_dtype
        h, cd = hidden_dim, _DTYPES[compute_dtype]
        self.state_norm = LayerNorm(h, cd)
        self.edge_base_norm = LayerNorm(h, cd)
        self.edge_base_dense = Dense(h, h, cd)
        self.attn_q = Dense(h, h, cd, use_bias=False)
        self.attn_k = Dense(h, h, cd, use_bias=False)
        self.attn_v = Dense(h, h, cd, use_bias=False)
        self.edge_head_norm = LayerNorm(2 * h, cd)
        self.edge_head_0 = Dense(2 * h, h, cd)
        self.edge_head_1 = Dense(h, 1, cd)
        self.stop_head_norm = LayerNorm(h, cd)
        self.stop_head_0 = Dense(h, h, cd)
        self.stop_head_1 = Dense(h, 1, cd)

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def _live(self, train: bool) -> bool:
        return train and self.dropout > 0.0

    def _dropout(self, x: torch.Tensor, keep: torch.Tensor | None, train: bool) -> torch.Tensor:
        """flax ``nn.Dropout``: ``where(keep, x / (1 - rate), 0)`` in train mode."""
        if not self._live(train):
            return x
        if keep is None:
            raise ValueError("train-mode dropout needs its keep mask (make_policy_draws)")
        return torch.where(keep, x / (1.0 - self.dropout), torch.zeros_like(x))

    def compute_edge_base(self, edge_tokens: torch.Tensor) -> torch.Tensor:
        """Step-invariant edge projection, hoisted out of the rollout loop."""
        return gelu_exact(self.edge_base_dense(self.edge_base_norm(edge_tokens)))

    def precompute_steps(
        self,
        edge_tokens: torch.Tensor,
        num_steps: int,
        *,
        edge_base: torch.Tensor | None = None,
        train: bool = False,
        keep_edge: torch.Tensor | None = None,   # [T, E, H] bool
        keep_head: torch.Tensor | None = None,   # [T, E, H] bool
    ) -> PolicyStepTensors:
        """All per-step edge-axis matmuls, batched over the T step axis, with
        the edge half of ``edge_head_norm + edge_head_0`` folded into
        ``p_edge``."""
        if edge_base is None:
            edge_base = self.compute_edge_base(edge_tokens)
        e, h = edge_base.shape
        edge_repr = self._dropout(edge_base[None].expand(num_steps, e, h), keep_edge, train)
        k, v = self.attn_k(edge_repr), self.attn_v(edge_repr)
        b = edge_repr.float()
        p_edge = (b * self.edge_head_norm.scale[h:].float()) @ self.edge_head_0.kernel[h:].float()
        cd = self.cdtype
        drop2 = drop2_scale = None
        if self._live(train):
            if keep_head is None:
                raise ValueError("train-mode dropout needs its keep mask (make_policy_draws)")
            drop2 = keep_head if self.dropout < 1.0 else torch.zeros_like(keep_head)
            drop2_scale = torch.full((num_steps,), 1.0, dtype=cd, device=b.device) / (1.0 - self.dropout)
        return PolicyStepTensors(k=k, v=v, p_edge=p_edge.to(cd), sum_e=b.sum(-1), sumsq_e=(b * b).sum(-1),
                                 drop2=drop2, drop2_scale=drop2_scale)

    def _attend(self, state_tokens, k, v, edge_batch, valid):
        """State attention over the candidate edges -> refined state (f32)."""
        num_graphs = state_tokens.shape[0]
        q = gather_rows(self.attn_q(self.state_norm(state_tokens)), edge_batch)
        att_logits = (q.float() * k.float()).sum(-1) / max(math.sqrt(self.hidden_dim), 1.0)
        att_w = segment_softmax(att_logits, edge_batch, num_graphs, mask=valid)
        context = segment_sum(att_w[:, None] * v.float(), edge_batch, num_graphs, mask=valid)
        return self.state_norm(state_tokens.float() + context).float()

    def _stop_logits(self, state_out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = gelu_exact(self.stop_head_0(self.stop_head_norm(state_out.to(dtype))))
        return self.stop_head_1(s)[..., 0].float()

    def apply_precomputed(
        self,
        step: PolicyStepTensors,        # one step's slice (``PolicyStepTensors.at``)
        state_tokens: torch.Tensor,     # [G, H]
        edge_batch: torch.Tensor,       # [E]
        valid_edges_mask: torch.Tensor,  # [E] bool
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One step on the hoisted tensors: the canonical step's math with
        the edge head's LayerNorm + Dense split as

            LN(concat(a, b)) @ W0 + b0
              = [(a g_a) @ W0_a + (b g_b) @ W0_b - mu (g @ W0)] / sigma + (beta @ W0 + b0)

        (mu, sigma from the two halves' running sums, f32, fast variance)."""
        h = state_tokens.shape[1]
        cd = self.cdtype
        eb = edge_batch.long()
        state_out = self._attend(state_tokens, step.k, step.v, edge_batch, valid_edges_mask)

        gamma, beta = self.edge_head_norm.scale.float(), self.edge_head_norm.bias.float()
        w0, b0 = self.edge_head_0.kernel.float(), self.edge_head_0.bias.float()
        a = state_out.to(cd).float()                       # the canonical concat's cast
        p_state = (a * gamma[:h]) @ w0[:h]
        mu = (a.sum(-1)[eb] + step.sum_e) / (2.0 * h)
        var = ((a * a).sum(-1)[eb] + step.sumsq_e) / (2.0 * h) - mu * mu
        inv = torch.rsqrt(var + 1e-5)                      # edge_head_norm eps
        # Row-vector products: ``@`` on a 1-D operand squeezes the matmul's
        # result in place, which a selective checkpoint (remat "dots") refuses.
        u = (gamma[None] @ w0)[0]
        const = (beta[None] @ w0)[0] + b0
        h_pre = (gather_rows(p_state, eb) + step.p_edge.float() - mu[:, None] * u[None, :]) * inv[:, None] \
            + const[None, :]
        hh = gelu_exact(h_pre.to(cd))
        if step.drop2 is not None:
            hh = hh * torch.where(step.drop2, step.drop2_scale, torch.zeros((), dtype=cd, device=hh.device))
        edge_logits = self.edge_head_1(hh)[..., 0].float()
        edge_logits = torch.where(valid_edges_mask, edge_logits, torch.full_like(edge_logits, NEG_INF))
        return edge_logits, self._stop_logits(state_out, cd), state_out

    def forward(
        self,
        edge_tokens: torch.Tensor,       # [E, H]
        state_tokens: torch.Tensor,      # [G, H]
        edge_batch: torch.Tensor,        # [E]
        valid_edges_mask: torch.Tensor,  # [E] bool
        *,
        edge_base: torch.Tensor | None = None,
        train: bool = False,
        keep_edge: torch.Tensor | None = None,  # [E, H] bool
        keep_head: torch.Tensor | None = None,  # [E, H] bool
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if edge_base is None:
            edge_base = self.compute_edge_base(edge_tokens)
        edge_repr = self._dropout(edge_base, keep_edge, train)
        state_out = self._attend(state_tokens, self.attn_k(edge_repr), self.attn_v(edge_repr), edge_batch,
                                 valid_edges_mask)
        edge_in = torch.cat([gather_rows(state_out.to(edge_repr.dtype), edge_batch), edge_repr], dim=-1)
        hh = gelu_exact(self.edge_head_0(self.edge_head_norm(edge_in)))
        hh = self._dropout(hh, keep_head, train)
        edge_logits = self.edge_head_1(hh)[..., 0].float()
        edge_logits = torch.where(valid_edges_mask, edge_logits, torch.full_like(edge_logits, NEG_INF))
        return edge_logits, self._stop_logits(state_out, edge_repr.dtype), state_out
