"""GFlowNet state representation and the flow estimator, as ``nn.Module``s.

Counterpart of ``evi_rag_tpu/models/gflownet/state_encoder.py``: state =
LayerNorm(mean of the active node tokens + question token + the embedding of
the remaining steps + the running action-history mean (+ the optional
state-DDE structural mean)).  ``precompute`` hoists what does not change
over a rollout; ``encode_state`` is a masked segment mean or two per step.
Step embeddings start at zero.

Parameters are flax's (``models.retriever.flax_path``): ``step_embeddings/
embedding [T, H]``, ``norm/{scale,bias}``, ``state_dde_proj/{kernel,bias}``;
the estimator's ``ctx_norm``, ``dense_0``, ``dense_1`` (zero-init kernel).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from evi_rag_tpu_torch.models.batches import AgentBatch
from evi_rag_tpu_torch.models.dde import build_node_struct_features
from evi_rag_tpu_torch.models.gflownet.env import EnvState
from evi_rag_tpu_torch.models.retriever import Dense, LayerNorm
from evi_rag_tpu_torch.ops.nnfn import gelu_exact
from evi_rag_tpu_torch.ops.segment import gather_rows, segment_layout, sorted_segment_mean


@dataclasses.dataclass(frozen=True)
class StateEncoderCache:
    question_tokens: torch.Tensor     # [G, H]
    node_tokens: torch.Tensor         # [N, H]
    node_struct_tokens: torch.Tensor  # [N, H] (zeros when state-DDE is off)


class Embed(nn.Module):
    """flax ``nn.Embed``: ``embedding [num, features]``; the lookup's backward
    adds repeated rows in a fixed order (``ops.segment.gather_rows``)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.zeros(num_embeddings, features))

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return gather_rows(self.embedding, idx.reshape(-1)).reshape(tuple(idx.shape) + (-1,))


class StateEncoder(nn.Module):
    def __init__(self, hidden_dim: int, max_steps: int, use_state_dde: bool = False, state_dde_rounds: int = 2,
                 state_dde_reverse_rounds: int = 2, state_dde_num_topics: int = 2):
        super().__init__()
        self.hidden_dim, self.max_steps, self.use_state_dde = hidden_dim, max_steps, use_state_dde
        self.state_dde_rounds, self.state_dde_reverse_rounds = state_dde_rounds, state_dde_reverse_rounds
        self.state_dde_num_topics = state_dde_num_topics
        self.step_embeddings = Embed(max_steps + 1, hidden_dim)
        self.norm = LayerNorm(hidden_dim, torch.float32)
        if use_state_dde:
            struct_dim = state_dde_num_topics * (1 + state_dde_rounds + state_dde_reverse_rounds)
            self.state_dde_proj = Dense(struct_dim, hidden_dim)

    def precompute(self, batch: AgentBatch, *, node_tokens: torch.Tensor,
                   question_tokens: torch.Tensor) -> StateEncoderCache:
        struct_tokens = torch.zeros_like(node_tokens)
        if self.use_state_dde:
            if self.state_dde_num_topics != 2:
                raise ValueError("state_dde_num_topics must be 2")
            one = batch.node_is_start.to(torch.float32)
            raw = build_node_struct_features(
                torch.stack([1.0 - one, one], dim=-1), batch.graph.edge_index,
                num_rounds=self.state_dde_rounds, num_reverse_rounds=self.state_dde_reverse_rounds,
                edge_mask=batch.graph.edge_mask,
            )
            struct_tokens = self.state_dde_proj(raw)
        return StateEncoderCache(question_tokens=question_tokens, node_tokens=node_tokens,
                                 node_struct_tokens=struct_tokens)

    def _tokens(self, cache: StateEncoderCache, batch: AgentBatch, active: torch.Tensor, counts: torch.Tensor,
                action_hidden: torch.Tensor) -> torch.Tensor:
        """Pre-norm tokens [S, G, H] of S stacked env states (``active`` [S, N],
        ``counts`` [S, G], ``action_hidden`` [S, G, H]): the S states' masked
        node means are one segment mean over S * G segments (state s's node
        rows keep their graph's id offset by s * G)."""
        gb = batch.graph
        s, g, n = active.shape[0], gb.num_graphs, gb.num_nodes
        ids = gb.node_batch
        if s > 1:
            ids = (ids.long()[None] + g * torch.arange(s, device=ids.device)[:, None]).reshape(-1)
        order, layout = segment_layout(ids, s * g, mask=(active & gb.node_mask[None]).reshape(-1))
        rows = order if s == 1 else order % n

        def mean(table: torch.Tensor) -> torch.Tensor:
            return sorted_segment_mean(gather_rows(table, rows), layout).reshape(s, g, -1)

        remaining = torch.clamp(self.max_steps - counts, 0, self.max_steps)
        tokens = mean(cache.node_tokens) + cache.question_tokens + self.step_embeddings(remaining) + action_hidden
        if self.use_state_dde:
            tokens = tokens + mean(cache.node_struct_tokens)
        return tokens

    def encode_state(self, cache: StateEncoderCache, state: EnvState, batch: AgentBatch) -> torch.Tensor:
        return self.norm(self._tokens(cache, batch, state.active_nodes[None], state.step_counts[None],
                                      state.action_hidden[None])[0])

    def encode_states_batched(
        self,
        cache: StateEncoderCache,
        batch: AgentBatch,
        *,
        active_seq: torch.Tensor,         # [T, N] bool pre-step frontiers
        counts_seq: torch.Tensor,         # [T, G] int32 pre-step step counts
        action_hidden_seq: torch.Tensor,  # [T, G, H] pre-step action-history means
    ) -> torch.Tensor:
        """All T per-step state tokens, [T, G, H]: ``encode_state`` over the
        stacked env-state snapshots, in one pass over the step axis."""
        return self.norm(self._tokens(cache, batch, active_seq, counts_seq, action_hidden_seq))


class GFlowNetEstimator(nn.Module):
    """logF(s) head: MLP(LayerNorm([state | question])) -> scalar, with the
    last layer zero-initialised."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.ctx_norm = LayerNorm(2 * hidden_dim, torch.float32)
        self.dense_0 = Dense(2 * hidden_dim, hidden_dim)
        self.dense_1 = Dense(hidden_dim, 1)

    def forward(self, state_emb: torch.Tensor, question_tokens: torch.Tensor) -> torch.Tensor:
        if question_tokens.ndim < state_emb.ndim:
            shape = question_tokens.shape[:1] + (1,) * (state_emb.ndim - question_tokens.ndim) + question_tokens.shape[1:]
            question_tokens = question_tokens.reshape(shape).expand_as(state_emb)
        h = self.ctx_norm(torch.cat([state_emb, question_tokens], dim=-1))
        h = gelu_exact(self.dense_0(h))
        return self.dense_1(h)[..., 0]
