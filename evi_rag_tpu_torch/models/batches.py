"""Typed batches the retriever and the GFlowNet consume.

Counterpart of ``evi_rag_tpu/models/batches.py``: padded buckets of
per-question subgraphs, with variable-length index lists (topic, start and
answer locals) as node masks and the pair supervision as a padded pair axis
with its own mask.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from evi_rag_tpu_torch.ops.graph import GraphBatch, map_tensors
from evi_rag_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class EmbedTables:
    """Device-resident embedding tables, uploaded once per task.  Each table
    has ONE extra all-zero row at index ``V``, so padding rows of an id-feed
    batch gather zeros, as the dense host collation writes them."""

    entity: torch.Tensor    # [V+1, D]; row V is the zero pad row
    relation: torch.Tensor  # [R+1, D]; row R is the zero pad row


@dataclasses.dataclass(frozen=True)
class RetrieverBatch:
    """One padded bucket of per-question subgraphs for triple scoring.

    Dense batches carry the gathered text embeddings; id-feed batches carry
    ``node_rows`` / ``edge_rows`` instead and are resolved on the device by
    ``materialize_retriever_batch``.  A stacked batch has a leading shard
    axis on every field.
    """

    graph: GraphBatch
    node_emb: torch.Tensor | None  # [N, D] entity text embeddings
    node_is_nontext: torch.Tensor  # [N] bool: embedding row 0 -> learned non-text embedding
    edge_emb: torch.Tensor | None  # [E, D] relation text embeddings
    question_emb: torch.Tensor     # [G, D]
    topic_one_hot: torch.Tensor    # [N, num_topics] float
    edge_labels: torch.Tensor      # [E] float in {0, 1}
    node_is_q: torch.Tensor        # [N] bool: question/topic entity
    node_is_a: torch.Tensor        # [N] bool: answer entity
    node_rows: torch.Tensor | None = None  # [N] int32 entity-table rows (id feed)
    edge_rows: torch.Tensor | None = None  # [E] int32 relation-table rows (id feed)

    @property
    def edge_is_near(self) -> torch.Tensor:
        """Edges incident to a question or answer node ("bridge" edges are
        the complement)."""
        qa = self.node_is_q | self.node_is_a
        return qa[self.graph.heads.long()] | qa[self.graph.tails.long()]

    def shard(self, i: int) -> "RetrieverBatch":
        """Shard ``i`` of a stacked batch, as a flat batch."""
        return map_tensors(self, lambda t: t[i])


@dataclasses.dataclass(frozen=True)
class PairSupervision:
    """Padded (start, answer) pair-level shortest-path supervision."""

    pair_batch: torch.Tensor         # [P] int32 graph id (padding -> padding graph)
    pair_start_local: torch.Tensor   # [P] int32 graph-local start node
    pair_answer_local: torch.Tensor  # [P] int32 graph-local answer node
    pair_shortest_len: torch.Tensor  # [P] int32 BFS shortest distance
    pair_mask: torch.Tensor          # [P] bool


@dataclasses.dataclass(frozen=True)
class AgentBatch:
    """Padded GFlowNet environment batch: the retriever-selected evidence
    graph with its edges' retriever scores, start / answer node masks,
    ``is_dummy`` for graphs whose answer is absent, the DAG edge labels for
    behaviour cloning and the pair supervision of the reward."""

    graph: GraphBatch
    edge_scores: torch.Tensor      # [E] f32 retriever scores (logits)
    edge_relations: torch.Tensor   # [E] int32 relation vocab ids
    node_emb: torch.Tensor | None  # [N, D] entity text embeddings
    node_is_nontext: torch.Tensor  # [N] bool
    edge_emb: torch.Tensor | None  # [E, D] relation text embeddings
    question_emb: torch.Tensor     # [G, D]
    node_is_start: torch.Tensor    # [N] bool
    node_is_answer: torch.Tensor   # [N] bool
    is_dummy: torch.Tensor         # [G] bool
    edge_labels: torch.Tensor      # [E] f32 DAG (shortest-path) edge labels for BC
    pairs: PairSupervision
    node_rows: torch.Tensor | None = None  # [N] int32 entity-table rows (id feed)
    edge_rows: torch.Tensor | None = None  # [E] int32 relation-table rows (id feed)

    def shard(self, i: int) -> "AgentBatch":
        """Shard ``i`` of a stacked batch, as a flat batch."""
        return map_tensors(self, lambda t: t[i])


def make_tables(entity_emb, relation_emb, *, device: str | torch.device | None = None) -> EmbedTables:
    """Upload the entity and relation tables once (plus the zero pad row) to
    ``device`` (the card unless ``"cpu"`` is named; raises without one)."""
    dev = resolve_device(device)

    def pad(t):
        t = np.asarray(t, dtype=np.float32)
        return torch.from_numpy(np.concatenate([t, np.zeros((1, t.shape[1]), t.dtype)])).to(dev)

    return EmbedTables(entity=pad(entity_emb), relation=pad(relation_emb))


def materialize_retriever_batch(batch, tables: EmbedTables | None):
    """Resolve an id-feed batch into dense embeddings on the tables' device
    (flat ``[N]`` and stacked ``[S, N]`` rows alike); dense batches pass
    through."""
    if batch.node_emb is not None:
        return batch
    if tables is None:
        raise ValueError("id-feed batch requires EmbedTables (got tables=None)")
    return dataclasses.replace(
        batch,
        node_emb=tables.entity[batch.node_rows.long()],
        edge_emb=tables.relation[batch.edge_rows.long()],
        node_rows=None,
        edge_rows=None,
    )


def materialize_agent_batch(batch: AgentBatch, tables: EmbedTables | None) -> AgentBatch:
    """``AgentBatch`` twin of ``materialize_retriever_batch``."""
    return materialize_retriever_batch(batch, tables)


def replicate_agent_batch(batch: AgentBatch, copies: int) -> AgentBatch:
    """``copies`` copies of a flat batch as one batch of ``copies * G``
    graphs: copy r owns graphs ``[r G, (r + 1) G)``, nodes ``[r N, ...)``,
    edges ``[r E, ...)`` and pairs ``[r P, ...)``, each with its own padding
    graph.  R rollouts over one batch run as one rollout over this batch, so
    every segment reduction of the rollout stays one launch.  The text
    embeddings are not copied (the embedder reads the original batch)."""
    if copies == 1:
        return batch
    gb, p = batch.graph, batch.pairs
    dev = gb.edge_batch.device
    reps = torch.arange(copies, device=dev, dtype=torch.int32)

    def tile(t):
        return t.repeat((copies,) + (1,) * (t.ndim - 1))

    def shifted(t, step):  # [L] -> [copies * L], copy r shifted by r * step
        return (t[None, :] + (reps * step)[:, None]).reshape(-1).to(t.dtype)

    g, n, e = gb.num_graphs, gb.num_nodes, gb.num_edges
    graph = GraphBatch(
        edge_index=(gb.edge_index[:, None, :] + (reps * n)[None, :, None]).reshape(2, -1).to(gb.edge_index.dtype),
        edge_batch=shifted(gb.edge_batch, g),
        node_batch=shifted(gb.node_batch, g),
        node_ptr=torch.cat([shifted(gb.node_ptr[:-1], n), gb.node_ptr.new_full((1,), copies * n)]),
        edge_ptr=torch.cat([shifted(gb.edge_ptr[:-1], e), gb.edge_ptr.new_full((1,), copies * e)]),
        node_mask=tile(gb.node_mask), edge_mask=tile(gb.edge_mask), graph_mask=tile(gb.graph_mask),
    )
    pairs = PairSupervision(
        pair_batch=shifted(p.pair_batch, g), pair_start_local=tile(p.pair_start_local),
        pair_answer_local=tile(p.pair_answer_local), pair_shortest_len=tile(p.pair_shortest_len),
        pair_mask=tile(p.pair_mask),
    )
    return AgentBatch(
        graph=graph, edge_scores=tile(batch.edge_scores), edge_relations=tile(batch.edge_relations),
        node_emb=None, node_is_nontext=tile(batch.node_is_nontext), edge_emb=None,
        question_emb=tile(batch.question_emb), node_is_start=tile(batch.node_is_start),
        node_is_answer=tile(batch.node_is_answer), is_dummy=tile(batch.is_dummy),
        edge_labels=tile(batch.edge_labels), pairs=pairs,
    )
