"""Typed batches the retriever consumes.

Counterpart of the retriever half of ``evi_rag_tpu/models/batches.py``:
padded buckets of per-question subgraphs, with variable-length index lists
(topic and answer locals) as node masks.
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


def make_tables(entity_emb, relation_emb, *, device: str | torch.device | None = None) -> EmbedTables:
    """Upload the entity and relation tables once (plus the zero pad row) to
    ``device`` (the card unless ``"cpu"`` is named; raises without one)."""
    dev = resolve_device(device)

    def pad(t):
        t = np.asarray(t, dtype=np.float32)
        return torch.from_numpy(np.concatenate([t, np.zeros((1, t.shape[1]), t.dtype)])).to(dev)

    return EmbedTables(entity=pad(entity_emb), relation=pad(relation_emb))


def materialize_retriever_batch(batch: RetrieverBatch, tables: EmbedTables | None) -> RetrieverBatch:
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
