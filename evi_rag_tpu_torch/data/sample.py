"""The per-question retrieval sample record (shared across pipeline/feeder).

Field-level equivalent of the reference's LMDB core+aux sample
(``scripts/build_retrieval_pipeline.py:2141-2234``, validated in
``src/data/g_retrieval_dataset.py:554-827``): a local subgraph with entity
vocab ids, embedding-table rows (0 == non-text), topic/answer locals, the
undirected-BFS ``positive_triple_mask`` supervision as ``edge_labels``, and
the pair-level CSR shortest-path fields.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RetrievalSample:
    sample_id: str
    num_nodes: int
    edge_index: np.ndarray          # [2, E] local node ids
    edge_relations: np.ndarray      # [E] relation vocab ids
    node_embedding_ids: np.ndarray  # [N] embedding rows (0 == non-text)
    topic_locals: np.ndarray        # [S] seed (question-entity) locals
    answer_locals: np.ndarray       # [A]
    edge_labels: np.ndarray         # [E] bool/float positive_triple_mask
    pair_start_local: np.ndarray    # [P]
    pair_answer_local: np.ndarray   # [P]
    pair_shortest_len: np.ndarray   # [P]
    question_id: int                # row into the split's question embedding matrix
    node_entity_ids: np.ndarray | None = None   # [N] global entity vocab ids
    answer_entity_ids: np.ndarray | None = None  # [A] global ids (audit field)

    def validate(self) -> None:
        """Fail-fast invariant checks (the reference's de-facto test strategy,
        SURVEY §4): index ranges, shape agreement, local bounds."""
        e = self.edge_index.shape[1]
        if self.edge_index.shape[0] != 2:
            raise ValueError(f"{self.sample_id}: edge_index must be [2, E]")
        if self.edge_relations.shape[0] != e or self.edge_labels.shape[0] != e:
            raise ValueError(f"{self.sample_id}: edge field length mismatch")
        if self.node_embedding_ids.shape[0] != self.num_nodes:
            raise ValueError(f"{self.sample_id}: node_embedding_ids length mismatch")
        if e and (self.edge_index.min() < 0 or self.edge_index.max() >= self.num_nodes):
            raise ValueError(f"{self.sample_id}: edge_index out of range")
        for name in ("topic_locals", "answer_locals", "pair_start_local", "pair_answer_local"):
            arr = getattr(self, name)
            if arr.size and (arr.min() < 0 or arr.max() >= self.num_nodes):
                raise ValueError(f"{self.sample_id}: {name} out of range")
        p = self.pair_start_local.shape[0]
        if self.pair_answer_local.shape[0] != p or self.pair_shortest_len.shape[0] != p:
            raise ValueError(f"{self.sample_id}: pair field length mismatch")
        # Cross-field invariants (reference validator depth,
        # g_retrieval_dataset.py:597-827): duplicate anchors, pair lengths,
        # label/pair consistency.
        import numpy as _np

        for name in ("topic_locals", "answer_locals"):
            arr = getattr(self, name)
            if arr.size != _np.unique(arr).size:
                raise ValueError(f"{self.sample_id}: duplicate entries in {name}")
        if p and int(self.pair_shortest_len.min()) < 0:
            raise ValueError(f"{self.sample_id}: negative pair_shortest_len")
        if p:
            zero_len = self.pair_shortest_len == 0
            same = self.pair_start_local == self.pair_answer_local
            if bool((zero_len != same).any()):
                raise ValueError(
                    f"{self.sample_id}: pair_shortest_len==0 must coincide with start==answer"
                )
        if bool(_np.asarray(self.edge_labels).any()) and p == 0:
            raise ValueError(
                f"{self.sample_id}: positive edges without pair supervision"
            )
