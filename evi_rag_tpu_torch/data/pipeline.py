"""Loading a materialized retrieval split (``dataset.source=normalized``).

Copy of ``evi_rag_tpu/data/pipeline.py::load_retrieval_split``; the build
side of the pipeline is not ported yet.
"""

from __future__ import annotations

import pathlib

import numpy as np

from evi_rag_tpu_torch.data.sample import RetrievalSample
from evi_rag_tpu_torch.data.store import SampleStore


def load_retrieval_split(
    out_dir: str | pathlib.Path,
    split: str,
    *,
    filter_ids: set[str] | None = None,
    sample_limit: int | None = None,
    seed: int = 0,
    validate: bool = True,
) -> tuple[list[RetrievalSample], np.ndarray]:
    """Read a materialized split back as samples + question matrix.

    ``filter_ids`` applies a sub/nonzero filter; ``sample_limit`` subsamples
    with a deterministic seed.
    """
    store = SampleStore(pathlib.Path(out_dir) / "materialized" / split, expected_artifact="g_retrieval")
    ids = store.ids
    if filter_ids is not None:
        ids = [i for i in ids if i in filter_ids]
    if sample_limit is not None and len(ids) > sample_limit:
        rng = np.random.default_rng(seed)
        ids = [ids[i] for i in sorted(rng.choice(len(ids), size=sample_limit, replace=False))]
    samples: list[RetrievalSample] = []
    q_embs: list[np.ndarray] = []
    for qid, sid in enumerate(ids):
        rec = store.get(sid)
        s = RetrievalSample(
            sample_id=sid,
            num_nodes=int(rec["num_nodes"]),
            edge_index=np.stack([rec["edge_src"], rec["edge_dst"]]).astype(np.int32),
            edge_relations=rec["edge_relation_ids"].astype(np.int64),
            node_embedding_ids=rec["node_embedding_ids"].astype(np.int64),
            topic_locals=rec["q_local"].astype(np.int64),
            answer_locals=rec["a_local"].astype(np.int64),
            edge_labels=rec["positive_triple_mask"].astype(bool),
            pair_start_local=rec["pair_start"],
            pair_answer_local=rec["pair_answer"],
            pair_shortest_len=rec["pair_shortest"],
            question_id=qid,
            node_entity_ids=rec["node_entity_ids"],
            answer_entity_ids=rec["answer_entity_ids"],
        )
        if validate:
            s.validate()
        samples.append(s)
        q_embs.append(rec["question_emb"])
    q_matrix = np.stack(q_embs) if q_embs else np.zeros((0, 0), np.float32)
    return samples, q_matrix
