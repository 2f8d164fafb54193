"""Synthetic KGQA sample generator for tests and benchmarks.

Produces per-question subgraph samples with the same semantics the reference
build pipeline materializes into LMDB (``scripts/build_retrieval_pipeline.py:
2141-2234``): a local node set with text-embedding ids, a directed edge list
with relation ids, topic (seed) one-hot, answer locals, and undirected-BFS
shortest-path supervision (positive_triple_mask + pair CSR) computed with the
same rule as the reference (``_shortest_path_union_mask_by_pair``,
``build_retrieval_pipeline.py:691-752``).

The generator plants a ground-truth path from a seed to an answer and
surrounds it with distractor edges, so learned retrievers have signal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from evi_rag_tpu_torch.data.bfs_label import shortest_path_union_by_pair
from evi_rag_tpu_torch.data.sample import RetrievalSample

# Synthetic samples are ordinary retrieval samples.
SyntheticSample = RetrievalSample


@dataclasses.dataclass
class SyntheticDataset:
    samples: list[SyntheticSample]
    entity_emb: np.ndarray    # [num_entities, D]
    relation_emb: np.ndarray  # [num_relations, D]
    question_emb: np.ndarray  # [num_questions, D]
    emb_dim: int


def make_synthetic_dataset(
    *,
    num_samples: int = 32,
    emb_dim: int = 64,
    num_entities: int = 512,
    num_relations: int = 32,
    min_nodes: int = 8,
    max_nodes: int = 40,
    path_len_range: tuple[int, int] = (1, 3),
    avg_extra_edges: float = 2.0,
    nontext_fraction: float = 0.1,
    num_seeds: int = 1,
    distractor_relation_overlap: float = 1.0,
    num_answers: int = 1,
    layered_distractors: bool = False,
    seed: int = 0,
) -> SyntheticDataset:
    rng = np.random.default_rng(seed)
    entity_emb = rng.normal(size=(num_entities, emb_dim)).astype(np.float32)
    entity_emb[0] = 0.0  # row 0 reserved for non-text entities (reference convention)
    relation_emb = rng.normal(size=(num_relations, emb_dim)).astype(np.float32)
    question_emb = np.zeros((num_samples, emb_dim), dtype=np.float32)

    samples: list[SyntheticSample] = []
    for qid in range(num_samples):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        plen = int(rng.integers(path_len_range[0], path_len_range[1] + 1))
        plen = min(plen, max(n - 1, 1))
        # Plant the path 0 -> 1 -> ... -> plen; extra seeds/answers attach to it
        # (multi-pair supervision like real multi-entity questions).
        path_edges = [(i, i + 1) for i in range(plen)]
        extra_seeds = []
        extra_answers = []
        free = list(range(plen + 1, n))
        rng.shuffle(free)
        for _ in range(max(num_seeds - 1, 0)):
            if not free:
                break
            v = free.pop()
            path_edges.append((v, 0))  # one hop into the main path start
            extra_seeds.append(v)
        for _ in range(max(num_answers - 1, 0)):
            if not free:
                break
            v = free.pop()
            path_edges.append((plen, v))  # one hop past the main answer
            extra_answers.append(v)
        # Distractor edges.  With ``layered_distractors`` every node gets a
        # layer in [0, plen] (path node i at layer i) and distractors only
        # connect nodes WITHIN a layer: any undirected walk from the seed
        # (layer 0) to the answer (layer plen) must then cross layers through
        # the planted path edges, so the planted path is PROVABLY the unique
        # shortest path and the BFS supervision keeps exactly its edges
        # positive -- including the middle (bridge) edges.  Without it,
        # uniform random distractors routinely shortcut multi-hop paths and
        # supervision drifts onto relation-uninformative shortcut edges
        # (and |layer diff| <= 1 variants admit whole alternative shortest
        # paths through distractors, flooding the positive set: measured
        # pos_edge_frac 0.40 and margin_positive_rate 0.06 on the quality
        # gate's config vs 0.05 / healthy margins with the within-layer rule).
        extra = int(rng.poisson(avg_extra_edges * n))
        src = rng.integers(0, n, size=extra)
        dst = rng.integers(0, n, size=extra)
        keep = src != dst
        if layered_distractors and plen >= 2:
            layer = rng.integers(0, plen + 1, size=n)
            layer[: plen + 1] = np.arange(plen + 1)
            for v in extra_seeds:
                layer[v] = 0
            for v in extra_answers:
                layer[v] = plen
            keep &= layer[src] == layer[dst]
        edges = path_edges + list(zip(src[keep].tolist(), dst[keep].tolist()))
        edge_index = np.asarray(edges, dtype=np.int64).T.reshape(2, -1)

        # Relation assignment.  With overlap < 1, each question draws a small
        # private relation set for its planted path and distractors mostly
        # avoid it -- mirroring real KGs where the answer relation is
        # distinctive -- so the question-conditioned scorer has a clean
        # learnable signal (the default 1.0 keeps relations uniform).
        n_planted = len(path_edges)
        rel = rng.integers(0, num_relations, size=edge_index.shape[1]).astype(np.int64)
        if distractor_relation_overlap < 1.0 and num_relations >= 4:
            k_path = min(3, max(1, num_relations // 8))
            path_set = rng.choice(num_relations, size=k_path, replace=False)
            rel[:n_planted] = rng.choice(path_set, size=n_planted)
            others = np.setdiff1d(np.arange(num_relations), path_set)
            n_rest = edge_index.shape[1] - n_planted
            if n_rest > 0:
                off_path = rng.choice(others, size=n_rest)
                keep_uniform = rng.random(n_rest) < distractor_relation_overlap
                rel[n_planted:] = np.where(keep_uniform, rel[n_planted:], off_path)
        emb_ids = rng.integers(1, num_entities, size=n).astype(np.int64)
        nontext = rng.random(n) < nontext_fraction
        emb_ids[nontext] = 0

        topic = np.asarray([0] + extra_seeds, dtype=np.int64)
        answer = np.asarray([plen] + extra_answers, dtype=np.int64)
        mask, ps, pa, _, _, plens = shortest_path_union_by_pair(
            num_nodes=n,
            edge_src=edge_index[0],
            edge_dst=edge_index[1],
            sources=topic,
            targets=answer,
        )
        # Question embedding correlates with the planted relations, so a
        # trained scorer has learnable signal.
        question_emb[qid] = relation_emb[rel[: plen]].mean(axis=0) + 0.1 * rng.normal(size=emb_dim)

        samples.append(
            SyntheticSample(
                sample_id=f"syn-{qid}",
                num_nodes=n,
                edge_index=edge_index.astype(np.int32),
                edge_relations=rel,
                node_embedding_ids=emb_ids,
                topic_locals=topic,
                answer_locals=answer,
                edge_labels=np.asarray(mask, dtype=bool),
                pair_start_local=np.asarray(ps, dtype=np.int32),
                pair_answer_local=np.asarray(pa, dtype=np.int32),
                pair_shortest_len=np.asarray(plens, dtype=np.int32),
                question_id=qid,
            )
        )
    return SyntheticDataset(
        samples=samples,
        entity_emb=entity_emb,
        relation_emb=relation_emb,
        question_emb=question_emb,
        emb_dim=emb_dim,
    )
