"""Bucketed batch collation: samples -> padded retriever and agent batches.

Counterpart of ``evi_rag_tpu/data/feeder.py``, with
the same bucket policy (node and edge totals rounded up to a base times a
power of two, one graph slot reserved for the padding graph), the same
numpy shuffle (``default_rng(seed)``), so both packages see the same batches
in the same order, and the same arrays bit for bit.  Batches are CPU
tensors; ``pin=True`` puts them in page-locked memory so that
``ops.graph.batch_to`` copies them to the card without blocking the host.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from evi_rag_tpu_torch.data.g_agent import AgentSample
from evi_rag_tpu_torch.data.sample import RetrievalSample
from evi_rag_tpu_torch.models.batches import AgentBatch, PairSupervision, RetrieverBatch
from evi_rag_tpu_torch.ops.graph import GraphBatch, map_tensors, pad_graph_arrays


def prefetch(iterator, *, size: int = 2):
    """Background-thread prefetch: one daemon thread keeps ``size`` collated
    batches in flight, so host collation overlaps the device's step."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item


def round_up_pow2(x: int, base: int = 128) -> int:
    """Round up to base * 2^k (>= base)."""
    if x <= base:
        return base
    k = int(np.ceil(np.log2(x / base)))
    return base * (1 << k)


@dataclasses.dataclass(frozen=True)
class Bucket:
    graphs: int
    nodes: int
    edges: int
    pairs: int = 0

    @staticmethod
    def for_batch(
        num_graphs: int,
        total_nodes: int,
        total_edges: int,
        total_pairs: int = 0,
        *,
        node_base: int = 128,
        edge_base: int = 512,
        pair_base: int = 64,
    ) -> "Bucket":
        return Bucket(
            graphs=num_graphs + 1,  # +1 reserved padding graph slot
            nodes=round_up_pow2(total_nodes + 1, node_base),
            edges=round_up_pow2(total_edges + 1, edge_base),
            pairs=round_up_pow2(max(total_pairs, 1), pair_base),
        )


def _tensor(arr: np.ndarray | None, pin: bool) -> torch.Tensor | None:
    if arr is None:
        return None
    t = torch.from_numpy(arr)
    return t.pin_memory() if pin else t


def collate_retriever(
    samples: Sequence[RetrievalSample],
    *,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    bucket: Bucket,
    with_pairs: bool = False,
    id_feed: bool = False,
    pin: bool = False,
) -> RetrieverBatch | tuple[RetrieverBatch, PairSupervision]:
    """Gather embeddings and pack one padded ``RetrieverBatch`` on the host.

    ``id_feed=True`` skips the dense gathers and emits int32 table rows
    (``node_rows`` / ``edge_rows``; padding rows point at the tables' zero
    pad row), which the step resolves on the device from ``EmbedTables``.
    ``with_pairs=True`` also returns the samples' (start, answer) pair
    supervision, padded to ``bucket.pairs`` (padding pairs on the padding
    graph, masked off)."""
    G, N, E = bucket.graphs, bucket.nodes, bucket.edges
    graph = pad_graph_arrays(
        edge_index=[s.edge_index for s in samples],
        num_nodes=[s.num_nodes for s in samples],
        bucket_graphs=G, bucket_nodes=N, bucket_edges=E,
    )
    if id_feed:
        node_rows = np.full(N, entity_emb.shape[0], dtype=np.int32)
        edge_rows = np.full(E, relation_emb.shape[0], dtype=np.int32)
        node_emb = edge_emb = None
    else:
        node_emb = np.zeros((N, entity_emb.shape[1]), dtype=np.float32)
        edge_emb = np.zeros((E, relation_emb.shape[1]), dtype=np.float32)
        node_rows = edge_rows = None
    node_is_nontext = np.zeros(N, dtype=bool)
    topic_one_hot = np.zeros((N, 2), dtype=np.float32)
    node_is_q = np.zeros(N, dtype=bool)
    node_is_a = np.zeros(N, dtype=bool)
    edge_labels = np.zeros(E, dtype=np.float32)
    q_emb = np.zeros((G, question_emb.shape[1]), dtype=np.float32)

    n_off = e_off = 0
    for g, s in enumerate(samples):
        nn, ne = s.num_nodes, s.edge_index.shape[1]
        ids = s.node_embedding_ids
        if id_feed:
            node_rows[n_off : n_off + nn] = ids
            edge_rows[e_off : e_off + ne] = s.edge_relations
        else:
            node_emb[n_off : n_off + nn] = entity_emb[ids]
            edge_emb[e_off : e_off + ne] = relation_emb[s.edge_relations]
        node_is_nontext[n_off : n_off + nn] = ids == 0
        topic_one_hot[n_off + s.topic_locals, 0] = 1.0
        non_topic = np.setdiff1d(np.arange(nn), s.topic_locals)
        topic_one_hot[n_off + non_topic, 1] = 1.0
        node_is_q[n_off + s.topic_locals] = True
        node_is_a[n_off + s.answer_locals] = True
        edge_labels[e_off : e_off + ne] = s.edge_labels.astype(np.float32)
        q_emb[g] = question_emb[s.question_id]
        n_off += nn
        e_off += ne

    batch = RetrieverBatch(
        graph=GraphBatch(**{k: _tensor(v, pin) for k, v in graph.items()}),
        node_emb=_tensor(node_emb, pin),
        node_is_nontext=_tensor(node_is_nontext, pin),
        edge_emb=_tensor(edge_emb, pin),
        question_emb=_tensor(q_emb, pin),
        topic_one_hot=_tensor(topic_one_hot, pin),
        edge_labels=_tensor(edge_labels, pin),
        node_is_q=_tensor(node_is_q, pin),
        node_is_a=_tensor(node_is_a, pin),
        node_rows=_tensor(node_rows, pin),
        edge_rows=_tensor(edge_rows, pin),
    )
    if not with_pairs:
        return batch
    return batch, _pairs(samples, bucket.pairs, G - 1, pin)


def _pairs(samples: Sequence, num_pairs: int, pad_graph: int, pin: bool) -> PairSupervision:
    """The samples' pair supervision laid end to end in ``num_pairs``
    padded slots (graph g's pairs carry ``pair_batch = g``)."""
    pair_batch = np.full(num_pairs, pad_graph, dtype=np.int32)
    pair_start = np.zeros(num_pairs, dtype=np.int32)
    pair_answer = np.zeros(num_pairs, dtype=np.int32)
    pair_len = np.zeros(num_pairs, dtype=np.int32)
    pair_mask = np.zeros(num_pairs, dtype=bool)
    p_off = 0
    for g, s in enumerate(samples):
        npair = s.pair_start_local.shape[0]
        if p_off + npair > num_pairs:
            raise ValueError(f"pair bucket overflow: {p_off + npair} > {num_pairs}")
        sl = slice(p_off, p_off + npair)
        pair_batch[sl] = g
        pair_start[sl] = s.pair_start_local
        pair_answer[sl] = s.pair_answer_local
        pair_len[sl] = s.pair_shortest_len
        pair_mask[sl] = True
        p_off += npair
    t = lambda a: _tensor(a, pin)  # noqa: E731
    return PairSupervision(pair_batch=t(pair_batch), pair_start_local=t(pair_start),
                           pair_answer_local=t(pair_answer), pair_shortest_len=t(pair_len), pair_mask=t(pair_mask))


def iter_retriever_batches(
    samples: Sequence[RetrievalSample],
    *,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    batch_size: int,
    bucket: Bucket | None = None,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
) -> Iterator[RetrieverBatch]:
    """Yield padded batches; a fixed global bucket keeps one shape."""
    order = np.arange(len(samples))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    if bucket is None:
        bucket = fixed_bucket_for(samples, batch_size)
    for i in range(0, len(order), batch_size):
        idx = order[i : i + batch_size]
        if drop_last and idx.size < batch_size:
            break
        yield collate_retriever(
            [samples[j] for j in idx], entity_emb=entity_emb, relation_emb=relation_emb,
            question_emb=question_emb, bucket=bucket,
        )


def _worst_batch_sum(values: Sequence[int], batch_size: int) -> int:
    """Upper bound on any batch's total under ANY ordering: the sum of the
    ``batch_size`` largest samples."""
    return int(sum(sorted(values, reverse=True)[:batch_size]))


def collate_agent(
    samples: Sequence[AgentSample],
    *,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    bucket: Bucket,
    id_feed: bool = False,
    pin: bool = False,
) -> AgentBatch:
    """Pack agent samples into one padded AgentBatch (GFlowNet env input).

    ``id_feed`` and ``pin``: see ``collate_retriever``."""
    G, N, E, P = bucket.graphs, bucket.nodes, bucket.edges, bucket.pairs
    pad_graph = G - 1

    graph = pad_graph_arrays(
        edge_index=[np.stack([s.edge_head_locals, s.edge_tail_locals]).astype(np.int32) for s in samples],
        num_nodes=[s.num_nodes for s in samples],
        bucket_graphs=G, bucket_nodes=N, bucket_edges=E,
    )

    d = entity_emb.shape[1]
    if id_feed:
        node_rows = np.full(N, entity_emb.shape[0], dtype=np.int32)
        edge_rows = np.full(E, relation_emb.shape[0], dtype=np.int32)
        node_emb = edge_emb = None
    else:
        node_emb = np.zeros((N, d), dtype=np.float32)
        edge_emb = np.zeros((E, relation_emb.shape[1]), dtype=np.float32)
        node_rows = edge_rows = None
    node_is_nontext = np.zeros(N, dtype=bool)
    node_is_start = np.zeros(N, dtype=bool)
    node_is_answer = np.zeros(N, dtype=bool)
    edge_scores = np.zeros(E, dtype=np.float32)
    edge_relations = np.zeros(E, dtype=np.int32)
    edge_labels = np.zeros(E, dtype=np.float32)
    q_emb = np.zeros((G, question_emb.shape[1]), dtype=np.float32)
    is_dummy = np.zeros(G, dtype=bool)

    n_off = e_off = 0
    for g, s in enumerate(samples):
        nn, ne = s.num_nodes, s.num_edges
        ids = s.node_embedding_ids
        if id_feed:
            node_rows[n_off : n_off + nn] = ids
            edge_rows[e_off : e_off + ne] = s.edge_relations
        else:
            node_emb[n_off : n_off + nn] = entity_emb[ids]
            edge_emb[e_off : e_off + ne] = relation_emb[s.edge_relations]
        node_is_nontext[n_off : n_off + nn] = ids == 0
        node_is_start[n_off + s.start_node_locals] = True
        node_is_answer[n_off + s.answer_node_locals] = True
        edge_scores[e_off : e_off + ne] = s.edge_scores
        edge_relations[e_off : e_off + ne] = s.edge_relations
        edge_labels[e_off : e_off + ne] = s.edge_labels
        q_emb[g] = question_emb[s.question_id]
        is_dummy[g] = s.is_dummy_agent
        n_off += nn
        e_off += ne

    t = lambda a: _tensor(a, pin)  # noqa: E731
    return AgentBatch(
        graph=GraphBatch(**{k: t(v) for k, v in graph.items()}),
        edge_scores=t(edge_scores),
        edge_relations=t(edge_relations),
        node_emb=t(node_emb),
        node_is_nontext=t(node_is_nontext),
        edge_emb=t(edge_emb),
        question_emb=t(q_emb),
        node_is_start=t(node_is_start),
        node_is_answer=t(node_is_answer),
        is_dummy=t(is_dummy),
        edge_labels=t(edge_labels),
        pairs=_pairs(samples, P, pad_graph, pin),
        node_rows=t(node_rows),
        edge_rows=t(edge_rows),
    )


def collate_agent_stacked(
    samples: Sequence[AgentSample],
    *,
    num_shards: int,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    bucket: Bucket,
    id_feed: bool = False,
    pin: bool = False,
) -> AgentBatch:
    """Stacked data-parallel agent collation: a leading ``[S, ...]`` shard
    axis, one padded self-contained agent batch per shard."""
    if len(samples) % num_shards != 0:
        raise ValueError(f"{len(samples)} samples not divisible by {num_shards} shards")
    per = len(samples) // num_shards
    stacked = _stack([
        collate_agent(samples[i * per:(i + 1) * per], entity_emb=entity_emb, relation_emb=relation_emb,
                      question_emb=question_emb, bucket=bucket, id_feed=id_feed)
        for i in range(num_shards)
    ])
    return map_tensors(stacked, lambda t: t.pin_memory()) if pin else stacked


def fixed_agent_bucket(samples: Sequence[AgentSample], batch_size: int) -> Bucket:
    return Bucket.for_batch(
        batch_size,
        _worst_batch_sum([s.num_nodes for s in samples], batch_size),
        _worst_batch_sum([s.num_edges for s in samples], batch_size),
        _worst_batch_sum([s.pair_start_local.shape[0] for s in samples], batch_size),
    )


def collate_stacked(
    samples: Sequence[RetrievalSample],
    *,
    num_shards: int,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    bucket: Bucket,
    id_feed: bool = False,
    pin: bool = False,
) -> RetrieverBatch:
    """Stacked collation: a leading ``[S, ...]`` shard axis, one padded
    self-contained sub-batch per shard (edge indices stay shard-local)."""
    if len(samples) % num_shards != 0:
        raise ValueError(f"{len(samples)} samples not divisible by {num_shards} shards")
    per = len(samples) // num_shards
    shards = [
        collate_retriever(
            samples[i * per : (i + 1) * per], entity_emb=entity_emb, relation_emb=relation_emb,
            question_emb=question_emb, bucket=bucket, id_feed=id_feed,
        )
        for i in range(num_shards)
    ]
    stacked = _stack(shards)
    return map_tensors(stacked, lambda t: t.pin_memory()) if pin else stacked


def _stack(items: list):
    first = items[0]
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: _stack([getattr(x, f.name) for x in items]) for f in dataclasses.fields(first)
        })
    if first is None:
        return None
    return torch.stack(items, dim=0)


def iter_stacked_batches(
    samples: Sequence[RetrievalSample],
    *,
    num_shards: int,
    per_shard_batch: int,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    bucket: Bucket | None = None,
    shuffle: bool = True,
    seed: int = 0,
    id_feed: bool = False,
    pin: bool = False,
) -> Iterator[RetrieverBatch]:
    """Yield stacked batches of ``num_shards * per_shard_batch`` samples."""
    chunk = num_shards * per_shard_batch
    if bucket is None:
        bucket = fixed_bucket_for(samples, per_shard_batch)
    order = np.arange(len(samples))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    usable = (len(order) // chunk) * chunk
    for i in range(0, usable, chunk):
        yield collate_stacked(
            [samples[j] for j in order[i : i + chunk]], num_shards=num_shards,
            entity_emb=entity_emb, relation_emb=relation_emb, question_emb=question_emb,
            bucket=bucket, id_feed=id_feed, pin=pin,
        )


def fixed_bucket_for(samples: Sequence[RetrievalSample], batch_size: int) -> Bucket:
    """One bucket covering the worst-case batch under any shuffle order, so
    no collation can overflow mid-epoch."""
    return Bucket.for_batch(
        batch_size,
        _worst_batch_sum([s.num_nodes for s in samples], batch_size),
        _worst_batch_sum([s.edge_index.shape[1] for s in samples], batch_size),
        _worst_batch_sum([s.pair_start_local.shape[0] for s in samples], batch_size),
    )
