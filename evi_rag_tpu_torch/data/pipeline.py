"""Offline data build: raw KGQA rows -> normalized artifacts + sample store.

Counterpart of the builder half of ``evi_rag_tpu/data/pipeline.py`` (and of
its ``load_retrieval_split``), with the same outputs for the same inputs:

1. **Vocab pass** -- entity / relation vocabularies over all splits; entities
   split into text vs non-text by a policy (non-text entities share
   embedding row 0).
2. **Embedding pass** -- a frozen text encoder over entity / relation /
   question text into ``.npy`` tables (``data/text_encoder.py``,
   ``data/gte.py``).
3. **Graph pass** -- per question: local node indexing, self-loop removal
   and (h, r, t) dedup, per-pair shortest-path supervision
   (``data/native.py``: the native graphcore engine or numpy),
   answer_subgraph-priority labeling; ``sub_filter.json`` and
   ``nonzero_positive_filter.json``.
4. **Materialize** -- a ``SampleStore`` per split.

``build_from_samples`` runs passes 1-4 over ``RawSample``s from any source
and returns the four normalized tables as row lists; ``build_pipeline``
reads the raw parquet shards, runs it and writes the tables as parquet (the
JAX package's ``build_pipeline``).  ``read_raw_rows`` turns rows held in
memory into ``RawSample``s by the same per-row rules as ``read_raw_parquet``,
so a build needs ``pyarrow`` only to read and write parquet.  Pass 3 runs in
``num_workers`` spawned processes when that is above 0, with the records in
the same order.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import pathlib
import re
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Iterable, Iterator

import numpy as np

from evi_rag_tpu_torch.data.native import best_shortest_path_union
from evi_rag_tpu_torch.data.sample import RetrievalSample
from evi_rag_tpu_torch.data.store import SampleStore, SampleStoreWriter
from evi_rag_tpu_torch.data.text_encoder import TextEncoder, encode_to_memmap

NON_TEXT_EMBEDDING_ID = 0
VALID_SPLITS = ("train", "validation", "test")


@dataclasses.dataclass(frozen=True)
class TextEntityPolicy:
    """Which entities have usable text (mode: all | exclude_regex | regex).

    ``regex`` mode matches the reference verbatim: an entity is text iff the
    pattern matches (reference ``TextEntityConfig.is_text``,
    ``build_retrieval_pipeline.py:95-101``; dataset configs carry patterns
    like ``^(?!m\\.|g\\.).*`` for Freebase / ``^(?!Q\\d+|P\\d+).+`` for
    Wikidata)."""

    mode: str = "all"
    exclude_regex: str | None = None  # e.g. r"^(m|g)\." for Freebase CVTs
    match_regex: str | None = None  # reference-style keep-if-match pattern

    def is_text(self, entity: str) -> bool:
        if self.mode == "all":
            return True
        if self.mode == "exclude_regex":
            if not self.exclude_regex:
                raise ValueError("exclude_regex mode requires a pattern")
            return re.match(self.exclude_regex, entity) is None
        if self.mode == "regex":
            if not self.match_regex:
                raise ValueError("regex mode requires match_regex")
            return re.match(self.match_regex, entity) is not None
        raise ValueError(f"unknown text-entity mode {self.mode!r}")


@dataclasses.dataclass
class RawSample:
    dataset: str
    split: str
    question_id: str
    question: str
    q_entity: list[str]
    a_entity: list[str]
    graph: list[tuple[str, str, str]]
    answer_texts: list[str] = dataclasses.field(default_factory=list)
    answer_subgraph: list[tuple[str, str, str]] | None = None
    graph_iso_type: str | None = None  # GTSQA graph_isomorphism
    redundant: bool | None = None  # GTSQA redundant flag
    test_type: list[str] = dataclasses.field(default_factory=list)  # GTSQA

    @property
    def graph_id(self) -> str:
        return f"{self.dataset}/{self.split}/{self.question_id}"


@dataclasses.dataclass(frozen=True)
class SplitFilter:
    """Ingestion-time sample filters (reference ``SplitFilter``,
    ``build_retrieval_pipeline.py:52-56``; defaults all-off, ``:2300-2303``)."""

    skip_no_topic: bool = False
    skip_no_ans: bool = False
    skip_no_path: bool = False


def has_connectivity(
    graph: list[tuple[str, str, str]],
    q_entity: list[str],
    a_entity: list[str],
    *,
    path_mode: str = "undirected",
) -> bool:
    """BFS reachability seed->answer over the raw string graph
    (reference ``has_connectivity``, ``build_retrieval_pipeline.py:955-980``)."""
    node_ids: dict[str, int] = {}
    for h, _, t in graph:
        node_ids.setdefault(h, len(node_ids))
        node_ids.setdefault(t, len(node_ids))
    seeds = [node_ids[e] for e in q_entity if e in node_ids]
    answers = {node_ids[e] for e in a_entity if e in node_ids}
    if not seeds or not answers:
        return False
    adj: list[list[int]] = [[] for _ in range(len(node_ids))]
    for h, _, t in graph:
        u, v = node_ids[h], node_ids[t]
        adj[u].append(v)
        if path_mode != "directed":
            adj[v].append(u)
    from collections import deque

    seen = set(seeds)
    dq = deque(seeds)
    while dq:
        u = dq.popleft()
        if u in answers:
            return True
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                dq.append(v)
    return bool(seen & answers)


def should_keep_sample(
    sample: RawSample, split_filter: SplitFilter, *, path_mode: str = "undirected"
) -> bool:
    """Reference keep-predicate (``_should_keep_sample``, ``:1028-1055``):
    an answer_subgraph implies connectivity."""
    node_strings = {h for h, _, t in sample.graph} | {t for _, _, t in sample.graph}
    if split_filter.skip_no_topic and not any(e in node_strings for e in sample.q_entity):
        return False
    if split_filter.skip_no_ans and not any(e in node_strings for e in sample.a_entity):
        return False
    if split_filter.skip_no_path:
        if sample.answer_subgraph:
            return True
        return has_connectivity(
            sample.graph, sample.q_entity, sample.a_entity, path_mode=path_mode
        )
    return True


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    dataset: str
    raw_root: str
    out_dir: str
    text_policy: TextEntityPolicy = TextEntityPolicy()
    path_mode: str = "undirected"
    dedup_edges: bool = True
    remove_self_loops: bool = True
    emit_sub_filter: bool = True
    emit_nonzero_positive_filter: bool = True
    nonzero_positive_filter_splits: tuple[str, ...] | None = ("train",)
    num_workers: int = 0
    encode_batch_size: int = 256
    entity_normalization: str = "none"  # none | qid_in_parentheses
    train_filter: SplitFilter = SplitFilter()
    eval_filter: SplitFilter = SplitFilter()

    def split_filter(self, split: str) -> SplitFilter:
        return self.train_filter if split == "train" else self.eval_filter


class Vocab:
    """Entity/relation vocabularies with text/non-text embedding rows."""

    def __init__(self, text_policy: TextEntityPolicy) -> None:
        self.text_policy = text_policy
        self.entity_to_id: dict[str, int] = {}
        self.relation_to_id: dict[str, int] = {}
        self._finalized = False
        self.entity_embedding_id: dict[str, int] = {}
        self.text_entities: list[str] = []

    def add_entity(self, ent: str) -> int:
        eid = self.entity_to_id.get(ent)
        if eid is None:
            if self._finalized:
                raise RuntimeError("vocab finalized")
            eid = len(self.entity_to_id)
            self.entity_to_id[ent] = eid
        return eid

    def add_relation(self, rel: str) -> int:
        rid = self.relation_to_id.get(rel)
        if rid is None:
            rid = len(self.relation_to_id)
            self.relation_to_id[rel] = rid
        return rid

    def finalize(self) -> None:
        if self._finalized:
            return
        self.text_entities = sorted(e for e in self.entity_to_id if self.text_policy.is_text(e))
        # Embedding row 0 reserved for non-text entities.
        self.entity_embedding_id = {e: i + 1 for i, e in enumerate(self.text_entities)}
        self._finalized = True

    def embedding_id(self, ent: str) -> int:
        return self.entity_embedding_id.get(ent, NON_TEXT_EMBEDDING_ID)

    def entity_records(self) -> list[dict[str, Any]]:
        return [
            {
                "entity_id": eid,
                "kg_id": ent,
                "label": ent,
                "is_text": self.text_policy.is_text(ent),
                "embedding_id": self.embedding_id(ent),
            }
            for ent, eid in sorted(self.entity_to_id.items(), key=lambda kv: kv[1])
        ]

    def relation_records(self) -> list[dict[str, Any]]:
        return [
            {"relation_id": rid, "kg_id": rel, "label": rel}
            for rel, rid in sorted(self.relation_to_id.items(), key=lambda kv: kv[1])
        ]


# Default column map: reference HF RoG schema keys
# (reference ``configs/dataset/webqsp.yaml`` column_map).
DEFAULT_COLUMN_MAP: dict[str, str] = {
    "question_id_field": "id",
    "question_field": "question",
    "answer_text_field": "answer",
    "q_entity_field": "q_entity",
    "a_entity_field": "a_entity",
    "graph_field": "graph",
    # Read when the column exists (GTSQA names it explicitly; auto-detected
    # otherwise for backward compatibility with pre-column-map callers).
    "answer_subgraph_field": "answer_subgraph",
}

# Reference normalization regexes (``build_retrieval_pipeline.py:352-353``):
# KGQAGen mixes "Label (Q123)" strings with bare QIDs; both entity mentions
# and seed/answer fields must normalize to the QID.
_QID_IN_PARENS_RE = re.compile(r"(Q\d+)")
_LABEL_QID_RE = re.compile(r"(.+)\s+\((Q\d+)\)$")


def normalize_entity(entity: str, mode: str) -> str:
    """``qid_in_parentheses``: extract the QID if present
    (reference ``build_retrieval_pipeline.py:982-987``)."""
    if mode == "qid_in_parentheses":
        m = _QID_IN_PARENS_RE.search(entity)
        if m:
            return m.group(1)
    return entity


def normalize_entity_with_lookup(
    entity: str, mode: str, label_to_qid: dict[str, str]
) -> str:
    """Fall back to the per-row label->QID map built from graph mentions
    (reference ``:990-996``: seeds/answers may carry only the label)."""
    normalized = normalize_entity(entity, mode)
    if mode == "qid_in_parentheses" and normalized == entity:
        qid = label_to_qid.get(entity)
        if qid:
            return qid
    return normalized


def to_list(field: Any) -> list[str]:
    """Coerce scalar / list / numpy fields to list[str]
    (reference ``:998-1007``; e.g. WebQSP ``answer`` can be a scalar)."""
    if field is None:
        return []
    if isinstance(field, (list, tuple)):
        return [str(x) for x in field]
    if isinstance(field, np.ndarray):
        return [str(x) for x in field.tolist()]
    return [str(field)]


def _split_files(raw_root: pathlib.Path) -> dict[str, list[pathlib.Path]]:
    """Group ``<split>-*.parquet`` / ``<split>.parquet`` shards by split
    (reference ``load_split`` globs ``{split}-*.parquet``, ``:1011-1015``)."""
    out: dict[str, list[pathlib.Path]] = {}
    for f in sorted(raw_root.glob("*.parquet")):
        split = f.name.split("-")[0].removesuffix(".parquet")
        if split not in VALID_SPLITS:
            raise ValueError(f"unknown split prefix {split!r} in {f.name}")
        out.setdefault(split, []).append(f)
    if not out:
        raise FileNotFoundError(f"no parquet shards under {raw_root}")
    return out


_LEGACY_COLUMNS = {
    "id": "question_id_field",
    "question": "question_field",
    "answer": "answer_text_field",
    "q_entity": "q_entity_field",
    "a_entity": "a_entity_field",
    "graph": "graph_field",
    "answer_subgraph": "answer_subgraph_field",
}


def _column_map(column_map: dict[str, str] | None) -> dict[str, str]:
    """``DEFAULT_COLUMN_MAP`` updated by ``column_map``, whose keys are the
    ``*_field`` names or, for backward compatibility, plain column names
    (``{"graph": "proof"}``)."""
    cmap = dict(DEFAULT_COLUMN_MAP)
    for k, v in (column_map or {}).items():
        cmap[_LEGACY_COLUMNS.get(k, k)] = v
    return cmap


def _triples(rows: Any, label_to_qid: dict[str, str], entity_normalization: str) -> list[tuple[str, str, str]]:
    out = []
    for tr in rows or []:
        if not isinstance(tr, (list, tuple)) or len(tr) < 3:
            continue
        h_raw, r, t_raw = str(tr[0]), str(tr[1]), str(tr[2])
        if entity_normalization == "qid_in_parentheses":
            for node_raw in (h_raw, t_raw):
                m = _LABEL_QID_RE.match(node_raw)
                if m:
                    label_to_qid[m.group(1).strip()] = m.group(2)
        h = normalize_entity_with_lookup(h_raw, entity_normalization, label_to_qid)
        t = normalize_entity_with_lookup(t_raw, entity_normalization, label_to_qid)
        out.append((h, r, t))
    return out


def raw_sample_from_row(
    row: dict[str, Any],
    *,
    dataset: str,
    split: str,
    cmap: dict[str, str],
    columns: set[str],
    entity_normalization: str = "none",
) -> RawSample:
    """One raw row (a dict of its table's columns) -> ``RawSample``.

    ``cmap`` is a resolved column map (``_column_map``); ``columns``
    names the columns of the row's table: the optional answer_subgraph /
    graph_isomorphism / redundant / test_type fields count only when their
    column is there.  KGQAGen's ``qid_in_parentheses`` label->QID lookup is
    harvested from this row's graph and answer_subgraph mentions."""
    label_to_qid: dict[str, str] = {}
    graph = _triples(row.get(cmap["graph_field"]), label_to_qid, entity_normalization)
    q_entities = [
        normalize_entity_with_lookup(e, entity_normalization, label_to_qid)
        for e in to_list(row.get(cmap["q_entity_field"]))
    ]
    a_entities = [
        normalize_entity_with_lookup(e, entity_normalization, label_to_qid)
        for e in to_list(row.get(cmap["a_entity_field"]))
    ]
    answer_texts = to_list(row.get(cmap["answer_text_field"]))
    answer_sub = None
    as_field = cmap.get("answer_subgraph_field")
    if as_field and as_field in columns:
        sub = _triples(row.get(as_field), label_to_qid, entity_normalization)
        answer_sub = sub or None
    iso = None
    if cmap.get("graph_iso_field") in columns:
        val = row.get(cmap["graph_iso_field"])
        iso = str(val) if val is not None else None
    redundant = None
    if cmap.get("redundant_field") in columns:
        rv = row.get(cmap["redundant_field"])
        if isinstance(rv, bool):
            redundant = rv
        elif rv is not None:
            redundant = str(rv).lower() == "true"
    test_type: list[str] = []
    if cmap.get("test_type_field") in columns:
        test_type = to_list(row.get(cmap["test_type_field"]))
    return RawSample(
        dataset=dataset,
        split=split,
        question_id=str(row[cmap["question_id_field"]]),
        question=str(row.get(cmap["question_field"]) or ""),
        q_entity=q_entities,
        a_entity=a_entities,
        graph=graph,
        answer_texts=answer_texts,
        answer_subgraph=answer_sub,
        graph_iso_type=iso,
        redundant=redundant,
        test_type=test_type,
    )


def read_raw_parquet(
    raw_root: str | pathlib.Path,
    dataset: str,
    *,
    column_map: dict[str, str] | None = None,
    entity_normalization: str = "none",
) -> Iterator[RawSample]:
    """Iterate raw HF-RoG-style parquet shards under raw_root, split by
    split in the sorted order of their file names (needs ``pyarrow``)."""
    import pyarrow.parquet as pq

    cmap = _column_map(column_map)
    for split, files in _split_files(pathlib.Path(raw_root)).items():
        for f in files:
            table = pq.read_table(f)
            names = set(table.column_names)
            for row in table.to_pylist():
                yield raw_sample_from_row(row, dataset=dataset, split=split, cmap=cmap, columns=names,
                                          entity_normalization=entity_normalization)


def read_raw_rows(
    tables: Iterable[tuple[str, list[dict[str, Any]]]],
    dataset: str,
    *,
    column_map: dict[str, str] | None = None,
    entity_normalization: str = "none",
) -> Iterator[RawSample]:
    """``read_raw_parquet`` over rows held in memory: ``tables`` yields
    ``(split, rows)`` in the order to read them, and a table's columns are
    the keys its rows have."""
    cmap = _column_map(column_map)
    for split, rows in tables:
        if split not in VALID_SPLITS:
            raise ValueError(f"unknown split {split!r}")
        names = set().union(*(r.keys() for r in rows))
        for row in rows:
            yield raw_sample_from_row(row, dataset=dataset, split=split, cmap=cmap, columns=names,
                                      entity_normalization=entity_normalization)


@dataclasses.dataclass
class GraphRecord:
    graph_id: str
    split: str
    node_entity_ids: np.ndarray
    node_embedding_ids: np.ndarray
    node_labels: list[str]
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_relation_ids: np.ndarray
    positive_triple_mask: np.ndarray
    q_local: np.ndarray
    a_local: np.ndarray
    pair_start: np.ndarray
    pair_answer: np.ndarray
    pair_edge_ids: np.ndarray
    pair_edge_counts: np.ndarray
    pair_shortest: np.ndarray


def build_graph_record(sample: RawSample, vocab: Vocab, cfg: PipelineConfig) -> GraphRecord:
    node_index: dict[str, int] = {}
    labels: list[str] = []

    def local(ent: str) -> int:
        i = node_index.get(ent)
        if i is None:
            i = len(node_index)
            node_index[ent] = i
            labels.append(ent)
        return i

    src: list[int] = []
    dst: list[int] = []
    rel: list[int] = []
    key_to_edges: dict[tuple[str, str, str], list[int]] = {}
    for h, r, t in sample.graph:
        if cfg.remove_self_loops and h == t:
            continue
        key = (h, r, t)
        if cfg.dedup_edges and key in key_to_edges:
            continue
        src.append(local(h))
        dst.append(local(t))
        rel.append(vocab.add_relation(r))
        key_to_edges.setdefault(key, []).append(len(src) - 1)

    q_local = np.asarray([node_index[e] for e in sample.q_entity if e in node_index], np.int64)
    a_local = np.asarray([node_index[e] for e in sample.a_entity if e in node_index], np.int64)
    src_a = np.asarray(src, np.int64)
    dst_a = np.asarray(dst, np.int64)

    def label(edge_src, edge_dst):
        return best_shortest_path_union(
            num_nodes=len(labels), edge_src=edge_src, edge_dst=edge_dst,
            sources=q_local, targets=a_local, path_mode=cfg.path_mode,
        )

    # Answer-subgraph priority: label within the provided GT edges first.
    answer_edges: list[int] = []
    if sample.answer_subgraph:
        for tr in sample.answer_subgraph:
            answer_edges.extend(key_to_edges.get(tuple(tr), []))
    answer_edges = list(dict.fromkeys(answer_edges))

    mask = np.zeros(len(src), bool)
    if answer_edges:
        sub = np.asarray(answer_edges, np.int64)
        sub_mask, ps, pa, pe, pc, plen = label(src_a[sub], dst_a[sub])
        if ps:
            mask[sub[np.asarray(sub_mask, bool)]] = True
            pe = [int(sub[i]) for i in pe]
        else:
            mask, ps, pa, pe, pc, plen = label(src_a, dst_a)
            mask = np.asarray(mask, bool)
    else:
        mask, ps, pa, pe, pc, plen = label(src_a, dst_a)
        mask = np.asarray(mask, bool)

    return GraphRecord(
        graph_id=sample.graph_id,
        split=sample.split,
        node_entity_ids=np.asarray([vocab.add_entity(e) for e in labels], np.int64),
        node_embedding_ids=np.asarray([vocab.embedding_id(e) for e in labels], np.int64),
        node_labels=labels,
        edge_src=src_a,
        edge_dst=dst_a,
        edge_relation_ids=np.asarray(rel, np.int64),
        positive_triple_mask=mask,
        q_local=q_local,
        a_local=a_local,
        pair_start=np.asarray(ps, np.int64),
        pair_answer=np.asarray(pa, np.int64),
        pair_edge_ids=np.asarray(pe, np.int64),
        pair_edge_counts=np.asarray(pc, np.int64),
        pair_shortest=np.asarray(plen, np.int64),
    )


def _sub_filter_keep(g: GraphRecord) -> bool:
    """Reference sub-filter predicate (``build_retrieval_pipeline.py:
    1363-1376``): topic & answer present, some pair path, and either a
    nonzero minimum path length or disjoint q/a locals."""
    has_topic = g.q_local.size > 0
    has_answer = g.a_local.size > 0
    has_path = g.pair_start.size > 0
    nonzero_min = g.pair_shortest.size > 0 and int(g.pair_shortest.min()) > 0
    no_overlap = not set(g.q_local.tolist()) & set(g.a_local.tolist())
    return has_topic and has_answer and has_path and (nonzero_min or no_overlap)


# Worker-process graph building: the finalized vocab lookups are shipped
# once through the pool initializer, and the workers run build_graph_record.

_WORKER_STATE: dict[str, Any] = {}


class _FrozenVocab:
    """Read-only vocab view safe to ship to worker processes."""

    def __init__(self, vocab: "Vocab") -> None:
        self.entity_to_id = dict(vocab.entity_to_id)
        self.relation_to_id = dict(vocab.relation_to_id)
        self.entity_embedding_id = dict(vocab.entity_embedding_id)

    def add_entity(self, ent: str) -> int:
        try:
            return self.entity_to_id[ent]
        except KeyError:
            raise KeyError(f"entity {ent!r} missing from finalized vocab") from None

    def add_relation(self, rel: str) -> int:
        try:
            return self.relation_to_id[rel]
        except KeyError:
            raise KeyError(f"relation {rel!r} missing from finalized vocab") from None

    def embedding_id(self, ent: str) -> int:
        return self.entity_embedding_id.get(ent, NON_TEXT_EMBEDDING_ID)


def _init_worker(frozen: _FrozenVocab, cfg: "PipelineConfig") -> None:
    _WORKER_STATE["vocab"] = frozen
    _WORKER_STATE["cfg"] = cfg


def _build_graph_worker(sample: RawSample) -> "GraphRecord":
    return build_graph_record(sample, _WORKER_STATE["vocab"], _WORKER_STATE["cfg"])


def _iter_graph_records(
    samples: list[RawSample], vocab: "Vocab", cfg: "PipelineConfig"
) -> Iterator["GraphRecord"]:
    if cfg.num_workers <= 0:
        for s in samples:
            yield build_graph_record(s, vocab, cfg)
        return
    frozen = _FrozenVocab(vocab)
    with ProcessPoolExecutor(
        max_workers=cfg.num_workers, mp_context=multiprocessing.get_context("spawn"),
        initializer=_init_worker, initargs=(frozen, cfg),
    ) as pool:
        yield from pool.map(_build_graph_worker, samples, chunksize=16)


@dataclasses.dataclass
class PipelineResult:
    out_dir: pathlib.Path
    counts: dict[str, dict[str, int]]
    num_entities: int
    num_relations: int
    num_text_entities: int
    # Seconds of the encoder passes (entities, relations, questions) and of
    # pass 3+4 without the question encodes; the texts encoded.
    phase_s: dict[str, float] = dataclasses.field(default_factory=dict)
    num_texts: dict[str, int] = dataclasses.field(default_factory=dict)


TABLE_FILES = ("graphs.parquet", "questions.parquet", "entity_vocab.parquet", "relation_vocab.parquet")


def build_from_samples(
    cfg: PipelineConfig,
    encoder: TextEncoder,
    raw_samples: Iterable[RawSample],
) -> tuple[PipelineResult, dict[str, list[dict[str, Any]]]]:
    """Passes 1-4 over ``raw_samples``: writes the embeddings, the split
    stores and the filter JSON files under ``cfg.out_dir``; returns the
    result and the four normalized tables (``TABLE_FILES`` -> rows)."""
    out = pathlib.Path(cfg.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    vocab = Vocab(cfg.text_policy)
    phase_s = {"encode_s": 0.0, "graph_s": 0.0}

    # Pass 1: vocab.
    counts: dict[str, dict[str, int]] = {
        "total": {}, "kept": {}, "sub": {}, "nonzero": {}, "filtered": {},
    }
    questions: dict[str, list[RawSample]] = {}
    for s in raw_samples:
        counts["total"][s.split] = counts["total"].get(s.split, 0) + 1
        if not s.graph:
            continue
        if not should_keep_sample(s, cfg.split_filter(s.split), path_mode=cfg.path_mode):
            counts["filtered"][s.split] = counts["filtered"].get(s.split, 0) + 1
            continue
        for h, r, t in s.graph:
            vocab.add_entity(h)
            vocab.add_entity(t)
            vocab.add_relation(r)
        for e in s.q_entity + s.a_entity:
            vocab.add_entity(e)
        questions.setdefault(s.split, []).append(s)
    vocab.finalize()

    # Pass 2: embeddings.
    t0 = time.perf_counter()
    emb_dir = out / "embeddings"
    encode_to_memmap(
        encoder, vocab.text_entities, emb_dir / "entity_embeddings.npy",
        batch_size=cfg.encode_batch_size, reserve_row0=True,
    )
    rel_names = [r["label"] for r in vocab.relation_records()]
    encode_to_memmap(
        encoder, rel_names, emb_dir / "relation_embeddings.npy",
        batch_size=cfg.encode_batch_size, reserve_row0=False,
    )
    phase_s["encode_s"] += time.perf_counter() - t0

    # Pass 3+4: graph build + per-split store materialization.
    sub_ids: list[str] = []
    nonzero_ids: list[str] = []
    graph_rows: list[dict[str, Any]] = []
    question_rows: list[dict[str, Any]] = []
    num_questions = 0
    for split, samples in sorted(questions.items()):
        writer = SampleStoreWriter(out / "materialized" / split)
        q_texts = [s.question for s in samples]
        t0 = time.perf_counter()
        q_emb = encoder.encode(q_texts, batch_size=cfg.encode_batch_size)
        phase_s["encode_s"] += time.perf_counter() - t0
        num_questions += len(q_texts)
        t0 = time.perf_counter()
        for qi, (s, g) in enumerate(zip(samples, _iter_graph_records(samples, vocab, cfg))):
            counts["kept"][split] = counts["kept"].get(split, 0) + 1
            if cfg.emit_sub_filter and _sub_filter_keep(g):
                sub_ids.append(g.graph_id)
                counts["sub"][split] = counts["sub"].get(split, 0) + 1
            if cfg.emit_nonzero_positive_filter and g.positive_triple_mask.any():
                if (
                    cfg.nonzero_positive_filter_splits is None
                    or split in cfg.nonzero_positive_filter_splits
                ):
                    nonzero_ids.append(g.graph_id)
                    counts["nonzero"][split] = counts["nonzero"].get(split, 0) + 1
            graph_rows.append(
                {
                    "graph_id": g.graph_id,
                    "split": split,
                    "num_nodes": len(g.node_labels),
                    "num_edges": int(g.edge_src.size),
                    "num_positive": int(g.positive_triple_mask.sum()),
                }
            )
            question_rows.append(
                {
                    "graph_id": g.graph_id,
                    "split": split,
                    "question": s.question,
                    "q_entity": s.q_entity,
                    "a_entity": s.a_entity,
                    "answer_texts": s.answer_texts,
                    "graph_iso_type": s.graph_iso_type,
                    "redundant": s.redundant,
                    "test_type": s.test_type,
                }
            )
            writer.add(
                g.graph_id,
                {
                    "num_nodes": len(g.node_labels),
                    "edge_src": g.edge_src.astype(np.int32),
                    "edge_dst": g.edge_dst.astype(np.int32),
                    "edge_relation_ids": g.edge_relation_ids.astype(np.int32),
                    "positive_triple_mask": g.positive_triple_mask.astype(np.uint8),
                    "node_entity_ids": g.node_entity_ids.astype(np.int64),
                    "node_embedding_ids": g.node_embedding_ids.astype(np.int64),
                    "q_local": g.q_local.astype(np.int32),
                    "a_local": g.a_local.astype(np.int32),
                    "pair_start": g.pair_start.astype(np.int32),
                    "pair_answer": g.pair_answer.astype(np.int32),
                    "pair_edge_ids": g.pair_edge_ids.astype(np.int32),
                    "pair_edge_counts": g.pair_edge_counts.astype(np.int32),
                    "pair_shortest": g.pair_shortest.astype(np.int32),
                    "question_emb": q_emb[qi].astype(np.float32),
                    "question": s.question,
                    "answer_texts": json.dumps(s.answer_texts),
                    "seed_entity_ids": np.asarray(
                        [vocab.entity_to_id[e] for e in s.q_entity if e in vocab.entity_to_id],
                        np.int64,
                    ),
                    "answer_entity_ids": np.asarray(
                        [vocab.entity_to_id[e] for e in s.a_entity if e in vocab.entity_to_id],
                        np.int64,
                    ),
                },
            )
        writer.finalize(artifact="g_retrieval", extra={"dataset": cfg.dataset, "split": split})
        phase_s["graph_s"] += time.perf_counter() - t0

    if cfg.emit_sub_filter:
        (out / "sub_filter.json").write_text(
            json.dumps({"dataset": cfg.dataset, "sample_ids": sorted(sub_ids)}, indent=2)
        )
    if cfg.emit_nonzero_positive_filter:
        (out / "nonzero_positive_filter.json").write_text(
            json.dumps(
                {
                    "dataset": cfg.dataset,
                    "splits": sorted(cfg.nonzero_positive_filter_splits or VALID_SPLITS),
                    "sample_ids": sorted(nonzero_ids),
                },
                indent=2,
            )
        )
    tables = dict(zip(TABLE_FILES, (graph_rows, question_rows, vocab.entity_records(),
                                    vocab.relation_records())))
    result = PipelineResult(
        out_dir=out,
        counts=counts,
        num_entities=len(vocab.entity_to_id),
        num_relations=len(vocab.relation_to_id),
        num_text_entities=len(vocab.text_entities),
        phase_s=phase_s,
        num_texts={"entities": len(vocab.text_entities), "relations": len(rel_names), "questions": num_questions},
    )
    return result, tables


def write_tables(out_dir: str | pathlib.Path, tables: dict[str, list[dict[str, Any]]]) -> None:
    """The normalized tables of ``build_from_samples`` as parquet files
    (needs ``pyarrow``)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    for name in TABLE_FILES:
        pq.write_table(pa.Table.from_pylist(tables[name]), pathlib.Path(out_dir) / name)


def build_pipeline(
    cfg: PipelineConfig,
    encoder: TextEncoder,
    *,
    column_map: dict[str, str] | None = None,
) -> PipelineResult:
    """Raw parquet shards under ``cfg.raw_root`` -> the normalized dataset
    under ``cfg.out_dir`` (needs ``pyarrow``)."""
    import pyarrow  # noqa: F401  (fail before any pass when it is absent)

    res, tables = build_from_samples(cfg, encoder, read_raw_parquet(
        cfg.raw_root, cfg.dataset, column_map=column_map, entity_normalization=cfg.entity_normalization))
    write_tables(res.out_dir, tables)
    return res


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
