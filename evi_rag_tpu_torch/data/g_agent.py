"""Copy of ``evi_rag_tpu/data/g_agent.py`` (numpy only, on the port's
``data/bfs_label.py``): the same stable sorts, so the same records.

Agent-graph (g_agent) materialization: retriever scores -> GFlowNet env.

Re-design of the reference ``GAgentBuilder`` (``src/data/components/
g_agent_builder.py:116-724``).  Per question subgraph:

1. calibrate scores (``score_mode``): raw logits or *node-softmax logits*
   -- per-endpoint softmax probabilities averaged over head/tail and mapped
   back through logit() (``:594-626``);
2. select the union of the global top-k edges (``:640-652``) and per-start-
   node degree-proportional edges (ceil(deg*ratio) clamped to
   [min, max], ``:654-724``);
3. optional hop filter (``apply_hop_filter``, default off): keep edges within
   ``max_hops`` undirected BFS radius of the start set.  The reference
   *declares* this behavior (``GAgentSettings.max_hops``, ``:41``) but its
   builder never applies it -- ``max_hops`` only flows into metadata and the
   BFS-chain length -- so parity artifacts require the filter off;
4. dedup by global (h, r, t) with max-score/max-label aggregation
   (``:338-364``), re-index nodes, resolve start/answer locals;
5. questions whose answers fall outside the selected subgraph become *dummy
   agents* when allowed (``:434-470``), else are dropped.

Additionally (capability the reference schema reserves but leaves empty):
``compute_pairs`` re-runs undirected-BFS pair supervision *on the agent
graph*, feeding the GFlowNet reward's shortest-length matching
(``gflownet_rewards.py:158-213``).

Everything is vectorized numpy on the host -- this is artifact
materialization, not the training hot path; the device-side analog of step 2
lives in the fused query kernel (``ops/query.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from evi_rag_tpu_torch.data.bfs_label import build_csr, bfs_dist, shortest_path_union_by_pair

SCORE_MODE_LOGITS = "logits"
SCORE_MODE_NODE_SOFTMAX = "node_softmax"
_PROB_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class AgentSettings:
    edge_top_k: int = 500
    max_hops: int = 3
    # The reference builder never applies the hop filter (max_hops is
    # metadata + BFS-chain length only); opt in explicitly to prune.
    apply_hop_filter: bool = False
    score_temperature: float = 1.0
    score_bias: float = 0.0
    start_keep_ratio: float = 0.25
    start_min_edges: int = 1
    # None defaults to edge_top_k, the reference's ``__post_init__`` rule
    # (``g_agent_builder.py:73-76``).
    start_max_edges: int | None = None
    score_mode: str = SCORE_MODE_NODE_SOFTMAX
    allow_empty_answer: bool = False
    compute_pairs: bool = True

    def __post_init__(self) -> None:
        if self.edge_top_k <= 0:
            raise ValueError("edge_top_k must be > 0")
        if self.max_hops < 0:
            raise ValueError("max_hops must be >= 0")
        if self.start_max_edges is None:
            object.__setattr__(self, "start_max_edges", int(self.edge_top_k))
        if self.score_temperature <= 0:
            raise ValueError("score_temperature must be positive")
        if not 0.0 <= self.start_keep_ratio <= 1.0:
            raise ValueError("start_keep_ratio must be in [0, 1]")
        if self.score_mode not in (SCORE_MODE_LOGITS, SCORE_MODE_NODE_SOFTMAX):
            raise ValueError(f"unknown score_mode {self.score_mode!r}")


@dataclasses.dataclass
class AgentSample:
    """One GFlowNet environment sample (reference ``GAgentSample``,
    ``src/data/g_agent_dataset.py:19-52``)."""

    sample_id: str
    question_id: int
    num_nodes: int
    edge_head_locals: np.ndarray
    edge_tail_locals: np.ndarray
    edge_relations: np.ndarray
    edge_scores: np.ndarray
    edge_labels: np.ndarray
    node_entity_ids: np.ndarray
    node_embedding_ids: np.ndarray
    start_entity_ids: np.ndarray
    answer_entity_ids: np.ndarray
    start_node_locals: np.ndarray
    answer_node_locals: np.ndarray
    pair_start_local: np.ndarray
    pair_answer_local: np.ndarray
    pair_shortest_len: np.ndarray
    is_answer_reachable: bool
    is_dummy_agent: bool

    @property
    def num_edges(self) -> int:
        return int(self.edge_relations.shape[0])

    def validate(self) -> None:
        """Strict record validation (the reference's ``_parse_sample``,
        ``g_agent_dataset.py:96-297``): shape agreement, index ranges,
        score finiteness, redundant-field cross-checks, and
        dummy/reachability consistency."""
        sid = self.sample_id
        e = self.num_edges
        for name in ("edge_head_locals", "edge_tail_locals", "edge_scores", "edge_labels"):
            if getattr(self, name).shape[0] != e:
                raise ValueError(f"{sid}: {name} length != num_edges")
        if e:
            lo = min(int(self.edge_head_locals.min()), int(self.edge_tail_locals.min()))
            hi = max(int(self.edge_head_locals.max()), int(self.edge_tail_locals.max()))
            if lo < 0 or hi >= self.num_nodes:
                raise ValueError(f"{sid}: edge endpoints out of node range")
        if not np.isfinite(self.edge_scores).all():
            raise ValueError(f"{sid}: non-finite edge_scores")
        for name in ("node_entity_ids", "node_embedding_ids"):
            if getattr(self, name).shape[0] != self.num_nodes:
                raise ValueError(f"{sid}: {name} length != num_nodes")
        for name in ("start_node_locals", "answer_node_locals",
                     "pair_start_local", "pair_answer_local"):
            arr = getattr(self, name)
            if arr.size and (arr.min() < 0 or arr.max() >= self.num_nodes):
                raise ValueError(f"{sid}: {name} out of range")
        # Redundant-field cross-checks: local anchors must name the same
        # entities the global id fields do.
        starts = set(self.node_entity_ids[self.start_node_locals].tolist())
        if not starts <= set(self.start_entity_ids.tolist()):
            raise ValueError(f"{sid}: start_node_locals disagree with start_entity_ids")
        answers_local = set(self.node_entity_ids[self.answer_node_locals].tolist())
        if not answers_local <= set(self.answer_entity_ids.tolist()):
            raise ValueError(f"{sid}: answer_node_locals disagree with answer_entity_ids")
        # Dummy/reachability consistency (reference checks these jointly).
        if self.start_node_locals.size == 0:
            raise ValueError(f"{sid}: start_node_locals must be non-empty")
        if self.is_dummy_agent and self.answer_node_locals.size:
            raise ValueError(f"{sid}: dummy agent with in-graph answers")
        if (not self.is_dummy_agent) and self.answer_node_locals.size == 0:
            raise ValueError(f"{sid}: non-dummy agent without answer locals")
        if self.is_answer_reachable == self.is_dummy_agent:
            raise ValueError(f"{sid}: reachability flag inconsistent with dummy flag")
        # Pair supervision may legitimately be EMPTY for a reachable agent:
        # the answer node can sit in the env graph yet be disconnected from
        # every start node after top-k edge selection (observed at WebQSP
        # scale), and the reference ships always-empty pair fields anyway
        # ("Path supervision removed", g_agent_builder.py:472-483) — the
        # reward falls back to a length-cost-free success when no pair
        # matches (reward.py:match_shortest_lengths -> -1).
        p = self.pair_start_local.shape[0]
        if self.pair_answer_local.shape[0] != p or self.pair_shortest_len.shape[0] != p:
            raise ValueError(f"{sid}: pair field length mismatch")


def node_softmax_logit(
    scores: np.ndarray, heads: np.ndarray, tails: np.ndarray, num_nodes: int
) -> np.ndarray:
    """logit(0.5 * (softmax_by_head + softmax_by_tail)) score calibration.

    Computed in float32 end-to-end like the reference's torch version
    (``g_agent_builder.py:596-629``): near-saturated probabilities round to
    1.0 in f32 and hit the logit clamp, so a float64 evaluation would emit
    different cached scores for the same inputs."""
    if scores.size == 0:
        return scores
    scores = scores.astype(np.float32)

    def endpoint_prob(idx: np.ndarray) -> np.ndarray:
        mx = np.full(num_nodes, -np.inf, dtype=np.float32)
        np.maximum.at(mx, idx, scores)
        ex = np.exp(scores - mx[idx])
        sm = np.zeros(num_nodes, dtype=np.float32)
        np.add.at(sm, idx, ex)
        return ex / np.maximum(sm[idx], np.float32(_PROB_EPS))

    prob = np.float32(0.5) * (
        endpoint_prob(heads.astype(np.int64)) + endpoint_prob(tails.astype(np.int64))
    )
    prob = np.clip(prob, np.float32(_PROB_EPS), np.float32(1.0) - np.float32(_PROB_EPS))
    return np.log(prob) - np.log1p(-prob)


def select_topk_edges(scores: np.ndarray, k: int) -> np.ndarray:
    if scores.size <= k:
        return np.arange(scores.size, dtype=np.int64)
    order = np.argsort(-scores, kind="stable")
    return np.sort(order[:k])


def select_start_edges(
    *,
    heads: np.ndarray,
    tails: np.ndarray,
    scores: np.ndarray,
    start_nodes: np.ndarray,
    num_nodes: int,
    keep_ratio: float,
    min_edges: int,
    max_edges: int | None,
) -> np.ndarray:
    """Per-start-node top-(ceil(deg*ratio)) incident edges, score-ranked."""
    start_nodes = np.unique(start_nodes)
    if start_nodes.size == 0 or scores.size == 0:
        return np.empty(0, dtype=np.int64)
    deg = np.bincount(heads, minlength=num_nodes) + np.bincount(tails, minlength=num_nodes)
    k_per = np.zeros(num_nodes, dtype=np.int64)
    k_s = np.ceil(deg[start_nodes] * keep_ratio).astype(np.int64)
    if min_edges > 0:
        k_s = np.maximum(k_s, min_edges)
    if max_edges is not None:
        k_s = np.minimum(k_s, max_edges)
    k_per[start_nodes] = np.minimum(k_s, deg[start_nodes])
    if k_per.max(initial=0) == 0:
        return np.empty(0, dtype=np.int64)

    edge_ids = np.arange(scores.size, dtype=np.int64)
    inc_nodes = np.concatenate([heads, tails]).astype(np.int64)
    inc_edges = np.concatenate([edge_ids, edge_ids])
    inc_scores = np.concatenate([scores, scores])
    is_start = np.zeros(num_nodes, dtype=bool)
    is_start[start_nodes] = True
    keep = is_start[inc_nodes]
    inc_nodes, inc_edges, inc_scores = inc_nodes[keep], inc_edges[keep], inc_scores[keep]
    # Score-order then stable node-group: position within group = per-node rank.
    o1 = np.argsort(-inc_scores, kind="stable")
    nodes1, edges1 = inc_nodes[o1], inc_edges[o1]
    o2 = np.argsort(nodes1, kind="stable")
    nodes2, edges2 = nodes1[o2], edges1[o2]
    counts = np.bincount(nodes2, minlength=num_nodes)
    offsets = np.cumsum(counts) - counts
    pos = np.arange(nodes2.size) - offsets[nodes2]
    sel = pos < k_per[nodes2]
    return np.unique(edges2[sel])


def _hop_filter(
    heads: np.ndarray, tails: np.ndarray, start_locals: np.ndarray, num_nodes: int, max_hops: int
) -> np.ndarray:
    """Edges whose nearer endpoint lies within max_hops-1 of the start set."""
    indptr, indices = build_csr(num_nodes, heads, tails, undirected=True)
    dist = bfs_dist(num_nodes, indptr, indices, start_locals)
    du, dv = dist[heads], dist[tails]
    near = np.where(
        (du >= 0) & (dv >= 0), np.minimum(du, dv), np.where(du >= 0, du, dv)
    )
    return (near >= 0) & (near < max_hops)


def build_agent_sample(
    *,
    sample_id: str,
    question_id: int,
    heads: np.ndarray,
    tails: np.ndarray,
    relations: np.ndarray,
    labels: np.ndarray,
    scores: np.ndarray,
    node_entity_ids: np.ndarray,
    node_embedding_ids: np.ndarray,
    start_entity_ids: np.ndarray,
    answer_entity_ids: np.ndarray,
    settings: AgentSettings,
) -> AgentSample | None:
    """Build one agent sample from a scored retrieval subgraph (or None)."""
    heads = np.asarray(heads, dtype=np.int64)
    tails = np.asarray(tails, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.float32)
    num_nodes = int(node_entity_ids.shape[0])
    if heads.size == 0:
        return None

    start_entity_ids = np.unique(np.asarray(start_entity_ids, dtype=np.int64))
    seen: dict[int, None] = {}
    answer_entity_ids = np.asarray(
        [a for a in np.asarray(answer_entity_ids, dtype=np.int64).tolist() if not (a in seen or seen.setdefault(a))],
        dtype=np.int64,
    )
    start_mask = np.isin(node_entity_ids, start_entity_ids)
    if not start_mask.any():
        return None
    start_locals_ret = np.nonzero(start_mask)[0]

    cal = node_softmax_logit(scores, heads, tails, num_nodes) if (
        settings.score_mode == SCORE_MODE_NODE_SOFTMAX
    ) else scores
    cal = cal / settings.score_temperature + settings.score_bias

    sel = select_topk_edges(cal, settings.edge_top_k)
    start_sel = select_start_edges(
        heads=heads, tails=tails, scores=cal, start_nodes=start_locals_ret,
        num_nodes=num_nodes, keep_ratio=settings.start_keep_ratio,
        min_edges=settings.start_min_edges, max_edges=settings.start_max_edges,
    )
    env_edges = np.union1d(sel, start_sel)
    if env_edges.size == 0:
        return None

    if settings.apply_hop_filter and settings.max_hops > 0:
        keep = _hop_filter(
            heads[env_edges], tails[env_edges], start_locals_ret, num_nodes, settings.max_hops
        )
        env_edges = env_edges[keep]
        if env_edges.size == 0:
            # Every selected edge lies beyond the radius: the sample has no
            # environment graph left — drop it rather than silently keeping
            # out-of-radius edges.
            return None

    # Dedup by global (h, r, t), max-aggregate score and label.
    hg = node_entity_ids[heads[env_edges]]
    tg = node_entity_ids[tails[env_edges]]
    rg = np.asarray(relations, dtype=np.int64)[env_edges]
    sc = scores[env_edges]
    lb = np.asarray(labels, dtype=np.float32)[env_edges]
    triples = np.stack([hg, rg, tg], axis=1)
    uniq, inv = np.unique(triples, axis=0, return_inverse=True)
    n_uniq = uniq.shape[0]
    agg_score = np.full(n_uniq, -np.inf, dtype=np.float32)
    np.maximum.at(agg_score, inv, sc)
    agg_label = np.zeros(n_uniq, dtype=np.float32)
    np.maximum.at(agg_label, inv, lb)

    # Re-index nodes over the unique triple endpoints.
    new_nodes = np.unique(np.concatenate([uniq[:, 0], uniq[:, 2]]))
    node_pos = {int(g): i for i, g in enumerate(new_nodes)}
    new_heads = np.asarray([node_pos[int(g)] for g in uniq[:, 0]], dtype=np.int64)
    new_tails = np.asarray([node_pos[int(g)] for g in uniq[:, 2]], dtype=np.int64)
    emb_lookup = {int(g): int(e) for g, e in zip(node_entity_ids, node_embedding_ids)}
    new_emb_ids = np.asarray([emb_lookup[int(g)] for g in new_nodes], dtype=np.int64)

    # Calibrated scores on the final agent graph.
    final_scores = (
        node_softmax_logit(agg_score, new_heads, new_tails, new_nodes.size)
        if settings.score_mode == SCORE_MODE_NODE_SOFTMAX
        else agg_score
    )

    start_node_locals = np.asarray(
        [node_pos[int(g)] for g in start_entity_ids if int(g) in node_pos], dtype=np.int64
    )
    if start_node_locals.size == 0:
        return None
    answer_node_locals = np.asarray(
        [node_pos[int(g)] for g in answer_entity_ids if int(g) in node_pos], dtype=np.int64
    )

    is_dummy = answer_node_locals.size == 0
    if is_dummy and not settings.allow_empty_answer:
        return None

    if settings.compute_pairs and not is_dummy:
        _, ps, pa, _, _, plen = shortest_path_union_by_pair(
            num_nodes=new_nodes.size,
            edge_src=new_heads,
            edge_dst=new_tails,
            sources=start_node_locals,
            targets=answer_node_locals,
        )
        pair_start = np.asarray(ps, dtype=np.int64)
        pair_answer = np.asarray(pa, dtype=np.int64)
        pair_len = np.asarray(plen, dtype=np.int64)
    else:
        pair_start = pair_answer = pair_len = np.empty(0, dtype=np.int64)

    return AgentSample(
        sample_id=sample_id,
        question_id=question_id,
        num_nodes=int(new_nodes.size),
        edge_head_locals=new_heads,
        edge_tail_locals=new_tails,
        edge_relations=uniq[:, 1].astype(np.int64),
        edge_scores=final_scores.astype(np.float32),
        edge_labels=np.zeros(n_uniq, np.float32) if is_dummy else agg_label,
        node_entity_ids=new_nodes,
        node_embedding_ids=new_emb_ids,
        start_entity_ids=start_entity_ids,
        answer_entity_ids=answer_entity_ids,
        start_node_locals=start_node_locals,
        answer_node_locals=answer_node_locals,
        pair_start_local=pair_start,
        pair_answer_local=pair_answer,
        pair_shortest_len=pair_len,
        is_answer_reachable=not is_dummy,
        is_dummy_agent=is_dummy,
    )
