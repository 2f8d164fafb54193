"""Copy of ``evi_rag_tpu/data/chains.py`` (pure Python and numpy).

Candidate evidence chains: BFS baseline + GFlowNet rollout aggregation.

Re-design of two reference components:

* ``build_bfs_candidate_chains`` (``src/data/components/bfs_chain_builder.py:
  49-293``): non-learned baseline -- breadth-first expansion of score-ranked
  oriented chains from start nodes over the agent graph, dedup by the
  (src_entity, relation, dst_entity) signature with frequency counting and
  best-score retention, ranked by (frequency desc, length desc, score desc).
* rollout->chain aggregation (``src/callbacks/
  gflownet_rollout_artifact_writer.py:193-288``, the working duplicate of the
  reference's broken ``_build_candidate_chains_from_rollouts`` --
  ``reasoner_path_dataset.py:250`` has an IndentationError at reference
  HEAD): each sampled rollout yields one oriented chain (selection order +
  per-step direction); chains aggregate across rollouts by signature.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Mapping, Sequence

import numpy as np

DIRECTION_FORWARD = 0
DIRECTION_BACKWARD = 1


@dataclasses.dataclass(frozen=True)
class OrientedEdge:
    edge_id: int
    src_local: int
    dst_local: int
    head_local: int
    tail_local: int
    relation_id: int
    score: float
    direction: int


@dataclasses.dataclass(frozen=True)
class ChainSettings:
    max_chain_length: int = 3
    min_chain_length: int = 1
    max_chains_per_sample: int = 100
    max_total_chains: int = 5000
    allow_backward: bool = True
    max_branch_per_node: int | None = None
    forbid_edge_revisit: bool = True
    forbid_node_revisit: bool = False

    def __post_init__(self) -> None:
        if self.max_chain_length <= 0:
            raise ValueError("max_chain_length must be positive")


def _oriented_adjacency(
    *,
    num_nodes: int,
    heads: Sequence[int],
    tails: Sequence[int],
    relations: Sequence[int],
    scores: Sequence[float],
    allow_backward: bool,
    max_branch_per_node: int | None,
) -> list[list[OrientedEdge]]:
    adj: list[list[OrientedEdge]] = [[] for _ in range(num_nodes)]
    for eid, (h, t, r, s) in enumerate(zip(heads, tails, relations, scores)):
        h, t = int(h), int(t)
        adj[h].append(OrientedEdge(eid, h, t, h, t, int(r), float(s), DIRECTION_FORWARD))
        if allow_backward:
            adj[t].append(OrientedEdge(eid, t, h, h, t, int(r), float(s), DIRECTION_BACKWARD))
    for lst in adj:
        lst.sort(key=lambda e: (-e.score, e.edge_id, e.direction))
        # Negative branch limits are ignored, exactly as the reference does
        # (``bfs_chain_builder.py:188-191``: ``if keep >= 0: del edges[keep:]``).
        if max_branch_per_node is not None and max_branch_per_node >= 0:
            del lst[max_branch_per_node:]
    return adj


def _edge_dict(e: OrientedEdge, ids: Sequence[int]) -> dict[str, Any]:
    return {
        "edge_id": e.edge_id,
        "head_entity_id": int(ids[e.head_local]),
        "tail_entity_id": int(ids[e.tail_local]),
        "relation_id": e.relation_id,
        "src_entity_id": int(ids[e.src_local]),
        "dst_entity_id": int(ids[e.dst_local]),
        "src_node_local": e.src_local,
        "dst_node_local": e.dst_local,
        "direction": e.direction,
    }


def _aggregate_chains(
    chains: list[tuple[list[OrientedEdge], float]],
    *,
    node_entity_ids: Sequence[int],
) -> list[dict[str, Any]]:
    """Dedup by entity-level signature; rank (freq, length, score) desc."""
    stats: dict[tuple, dict[str, Any]] = {}
    for edges, score in chains:
        sig = tuple(
            (int(node_entity_ids[e.src_local]), e.relation_id, int(node_entity_ids[e.dst_local]))
            for e in edges
        )
        if not sig:
            continue
        st = stats.get(sig)
        if st is None:
            stats[sig] = {"frequency": 1, "score": float(score), "edges": edges}
        else:
            st["frequency"] += 1
            if score > st["score"]:
                st["score"] = float(score)
                st["edges"] = edges
    out = []
    for sig, st in stats.items():
        edges = st["edges"]
        out.append(
            {
                "signature": sig,
                "length": len(edges),
                "frequency": st["frequency"],
                "score": st["score"],
                "edge_local_ids": [e.edge_id for e in edges],
                "chain_edges": [_edge_dict(e, node_entity_ids) for e in edges],
            }
        )
    out.sort(key=lambda c: (-c["frequency"], -c["length"], -c["score"]))
    return out


def build_bfs_candidate_chains(
    *,
    num_nodes: int,
    heads: Sequence[int],
    tails: Sequence[int],
    relations: Sequence[int],
    scores: Sequence[float],
    node_entity_ids: Sequence[int],
    start_nodes: Sequence[int],
    settings: ChainSettings,
) -> list[dict[str, Any]]:
    adj = _oriented_adjacency(
        num_nodes=num_nodes, heads=heads, tails=tails, relations=relations,
        scores=scores, allow_backward=settings.allow_backward,
        max_branch_per_node=settings.max_branch_per_node,
    )
    queue: deque[tuple[list[OrientedEdge], int, float, frozenset, frozenset]] = deque()
    for s in start_nodes:
        s = int(s)
        if not 0 <= s < num_nodes:
            continue
        for e in adj[s]:
            queue.append((
                [e], e.dst_local, e.score,
                frozenset({e.edge_id}) if settings.forbid_edge_revisit else frozenset(),
                frozenset({s, e.dst_local}) if settings.forbid_node_revisit else frozenset(),
            ))
    raw: list[tuple[list[OrientedEdge], float]] = []
    while queue:
        edges, last, score, used, visited = queue.popleft()
        if len(edges) >= settings.min_chain_length:
            raw.append((edges, score))
            if 0 < settings.max_total_chains <= len(raw):
                break
        if len(edges) >= settings.max_chain_length:
            continue
        for e in adj[last]:
            if settings.forbid_edge_revisit and e.edge_id in used:
                continue
            if settings.forbid_node_revisit and e.dst_local in visited:
                continue
            queue.append((
                [*edges, e], e.dst_local, score + e.score,
                used | {e.edge_id} if settings.forbid_edge_revisit else used,
                visited | {e.dst_local} if settings.forbid_node_revisit else visited,
            ))
    cands = _aggregate_chains(raw, node_entity_ids=node_entity_ids)
    cands = cands[: max(settings.max_chains_per_sample, 0)]
    for rank, c in enumerate(cands, 1):
        c["rank"] = rank
    return cands


def chains_from_rollouts(
    *,
    actions_seqs: np.ndarray,    # [R, T] local edge ids within the sample (-1 = STOP)
    directions_seqs: np.ndarray,  # [R, T]
    heads: Sequence[int],
    tails: Sequence[int],
    relations: Sequence[int],
    scores: Sequence[float],
    node_entity_ids: Sequence[int],
    max_chains: int = 100,
) -> list[dict[str, Any]]:
    """Aggregate sampled GFlowNet rollouts into ranked candidate chains."""
    raw: list[tuple[list[OrientedEdge], float]] = []
    for r in range(actions_seqs.shape[0]):
        edges: list[OrientedEdge] = []
        total = 0.0
        for t in range(actions_seqs.shape[1]):
            a = int(actions_seqs[r, t])
            if a < 0:
                break
            h, tl = int(heads[a]), int(tails[a])
            d = int(directions_seqs[r, t])
            src, dst = (h, tl) if d == DIRECTION_FORWARD else (tl, h)
            edges.append(OrientedEdge(a, src, dst, h, tl, int(relations[a]), float(scores[a]), d))
            total += float(scores[a])
        if edges:
            raw.append((edges, total))
    cands = _aggregate_chains(raw, node_entity_ids=node_entity_ids)
    cands = cands[:max_chains]
    for rank, c in enumerate(cands, 1):
        c["rank"] = rank
    return cands


def textualize_chain(
    chain: Mapping[str, Any],
    *,
    id2entity: Mapping[int, str],
    id2relation: Mapping[int, str],
) -> str:
    """Render a chain as "A --[rel]--> B --[rel]--> C" for prompts."""
    parts: list[str] = []
    for i, e in enumerate(chain["chain_edges"]):
        src = id2entity.get(int(e["src_entity_id"]), str(e["src_entity_id"]))
        dst = id2entity.get(int(e["dst_entity_id"]), str(e["dst_entity_id"]))
        rel = id2relation.get(int(e["relation_id"]), str(e["relation_id"]))
        arrow = f"--[{rel}]-->" if e["direction"] == DIRECTION_FORWARD else f"<--[{rel}]--"
        if i == 0:
            parts.append(src)
        parts.append(arrow)
        parts.append(dst)
    return " ".join(parts)
