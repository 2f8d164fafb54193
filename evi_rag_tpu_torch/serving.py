"""Split-serving engine: trained retriever -> pre-projected tables -> batched
per-question top-k, on one CUDA device or data-parallel over a mesh.

Counterpart of ``evi_rag_tpu/serving.py``.  The entity / relation tables are
pushed through the frozen projectors once per checkpoint and stay on the
device; per question only the question-conditioned geometry + MLP head run,
over struct features (topic-anchored DDE) rebuilt on the device from the
subgraph's topology.

``serve_split`` is a pipeline of five steps.  **plan** (``plan_windows``):
sort by edge count, group ``group_size`` questions at a time, bucket each
group by its power-of-two width m_pad (``bucket_width``; n_pad = m_pad),
and cut the groups into windows at ``WINDOW_BYTES`` of staged feed; then
give each bucket its route once (``route_buckets``).  **pack**
(``pack_group_compact``): one group's feed.  **dispatch** (``_dispatch``): a
window's groups of one bucket, stacked and uploaded once per field from
pinned memory, scored group by group by ``serve_window``.  **stage**
(``_stage``): start the copy of the window's results to the host.
**drain** (``_drain``): wait and unpack, one window behind, so that the
next window packs and dispatches meanwhile.

The routes: bf16 buckets with ``m_pad >= fused_threshold`` take the
hand-written kernel (``ops.score_kernels.per_question_topk``); smaller
buckets and every f32 request take the plain PyTorch scorer
(``ops.query``).  A model or k outside the kernel's shape limits
(``kernel_limit``: emb_dim 96, hidden 2048, S = 36, k = 1500, ...) takes the
plain bf16 scorer, and the call logs one line naming the limit.

With a ``mesh`` (``parallel.mesh``), each group's question axis splits
across the mesh's devices (the group size rounds up to a multiple of the
mesh size, partial groups pad with empty questions), every device serves
its share through the same engine with the tables replicated there, and the
results come back to the first device.  Unlike the JAX engine, which keeps
the XLA scorer under a mesh because a ``pallas_call`` does not partition
itself, bf16 buckets from ``fused_threshold`` up take the kernel on every
device.

Nothing is padded to a compiled width (the JAX engine's chunk ladder), and
feeds and results travel unpacked.  Under bf16 compute the scores come back
rounded to bf16 (and widened to f32), as the JAX engine returns them; f32
requests return exact f32 scores.

Tracing (``utils/profiling.py``; on exactly while a ``torch.profiler``
session records, and free of cost but one check per span while off): each
``serve_split`` call is one call id; its spans are ``serve.setup`` (entry to
replicas ready), ``serve.warmup``, ``serve.plan`` (sort, groups, windows,
routes), per window ``serve.pack``, ``serve.stage`` and ``serve.drain``, per
window and bucket ``serve.dispatch`` (the warm-up's too), and ``serve.wait``
around each host wait on the card (the set-up's and warm-up's syncs, the
drain's event).  Counters, per route (``kernel`` for kernel 3, ``plain`` for
the plain scorer): ``serve.edges.<route>`` (real edges) and
``serve.slots.<route>`` (group size x m_pad as dispatched), whose ratio is
the share of dispatched slots that hold an edge.  ``profiling.trace(dir)``
writes them to ``dir/spans.json``.  ``ServeStats`` keeps its own timers.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Iterable, NamedTuple, Sequence

import numpy as np
import torch

from evi_rag_tpu_torch.data.sample import RetrievalSample
from evi_rag_tpu_torch.models.dde import build_node_struct_features
from evi_rag_tpu_torch.ops.nnfn import projector as _projector, tree_to
from evi_rag_tpu_torch.ops.query import query_topk_per_question
from evi_rag_tpu_torch.ops.score_kernels import kernel_limit, per_question_topk, prep_weights
from evi_rag_tpu_torch.parallel.mesh import Mesh, per_device
from evi_rag_tpu_torch.utils import profiling
from evi_rag_tpu_torch.utils.device import resolve_device
from evi_rag_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        with profiling.span("serve.wait"):
            torch.cuda.synchronize(device)


@torch.inference_mode()
def project_tables(
    bundle: dict[str, Any],
    entity_emb: np.ndarray,     # [V, D] raw text embeddings (row 0 = non-text)
    relation_emb: np.ndarray,   # [R, D]
    *,
    chunk: int = 65536,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the frozen projectors to the full vocab once (index build).

    Returns float32 tables on ``device``; row 0 of the entity table is
    replaced by the projected learned non-text entity row.
    """
    dev = resolve_device(device)
    feats = tree_to(bundle["features"], dev)
    parts = []
    for i in range(0, entity_emb.shape[0], chunk):
        rows = torch.from_numpy(np.array(entity_emb[i : i + chunk], dtype=np.float32)).to(dev)
        parts.append(_projector(feats["entity_proj"], rows))
    ent = torch.cat(parts)
    ent[0] = _projector(feats["entity_proj"], feats["non_text_entity_emb"][None, :])[0]
    rel = _projector(
        feats["relation_proj"], torch.from_numpy(np.array(relation_emb, dtype=np.float32)).to(dev)
    )
    return ent, rel


def edge_struct_features(
    topic: torch.Tensor,       # [G, N, C] topic one-hot per graph
    edge_index: torch.Tensor,  # [G, 2, M] local node ids (padding -> node N-1)
    edge_mask: torch.Tensor,   # [G, M] bool
    *,
    num_rounds: int,
    num_reverse_rounds: int,
) -> torch.Tensor:
    """[G, M, 2F] edge struct features ``concat(ns[head], ns[tail])`` for G
    graphs at once: the graphs' node axes are laid end to end, so one DDE
    pass over the flat edge list equals a per-graph pass."""
    g_n, n, c = topic.shape
    off = torch.arange(g_n, device=edge_index.device)[:, None, None] * n
    flat_ei = (edge_index.long() + off).transpose(0, 1).reshape(2, -1)
    ns = build_node_struct_features(
        topic.reshape(g_n * n, c), flat_ei,
        num_rounds=num_rounds, num_reverse_rounds=num_reverse_rounds,
        edge_mask=edge_mask.reshape(-1),
    ).reshape(g_n, n, -1)
    ei = edge_index.long()
    heads = torch.take_along_dim(ns, ei[:, 0, :, None], dim=1)
    tails = torch.take_along_dim(ns, ei[:, 1, :, None], dim=1)
    return torch.cat([heads, tails], dim=-1)


@torch.inference_mode()
def serve_window(
    bundle: dict[str, Any],
    q_table: torch.Tensor,        # [Q, D] question embeddings on the device
    ent_table: torch.Tensor,      # [V, D]
    rel_table: torch.Tensor,      # [R, D]
    edge_index: torch.Tensor,     # [B, G, 2, M] local node ids
    node_rows: torch.Tensor,      # [B, G, N] entity-table rows per node
    rel_ids: torch.Tensor,        # [B, G, M] relation rows
    lengths: torch.Tensor,        # [B, G] int32 valid edge counts (prefix mask)
    topic_flags: torch.Tensor,    # [B, G, N] uint8 (1 = topic/seed node)
    node_counts: torch.Tensor,    # [B, G] int32 valid node counts
    qids: torch.Tensor,           # [B, G] rows into q_table
    *,
    k: int,
    num_rounds: int,
    num_reverse_rounds: int,
    dtype: torch.dtype = torch.bfloat16,
    use_fused: bool = False,
    weights: dict[str, torch.Tensor] | None = None,
    fused_fn: Callable[..., tuple[torch.Tensor, torch.Tensor]] = per_question_topk,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Serve B groups of one bucket shape: per group, gather the candidate
    rows from the device tables, rebuild the DDE struct features, score and
    keep the top-k.  Returns ([B, G, k] scores, [B, G, k] int32 ids)."""
    m = edge_index.shape[-1]
    n = node_rows.shape[-1]
    dev = edge_index.device
    pos_m = torch.arange(m, device=dev)
    pos_n = torch.arange(n, device=dev)
    vals, ids = [], []
    for b in range(edge_index.shape[0]):
        eidx = edge_index[b].long()
        lens = lengths[b]
        emask = pos_m[None, :] < lens[:, None]
        nrows = node_rows[b].long()
        hr = torch.take_along_dim(nrows, eidx[:, 0, :], dim=1)
        tr = torch.take_along_dim(nrows, eidx[:, 1, :], dim=1)
        ri = rel_ids[b].long()
        nvalid = pos_n[None, :] < node_counts[b][:, None]
        tflags = topic_flags[b]
        topic = torch.stack([tflags.float(), (nvalid & (tflags == 0)).float()], dim=-1)
        struct_raw = edge_struct_features(
            topic, eidx, emask, num_rounds=num_rounds, num_reverse_rounds=num_reverse_rounds
        )
        q = q_table[qids[b].long()]
        if use_fused:
            bf16 = torch.bfloat16
            v, i = fused_fn(
                bundle, q, ent_table[hr].to(bf16), rel_table[ri].to(bf16),
                ent_table[tr].to(bf16), struct_raw.to(bf16), lens, k=k, weights=weights,
            )
        else:
            v, i = query_topk_per_question(
                bundle, q, ent_table[hr], rel_table[ri], ent_table[tr], struct_raw, emask,
                k=k, dtype=dtype,
            )
        vals.append(v)
        ids.append(i)
    return torch.stack(vals), torch.stack(ids)


@dataclasses.dataclass
class ServeResult:
    sample_id: str
    question_id: int
    edge_ids: np.ndarray    # [k'] local candidate edge ids, rank order
    scores: np.ndarray      # [k'] f32; bf16-rounded values under bf16 compute


@dataclasses.dataclass
class ServeStats:
    num_questions: int
    index_build_s: float
    scoring_s: float
    queries_per_s: float
    num_groups: int
    # Phase breakdown: host packing, dispatch loop (H2D enqueue,
    # asynchronous kernel launches, the results' copy start) and drain
    # (waiting for the device and unpacking the [G, k] results); device
    # compute overlaps all three.
    pack_s: float = 0.0
    dispatch_s: float = 0.0
    drain_s: float = 0.0
    # Warmup wall before the timed loop: the kernel build plus one empty
    # dispatch.  queries_per_s measures the steady state after it.
    compile_s: float = 0.0
    num_windows: int = 0


def _pow2_at_least(n: int, lo: int = 8) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def bucket_width(group: Sequence[RetrievalSample], k: int) -> int:
    """The padded edge width m_pad of one group's bucket: the power of two
    that holds each question's edges, ``k``, and its nodes plus the padding
    node (n_pad rides the same ladder)."""
    m_pad = _pow2_at_least(max(max(s.edge_index.shape[1], 1) for s in group))
    m_pad = max(m_pad, _pow2_at_least(k))
    return max(m_pad, _pow2_at_least(max(s.num_nodes for s in group) + 1))


# Staged-feed bytes a window may hold (the estimate of ``plan_windows``).
WINDOW_BYTES = 256 << 20


class _Group(NamedTuple):
    idxs: list[int]                    # the questions' positions in the call's samples
    samples: list[RetrievalSample]
    m_pad: int                         # its bucket: padded edges, and padded nodes (n_pad = m_pad)


def plan_windows(samples: Sequence[RetrievalSample], k: int, group_size: int) -> list[list[_Group]]:
    """Sort by edge count, cut groups of ``group_size``, bucket each by
    ``bucket_width``, then cut the groups into windows greedily: a window
    closes before the group that would take its staged-feed estimate past
    ``WINDOW_BYTES`` or its questions past ``group_size * max(8, 8192 //
    group_size)``."""
    order = sorted(range(len(samples)), key=lambda i: samples[i].edge_index.shape[1])
    max_questions = group_size * max(8, 8192 // max(group_size, 1))
    windows: list[list[_Group]] = []
    cur: list[_Group] = []
    cur_bytes = 0
    for g0 in range(0, len(order), group_size):
        idxs = order[g0 : g0 + group_size]
        group = [samples[i] for i in idxs]
        m_pad = bucket_width(group, k)
        nbytes = group_size * (
            3 * m_pad * 4            # eidx [2, m_pad] + rel_ids, int32
            + m_pad * 4 + m_pad      # node_rows (int32) + topic (uint8), n_pad = m_pad
        )
        if cur and (cur_bytes + nbytes > WINDOW_BYTES or (len(cur) + 1) * group_size > max_questions):
            windows.append(cur)
            cur, cur_bytes = [], 0
        cur.append(_Group(idxs, group, m_pad))
        cur_bytes += nbytes
    if cur:
        windows.append(cur)
    return windows


def route_buckets(m_pads: Iterable[int], *, bf16: bool, fused_threshold: int, fault: str | None) -> dict[int, str]:
    """Each bucket's scorer, ``"kernel"`` or ``"plain"``, by the module
    docstring's rule; ``fault`` is ``kernel_limit``'s message or None."""
    m_pads = sorted(set(m_pads))
    wanted = [m for m in m_pads if bf16 and m >= fused_threshold]
    if wanted and fault is not None:
        log.warning("serve: bf16 buckets from m_pad %d take the plain bf16 scorer, not the kernel (%s)",
                    wanted[0], fault)
        wanted = []
    return {m: "kernel" if m in wanted else "plain" for m in m_pads}


def pack_group_compact(group: Sequence[RetrievalSample], G: int, m_pad: int) -> dict[str, np.ndarray]:
    """Feed for one group of at most ``G`` questions in bucket ``m_pad`` (n_pad
    = m_pad): local ids, per-node table rows (expanded to per-edge rows on
    the device), prefix lengths, topic flags, node counts, question rows."""
    n_pad = m_pad
    eidx = np.full((G, 2, m_pad), n_pad - 1, np.int32)
    node_rows = np.zeros((G, n_pad), np.int32)
    rel_ids = np.zeros((G, m_pad), np.int32)
    lengths = np.zeros(G, np.int32)
    topic = np.zeros((G, n_pad), np.uint8)
    ncnt = np.zeros(G, np.int32)
    qids = np.zeros(G, np.int32)
    for g, s in enumerate(group):
        e = s.edge_index.shape[1]
        eidx[g, :, :e] = s.edge_index
        node_rows[g, : s.num_nodes] = s.node_embedding_ids
        rel_ids[g, :e] = s.edge_relations
        lengths[g] = e
        topic[g, s.topic_locals] = 1
        ncnt[g] = s.num_nodes
        qids[g] = s.question_id
    return dict(eidx=eidx, node_rows=node_rows, rel_ids=rel_ids,
                lengths=lengths, topic=topic, ncnt=ncnt, qids=qids)


def _replica(d: torch.device, *, bundle: dict[str, Any], projected: tuple[Any, Any], question_emb: np.ndarray,
             kernel_path: bool) -> dict[str, Any]:
    """The tables, question embeddings and weights on device ``d``; the
    tables under each route's name (the kernel's in bf16)."""
    f = tree_to(bundle["features"], d)
    ent_t, rel_t = (torch.as_tensor(x, dtype=torch.float32).to(d) for x in projected)
    out = dict(bundle={**bundle, "features": f}, plain=(ent_t, rel_t),
               q=torch.as_tensor(np.asarray(question_emb, dtype=np.float32)).to(d),
               weights=prep_weights(f) if kernel_path else None,
               kernel=(ent_t.to(torch.bfloat16), rel_t.to(torch.bfloat16)) if kernel_path else None)
    _sync(d)
    return out


def _upload(x: np.ndarray, d: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if d.type == "cuda":
        return t.pin_memory().to(d, non_blocking=True)
    return t


@profiling.spanned("serve.dispatch")
def _dispatch(feeds: list[dict[str, np.ndarray]], route: str, *, replicas: list[dict[str, Any]],
              devices: Sequence[torch.device], score: Callable[..., tuple[torch.Tensor, torch.Tensor]],
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``score`` (``serve_window``) over one window's groups of one bucket:
    one stacked feed, one upload per field and device, each group's
    questions split over ``devices``; the [B, G, k] results on the first
    device.  No padding: ``serve_window`` serves the groups one after
    another."""
    feed = {f: np.stack([a[f] for a in feeds]) for f in feeds[0]}
    per = feed["qids"].shape[1] // len(devices)
    vals, ids = [], []
    for j, (d, rep) in enumerate(zip(devices, replicas)):
        u = {f: _upload(x[:, j * per:(j + 1) * per], d) for f, x in feed.items()}
        ent, rel = rep[route]
        v, i = score(
            rep["bundle"], rep["q"], ent, rel,
            u["eidx"], u["node_rows"], u["rel_ids"], u["lengths"], u["topic"], u["ncnt"], u["qids"],
            use_fused=route == "kernel", weights=rep["weights"],
        )
        vals.append(v.to(devices[0]))
        ids.append(i.to(devices[0]))
    if len(devices) == 1:
        return vals[0], ids[0]
    return torch.cat(vals, dim=1), torch.cat(ids, dim=1)


@profiling.spanned("serve.stage")
def _stage(pend: list[tuple[list[_Group], torch.Tensor, torch.Tensor]], *, round_bf16: bool,
           dev: torch.device) -> tuple[list[_Group], torch.Tensor, torch.Tensor, torch.cuda.Event | None]:
    """Concatenate a window's results and start their copy to the host.
    Under bf16 compute the scores ship rounded to bf16, as the JAX engine
    ships them (the top-k order was decided on the f32 scores before).
    Returns the groups in row order (``group_size`` rows each), the host
    scores and ids, and the event recorded after the copies (None off
    CUDA)."""
    vals = torch.cat([v.reshape(-1, v.shape[-1]) for _, v, _ in pend])
    if round_bf16:
        vals = vals.to(torch.bfloat16)
    ids = torch.cat([i.reshape(-1, i.shape[-1]) for _, _, i in pend])
    groups = [g for gs, _, _ in pend for g in gs]
    if dev.type != "cuda":
        return groups, vals, ids, None
    vals_h = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
    ids_h = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
    vals_h.copy_(vals, non_blocking=True)
    ids_h.copy_(ids, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return groups, vals_h, ids_h, done


@profiling.spanned("serve.drain")
def _drain(staged: tuple, group_size: int, results: list[ServeResult | None]) -> float:
    """Wait for a staged window and put each question's ranking into
    ``results`` at its position (the slots past its edges, -inf, dropped).
    Returns the seconds it took."""
    t0 = time.perf_counter()
    groups, vals_h, ids_h, done = staged
    if done is not None:
        with profiling.span("serve.wait"):
            done.synchronize()
    all_v = vals_h.float().numpy()
    all_i = ids_h.numpy()
    for gi, grp in enumerate(groups):
        for j, (i, s) in enumerate(zip(grp.idxs, grp.samples)):
            row = gi * group_size + j
            keep = np.isfinite(all_v[row])
            results[i] = ServeResult(
                sample_id=s.sample_id,
                question_id=s.question_id,
                edge_ids=all_i[row][keep],
                scores=all_v[row][keep].astype(np.float32),
            )
    return time.perf_counter() - t0


@torch.inference_mode()
@profiling.one_call
def serve_split(
    bundle: dict[str, Any],
    samples: Sequence[RetrievalSample],
    *,
    entity_emb: np.ndarray,
    relation_emb: np.ndarray,
    question_emb: np.ndarray,
    k: int,
    num_rounds: int,
    num_reverse_rounds: int,
    group_size: int = 16,
    dtype: torch.dtype = torch.bfloat16,
    projected: tuple[Any, Any] | None = None,
    mesh=None,
    fused_threshold: int = 256,
    warmup: bool | None = None,
    device: str | torch.device | None = None,
    fused_fn: Callable[..., tuple[torch.Tensor, torch.Tensor]] = per_question_topk,
) -> tuple[list[ServeResult], ServeStats]:
    """Serve every question of a split through the engine.

    Samples are sorted by edge count and grouped ``group_size`` at a time
    into pow-2 padded buckets; results come back in the original order.
    ``projected`` reuses ``project_tables`` output across splits.
    ``fused_fn`` serves the kernel-routed buckets (``per_question_topk``;
    ``chip_smoke.py`` passes the plain version to compare end to end).
    Runs on ``device`` (cuda unless ``"cpu"`` is asked for), or, with
    ``mesh``, data-parallel over its devices with the results on the first.
    """
    with profiling.span("serve.setup"):
        if mesh is None:
            mesh = Mesh((resolve_device(device),))
        devices = mesh.devices
        group_size = -(-group_size // len(devices)) * len(devices)
        dev = devices[0]
        t0 = time.perf_counter()
        feats = tree_to(bundle["features"], dev)
        bundle = {**bundle, "features": feats}
        if projected is None:
            projected = project_tables(bundle, entity_emb, relation_emb, device=dev)
        bf16 = dtype == torch.bfloat16
        # The kernel's shape limits hold per model and k, so one check serves
        # every bucket of the call.
        fault = kernel_limit(feats["q_gate"]["kernel"].shape[0], feats["state_net_0"]["kernel"].shape[-1],
                             feats["struct_proj"]["kernel"].shape[0], k)
        replicas = per_device(mesh, functools.partial(
            _replica, bundle=bundle, projected=projected, question_emb=question_emb, kernel_path=bf16))
        index_build_s = time.perf_counter() - t0

    with profiling.span("serve.plan"):
        windows = plan_windows(samples, k, group_size)
        routes = route_buckets((g.m_pad for win in windows for g in win), bf16=bf16,
                               fused_threshold=fused_threshold, fault=fault)
    score = functools.partial(serve_window, k=k, num_rounds=num_rounds, num_reverse_rounds=num_reverse_rounds,
                              dtype=dtype, fused_fn=fused_fn)
    dispatch = functools.partial(_dispatch, replicas=replicas, devices=devices, score=score)

    # Warm-up before the clock: one dispatch of an empty feed, at the
    # smallest kernel-routed shape if there is one.  It builds and loads the
    # kernel and the glue's libraries; nothing is compiled per shape, and its
    # one kernel launch scores no edge.
    compile_s = 0.0
    if (dev.type == "cuda" if warmup is None else warmup) and windows:
        with profiling.span("serve.warmup"):
            tw = time.perf_counter()
            m_pad = min((m for m, r in routes.items() if r == "kernel"), default=min(routes))
            dispatch([pack_group_compact([], group_size, m_pad)], routes[m_pad])
            for d in set(devices):
                _sync(d)
            compile_s = time.perf_counter() - tw

    # One-window lookahead: window w+1 packs and dispatches before window w's
    # results are waited for, so host packing overlaps device compute.
    t1 = time.perf_counter()
    results: list[ServeResult | None] = [None] * len(samples)
    pack_s = dispatch_s = drain_s = 0.0
    prev = None
    for win in windows:
        tp = time.perf_counter()
        with profiling.span("serve.pack"):
            buckets: dict[int, tuple[list[_Group], list[dict]]] = {}
            for grp in win:
                groups, feeds = buckets.setdefault(grp.m_pad, ([], []))
                groups.append(grp)
                feeds.append(pack_group_compact(grp.samples, group_size, grp.m_pad))
        td = time.perf_counter()
        pack_s += td - tp
        pend = []
        for m_pad, (groups, feeds) in buckets.items():
            if profiling.enabled():
                profiling.count(f"serve.edges.{routes[m_pad]}", sum(int(a["lengths"].sum()) for a in feeds))
                profiling.count(f"serve.slots.{routes[m_pad]}", len(groups) * group_size * m_pad)
            pend.append((groups, *dispatch(feeds, routes[m_pad])))
        staged = _stage(pend, round_bf16=bf16, dev=dev)
        dispatch_s += time.perf_counter() - td
        if prev is not None:
            drain_s += _drain(prev, group_size, results)
        prev = staged
    if prev is not None:
        drain_s += _drain(prev, group_size, results)

    scoring_s = time.perf_counter() - t1
    out = [r for r in results if r is not None]
    stats = ServeStats(
        num_questions=len(out),
        index_build_s=round(index_build_s, 4),
        scoring_s=round(scoring_s, 4),
        queries_per_s=round(len(out) / scoring_s, 2) if scoring_s > 0 else 0.0,
        num_groups=sum(len(win) for win in windows),
        pack_s=round(pack_s, 4),
        dispatch_s=round(dispatch_s, 4),
        drain_s=round(drain_s, 4),
        compile_s=round(compile_s, 4),
        num_windows=len(windows),
    )
    return out, stats


def serve_recall_at_k(
    samples: Sequence[RetrievalSample],
    results: Iterable[ServeResult],
    k_values: Sequence[int],
    *,
    require_positive: bool = False,
) -> dict[str, float]:
    """Triple recall@k of the served rankings against ``edge_labels``.

    Zero-positive questions count as recall 0 in the denominator; zero-edge
    questions are skipped from it entirely (the reference protocol, so
    serve/recall@k stays comparable to eval_retriever's edge/recall@k).
    ``require_positive=True`` drops zero-positive questions instead.
    """
    by_id = {s.sample_id: s for s in samples}
    totals = {k: 0.0 for k in k_values}
    counted = 0
    for r in results:
        s = by_id[r.sample_id]
        if s.edge_index.shape[1] == 0:
            continue  # edgeless: not in the reference denominator
        pos = np.nonzero(np.asarray(s.edge_labels) > 0.5)[0]
        if pos.size == 0:
            if not require_positive:
                counted += 1  # recall 0 for every k, reference protocol
            continue
        counted += 1
        for k in k_values:
            hit = np.intersect1d(r.edge_ids[:k], pos).size
            totals[k] += hit / pos.size
    if counted == 0:
        return {f"serve/recall@{k}": 0.0 for k in k_values}
    return {f"serve/recall@{k}": round(totals[k] / counted, 6) for k in k_values}
