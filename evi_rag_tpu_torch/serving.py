"""Split-serving engine: trained retriever -> pre-projected tables -> batched
per-question top-k, on one CUDA device or data-parallel over a mesh.

Counterpart of ``evi_rag_tpu/serving.py``.  The entity / relation tables are
pushed through the frozen projectors once per checkpoint and stay on the
device; per question only the question-conditioned geometry + MLP head run,
over struct features (topic-anchored DDE) rebuilt on the device from the
subgraph's topology.

Questions are sorted by edge count and grouped ``group_size`` at a time into
power-of-two buckets (``n_pad = m_pad``); groups are cut into windows by an
estimate of their staged bytes, and each window's buckets are dispatched in
chunks by the ``_chunk_plan`` ladder.  bf16 buckets with ``m_pad >=
fused_threshold`` go through the hand-written kernel
(``ops.score_kernels.per_question_topk``); smaller buckets and every f32
request go through the plain PyTorch scorer (``ops.query``).  An f32 request
never reaches the bf16 kernel.  Nor does a model or k outside the kernel's
shape limits (``ops.score_kernels.kernel_supports``: emb_dim 96, hidden
2048, S = 36, k = 1500, ...): its buckets take the plain bf16 scorer, as
buckets under the threshold do, and the call logs one line naming the limit.

With a ``mesh`` (``parallel.mesh``), each group's question axis splits
across the mesh's devices (the group size rounds up to a multiple of the
mesh size, partial groups pad with empty questions), every device serves
its share through the same engine with the tables replicated there, and the
results come back to the first device.  Unlike the JAX engine, which keeps
the XLA scorer under a mesh because a ``pallas_call`` does not partition
itself, bf16 buckets from ``fused_threshold`` up take the kernel on every
device.

What the JAX engine did only for a remote TPU link is gone: int16 feeds,
bf16-in-int32 result packing, padding chunks to a fixed compiled shape.
Feeds go up from pinned host memory with ``non_blocking`` copies; each
window's results come back the same way while the next window is dispatched.
Under bf16 compute the scores come back rounded to bf16 (and widened to
f32), as the JAX engine returns them; f32 requests return exact f32 scores.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from evi_rag_tpu_torch.data.sample import RetrievalSample
from evi_rag_tpu_torch.models.dde import build_node_struct_features
from evi_rag_tpu_torch.ops.nnfn import projector as _projector, tree_to
from evi_rag_tpu_torch.ops.query import query_topk_per_question
from evi_rag_tpu_torch.ops.score_kernels import kernel_limit, per_question_topk, prep_weights
from evi_rag_tpu_torch.parallel.mesh import Mesh, per_device
from evi_rag_tpu_torch.utils.device import resolve_device
from evi_rag_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
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
    # Phase breakdown: host packing, dispatch loop (pack + H2D enqueue +
    # asynchronous kernel launches) and drain (waiting for the device and
    # the [G, k] results).  pack_s is a subset of dispatch_s; device compute
    # overlaps both.
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


@torch.inference_mode()
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
    if mesh is None:
        mesh = Mesh((resolve_device(device),))
    devices = mesh.devices
    group_size = -(-group_size // len(devices)) * len(devices)
    dev = devices[0]
    on_cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    feats = tree_to(bundle["features"], dev)
    bundle = {**bundle, "features": feats}
    if projected is None:
        projected = project_tables(bundle, entity_emb, relation_emb, device=dev)
    kernel_path = dtype == torch.bfloat16
    # The kernel's shape limits hold per model and k, so one check serves
    # every bucket of the call.
    fault = kernel_limit(feats["q_gate"]["kernel"].shape[0], feats["state_net_0"]["kernel"].shape[-1],
                         feats["struct_proj"]["kernel"].shape[0], k)
    routed_away = False

    def replica(d: torch.device) -> dict[str, Any]:
        """The tables, question embeddings and weights on device ``d``."""
        f = tree_to(feats, d)
        ent_t, rel_t = (torch.as_tensor(x, dtype=torch.float32).to(d) for x in projected)
        out = dict(bundle={**bundle, "features": f}, ent=ent_t, rel=rel_t,
                   q=torch.as_tensor(np.asarray(question_emb, dtype=np.float32)).to(d),
                   weights=prep_weights(f) if kernel_path else None,
                   ent_k=ent_t.to(torch.bfloat16) if kernel_path else None,
                   rel_k=rel_t.to(torch.bfloat16) if kernel_path else None)
        _sync(d)
        return out

    replicas = per_device(mesh, replica)
    index_build_s = time.perf_counter() - t0

    order = sorted(range(len(samples)), key=lambda i: samples[i].edge_index.shape[1])
    results: list[ServeResult | None] = [None] * len(samples)

    def drain(idxs, group, vals_np, ids_np) -> None:
        for g, (i, s) in enumerate(zip(idxs, group)):
            keep = np.isfinite(vals_np[g])
            results[i] = ServeResult(
                sample_id=s.sample_id,
                question_id=s.question_id,
                edge_ids=ids_np[g][keep],
                scores=vals_np[g][keep].astype(np.float32),
            )

    num_groups = 0
    pack_s = dispatch_s = drain_s = 0.0
    max_window_samples = group_size * max(8, 8192 // max(group_size, 1))
    byte_budget = int(os.environ.get("EVI_SERVE_WINDOW_BYTES", 256 << 20))

    def pack_group_compact(group, G, m_pad, n_pad):
        """Feed for one group: local ids, per-node table rows (expanded to
        per-edge rows on the device), prefix lengths, topic flags."""
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

    # Group boundaries + padded shapes first, then cut windows greedily where
    # the staged-feed estimate would exceed the byte budget.  One shape axis:
    # n_pad rides the edge ladder (n_pad = m_pad >= nodes + 1).
    group_recs = []
    for g0 in range(0, len(order), group_size):
        idxs = order[g0 : g0 + group_size]
        group = [samples[i] for i in idxs]
        m_pad = n_pad = bucket_width(group, k)
        bytes_est = group_size * (
            3 * m_pad * 4            # eidx [2, m_pad] + rel_ids, int32
            + n_pad * 4 + n_pad      # node_rows + topic
        )
        group_recs.append((idxs, group, (m_pad, n_pad), bytes_est))
    windows: list[list[tuple]] = []
    cur: list[tuple] = []
    cur_bytes = cur_samples = 0
    for rec in group_recs:
        if cur and (
            cur_bytes + rec[3] > byte_budget
            or cur_samples + group_size > max_window_samples
        ):
            windows.append(cur)
            cur, cur_bytes, cur_samples = [], 0, 0
        cur.append(rec)
        cur_bytes += rec[3]
        cur_samples += group_size
    if cur:
        windows.append(cur)

    # Dispatch-width ladder: full chunks of B_LARGE groups, then B_SMALL
    # chunks, then one final chunk of the remainder.
    B_SMALL = int(os.environ.get("EVI_SERVE_B_WINDOW", 8))
    B_LARGE = max(int(os.environ.get("EVI_SERVE_B_WINDOW_MAX", 64)), B_SMALL)

    def _chunk_plan(n: int) -> list[int]:
        plan = [B_LARGE] * (n // B_LARGE)
        rem = n - B_LARGE * len(plan)
        while rem >= B_SMALL:
            plan.append(B_SMALL)
            rem -= B_SMALL
        if rem:
            plan.append(_pow2_at_least(rem))
        return plan

    def _use_fused(m_pad: int) -> bool:
        # The kernel computes in bf16; an explicit float32 request keeps the
        # plain PyTorch scorer, and so does a shape the kernel does not take.
        nonlocal routed_away
        if m_pad < fused_threshold or dtype != torch.bfloat16:
            return False
        if fault is None:
            return True
        if not routed_away:
            routed_away = True
            log.warning("serve: bf16 buckets from m_pad %d take the plain bf16 scorer, not the kernel (%s)",
                        m_pad, fault)
        return False

    def _upload(x: np.ndarray, d: torch.device) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if d.type == "cuda":
            return t.pin_memory().to(d, non_blocking=True)
        return t

    def _dispatch(key: tuple, chunk: list[dict]) -> tuple[torch.Tensor, torch.Tensor]:
        """``serve_window`` for the chunk's groups (no padding: the groups
        are served one after another), each group's questions split over the
        devices; the [B, G, k] results on the first device."""
        feed = {f: np.stack([a[f] for a in chunk]) for f in chunk[0]}
        fused = _use_fused(key[0])
        per = group_size // len(devices)
        vals, ids = [], []
        for j, (d, rep) in enumerate(zip(devices, replicas)):
            u = {f: _upload(x[:, j * per:(j + 1) * per], d) for f, x in feed.items()}
            v, i = serve_window(
                rep["bundle"], rep["q"],
                rep["ent_k"] if fused else rep["ent"], rep["rel_k"] if fused else rep["rel"],
                u["eidx"], u["node_rows"], u["rel_ids"],
                u["lengths"], u["topic"], u["ncnt"], u["qids"],
                k=k, num_rounds=num_rounds, num_reverse_rounds=num_reverse_rounds,
                dtype=dtype, use_fused=fused, weights=rep["weights"], fused_fn=fused_fn,
            )
            vals.append(v.to(dev))
            ids.append(i.to(dev))
        if len(devices) == 1:
            return vals[0], ids[0]
        return torch.cat(vals, dim=1), torch.cat(ids, dim=1)

    # Warmup before the timed loop (on by default on the GPU): one dispatch
    # of an empty feed, at the smallest kernel-routed shape if there is one.
    # It builds and loads the kernel and the glue's libraries; nothing is
    # compiled per shape, and its one kernel launch scores no edge.
    do_warmup = on_cuda if warmup is None else warmup
    compile_s = 0.0
    if do_warmup and windows:
        tw = time.perf_counter()
        keys = sorted({key for win in windows for _, _, key, _ in win})
        key = next((kk for kk in keys if _use_fused(kk[0])), keys[0])
        _dispatch(key, [pack_group_compact([], group_size, *key)])
        for d in set(devices):
            _sync(d)
        compile_s = time.perf_counter() - tw
    t1 = time.perf_counter()

    def stage_window(pend):
        """Concatenate a window's results and start their copy to the host.
        Under bf16 compute the scores ship rounded to bf16, as the JAX engine
        ships them (the top-k order was decided on the f32 scores before)."""
        vals = torch.cat([v.reshape(-1, v.shape[-1]) for _, v, _ in pend])
        if dtype == torch.bfloat16:
            vals = vals.to(torch.bfloat16)
        ids = torch.cat([i.reshape(-1, i.shape[-1]) for _, _, i in pend])
        meta = [(m, v.shape[1]) for m, v, _ in pend]
        if not on_cuda:
            return meta, vals, ids, None
        vals_h = torch.empty(vals.shape, dtype=vals.dtype, pin_memory=True)
        ids_h = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        vals_h.copy_(vals, non_blocking=True)
        ids_h.copy_(ids, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return meta, vals_h, ids_h, done

    def drain_window(staged) -> None:
        nonlocal drain_s
        t2 = time.perf_counter()
        meta, vals_h, ids_h, done = staged
        if done is not None:
            done.synchronize()
        all_v = vals_h.float().numpy()
        all_i = ids_h.numpy()
        row = 0
        for meta_chunk, g_per in meta:
            for idxs, group in meta_chunk:
                drain(idxs, group, all_v[row : row + g_per], all_i[row : row + g_per])
                row += g_per
        drain_s += time.perf_counter() - t2

    # One-window lookahead: window w+1 packs and dispatches before window w's
    # results are waited for, so host packing overlaps device compute.
    prev = None
    for win_groups in windows:
        tp = time.perf_counter()
        packed: dict[tuple, list[dict]] = {}
        metas: dict[tuple, list[tuple]] = {}
        for idxs, group, key, _ in win_groups:
            packed.setdefault(key, []).append(pack_group_compact(group, group_size, *key))
            metas.setdefault(key, []).append((idxs, group))
        pack_s += time.perf_counter() - tp

        td = time.perf_counter()
        pend = []
        for key, lst in packed.items():
            c0 = 0
            for b_cap in _chunk_plan(len(lst)):
                chunk = lst[c0 : c0 + b_cap]
                vals, ids = _dispatch(key, chunk)
                pend.append((metas[key][c0 : c0 + b_cap], vals, ids))
                c0 += b_cap
            num_groups += len(metas[key])
        staged = stage_window(pend)
        dispatch_s += time.perf_counter() - td

        if prev is not None:
            drain_window(prev)
        prev = staged
    if prev is not None:
        drain_window(prev)

    scoring_s = time.perf_counter() - t1
    out = [r for r in results if r is not None]
    stats = ServeStats(
        num_questions=len(out),
        index_build_s=round(index_build_s, 4),
        scoring_s=round(scoring_s, 4),
        queries_per_s=round(len(out) / scoring_s, 2) if scoring_s > 0 else 0.0,
        num_groups=num_groups,
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
