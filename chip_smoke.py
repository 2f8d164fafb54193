#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and hold its kernel to its plain version.

Run from the root of a checkout, on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases, each printed as it runs:

1. device: the card's name and power limit (nvidia-smi) and the versions;
2. build: ``nvcc`` of every kernel source of the serving path, with its time
   and the compiler's register / spill report;
3. kernel vs plain version at full width (D = H = 1024, S = 20, G = 16,
   k = 100, M in {256, 1024, 2048, 4096}, random prefix lengths including one
   below k and one of 0): max score error, id agreement under the near-tie
   rule, and the kernel's, the plain version's and the bound's times;
   The same phase checks that the kernel's output on a fixed input is bit
   for bit what it was before its device code moved into
   ``csrc/twin_score.cuh`` (``PQT_DIGEST``);
4. ``serve_split`` end to end on the realistic synthetic split (128-1024
   nodes, ~3 extra edges per node, 16384 entities, 64 relations, seed 7,
   D = 1024, k = 100): launch counts, the top-k of every question held to
   the same split served through the plain version on the card (near-tie
   rule on the plain version's full rankings), recall@{10,100} of both, q/s
   and the phase breakdown, bf16-representable scores, and a second timed
   pass that gives bitwise the same ids and scores; a traced serve pass
   (torch.profiler) gives the device time by kernel and the busy share of
   that pass;
5. the ``serve`` CLI task on a small synthetic config with a checkpoint in
   the port's format written here (under ``chiprun_out/``);
6. the pooled query at ``bench.py``'s headline (131,072 candidates, 128
   queries, D = H = 1024, S = 20, k = 100): ``build_triple_index`` on the
   card from a 262,144-row entity table and a 1,024-row relation table,
   then the bf16 index through ``query_topk_per_query`` (kernel 1) and
   ``query_topk_fused`` (kernel 2), q/s as the median of 3 warm passes;
   8 queries held to each kernel's plain version's full score rows; each
   kernel's ms per launch, bound and plain version's ms.

Then a line ``{"kernels": [...]}``, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero without
that last line; so does a machine without CUDA or a directory without the
rest of the repository.  Weights and data are random, made from seeds.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
D = H = 1024
S = 2 * 2 * (1 + 2 + 2)    # DDE 2+2 rounds, two topic channels, head + tail
K = 100
G = 16
SHAPES_M = (256, 1024, 2048, 4096)
QUESTIONS = 256
REPORT_M = 2048            # realistic serve buckets: median ~1.2k edges -> m_pad 2048
# Kernel vs plain version: both use bf16 operands with f32 sums and round at
# the same points; f32 sums run in other orders, which can flip a bf16
# rounding of an A-operand element now and then.  Scores are O(1).
ATOL = 5e-3
TIE_TOL = 5e-3             # ids may swap only where the plain scores are this close
MAX_SWAPPED = 8            # questions of the serve whose top-k may differ by such swaps
FULL_RANK = 4096           # >= the largest bucket of the realistic split (max 3182 edges)
POOLED_M = 131072          # bench.py's headline pooled query
POOLED_B = 128
POOLED_CHECK = 8           # queries held to the plain versions' full score rows
ENTITIES, RELATIONS = 262144, 1024


def log(msg: str) -> None:
    print(msg, flush=True)


def make_bundle(dim: int, hidden: int, struct_dim: int, seed: int = 0):
    """Random retriever feature bundle with the production geometry."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {
            "kernel": (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32),
            "bias": np.zeros(o, np.float32),
        }

    def ln(d):
        return {"scale": np.ones(d, np.float32), "bias": np.zeros(d, np.float32)}

    feats = {
        "entity_proj": {"proj": dense(dim, dim)},
        "relation_proj": {"proj": dense(dim, dim)},
        "query_proj": {"proj": dense(dim, dim)},
        "non_text_entity_emb": np.zeros(dim, np.float32),
        "q_gate": dense(dim, dim),
        "q_bias": dense(dim, dim),
        "struct_proj": dense(struct_dim, dim),
        "struct_norm": ln(dim),
        "struct_gate": dense(dim, 1),
        "state_net_0": dense(3 * dim + 1, hidden),
        "state_norm": ln(hidden),
        "state_net_1": dense(hidden, hidden),
        "score_head": dense(hidden, 1),
    }
    parity = {"use_topic_pe": 1, "num_topics": 2, "dde_rounds": 2, "dde_reverse_rounds": 2}
    return {"features": feats, "parity_meta": parity}


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    import math

    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x != 0 else 0.0


def reset_launches() -> None:
    from evi_rag_tpu_torch.ops import score_kernels as sk

    for fn in (sk.per_question_topk, sk.score_bidirectional, sk.query_topk_fused):
        fn.launches = 0


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(bytes_: float, tc_flops: float, f32_flops: float) -> tuple[float, str]:
    """(least ms, what bounds it): bytes at the memory rate against
    operations at the peak rate of their type."""
    t_bytes = bytes_ / PEAK_BYTES
    t_ops = max(tc_flops / PEAK_BF16_FLOPS, f32_flops / PEAK_F32_FLOPS)
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")


def weight_bytes(d: int, h: int, s: int) -> int:
    return 3 * d * h * 2 + 6 * h * 4 + s * d * 4 + 5 * d * 4


def kernel_bound(lengths, m: int, d: int, h: int, s: int, k: int) -> tuple[float, str]:
    """Least time for the work of this input: each needed input byte read
    once (rows of valid edges, the weights, the questions), each output byte
    written once; operations at the peak rate of their type."""
    edges = int(sum(min(int(n), m) for n in lengths))
    g = len(lengths)
    bytes_ = (edges * (3 * d * 2 + s * 2)                       # h, r, t, struct rows (bf16)
              + weight_bytes(d, h, s)
              + g * (d * 4 + 4) + g * k * 8)                     # questions, lengths, vals + ids
    tc_flops = edges * 2 * 3 * 2 * d * h                        # [inter|sc|err] @ W1, two directions
    f32_flops = edges * 2 * (2 * s * d + 12 * d + 12 * h)       # struct proj, LNs, GELUs, products
    return roofline(bytes_, tc_flops, f32_flops)


def pooled_bounds(b: int, m: int, d: int, h: int, s: int, k: int) -> dict[str, tuple[float, str]]:
    """Least time of one launch of each pooled kernel over b queries and m
    shared candidates.  Inputs: the bf16 index rows once, the weights, the
    queries; outputs: kernel 1's [b, m] f32 scores, kernel 2's [b, k] values
    and ids.  Operations: what depends on the query once per (edge, query),
    what does not once per edge.  Kernel 1 per (edge, query): inter @ W1i
    and err @ W1e in two directions (8.4 MFLOP at D = H = 1024); per edge:
    the struct projection and sc @ W1s in two directions.  Kernel 2 per
    (edge, query): u @ W1i and r_ctx @ W1e; per edge: hmt @ W1e and
    [sc_f; sc_b] @ W1s.  Elementwise work is counted at ~12 operations per D
    or H element."""
    rows = m * (3 * d * 2 + s * 2) + weight_bytes(d, h, s) + b * d * 4
    pairs = b * m
    per_edge_f32 = m * 2 * (2 * s * d + 12 * d)                  # struct projection, LN, GELU, nav
    return {
        "score_bidirectional": roofline(
            rows + pairs * 4, pairs * 2 * 2 * 2 * d * h + m * 2 * 2 * d * h,
            per_edge_f32 + pairs * 2 * (12 * d + 12 * h)),
        "query_topk_fused": roofline(
            rows + b * k * 8, pairs * 2 * 2 * d * h + m * 3 * 2 * d * h,
            per_edge_f32 + pairs * (12 * d + 2 * 12 * h)),
    }


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {smi}")
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from evi_rag_tpu_torch.ops import _build, score_kernels

    t0 = time.perf_counter()
    _build.build(list(score_kernels.KERNEL_SOURCES))  # one nvcc per source, all at once
    for source in score_kernels.KERNEL_SOURCES:
        _build.load_library(source)
    build_s = time.perf_counter() - t0
    log(f"[2 build] {', '.join(score_kernels.KERNEL_SOURCES)} built and loaded in {build_s:.2f} s")
    for source in score_kernels.KERNEL_SOURCES:
        for ln in _build.BUILD_LOG.get(source, "").splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log(f"[2 build]   {source}: {ln.strip()}")
    return build_s


def phase_kernel(bundle_np, seed: int = 5):
    import numpy as np
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    dev = torch.device("cuda")
    bundle = {"features": bundle_from_numpy(bundle_np["features"], device=dev)}
    w = sk.prep_weights(bundle["features"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    rows = []
    for m in SHAPES_M:
        lens = rng.integers(K // 2, m + 1, size=G)
        lens[0], lens[1], lens[2] = m, 37, 0  # full, below k, empty
        lengths = torch.as_tensor(lens.astype(np.int32), device=dev)
        rand = lambda *shape: torch.tanh(torch.randn(*shape, device=dev, generator=gen))
        h, r, t = (rand(G, m, D).to(torch.bfloat16) for _ in range(3))
        struct = torch.rand(G, m, S, device=dev, generator=gen).to(torch.bfloat16)
        q = torch.randn(G, D, device=dev, generator=gen)
        args = (bundle, q, h, r, t, struct, lengths)
        vals, ids = sk.per_question_topk(*args, k=K, weights=w)
        torch.cuda.synchronize()
        scores = sk.per_question_scores_reference(*args, weights=w)
        rv, ri = sk.topk_desc(scores, K)
        vals_c, ids_c, scores_c = vals.cpu().numpy(), ids.cpu().numpy(), scores.cpu().numpy()
        rv_c, ri_c = rv.cpu().numpy(), ri.cpu().numpy()
        max_err, swaps = 0.0, 0
        for g in range(G):
            n = min(int(lens[g]), K)
            if not (np.isfinite(vals_c[g, :n]).all() and np.isneginf(vals_c[g, n:]).all()):
                raise AssertionError(f"M={m} g={g}: finite slots != min(len, k)")
            if n < K and not (ids_c[g, n:] == np.arange(lens[g], lens[g] + K - n)).all():
                raise AssertionError(f"M={m} g={g}: unfilled slots carry wrong ids")
            if n == 0:
                continue
            got_ids = ids_c[g, :n]
            if got_ids.min() < 0 or got_ids.max() >= lens[g] or len(set(got_ids.tolist())) != n:
                raise AssertionError(f"M={m} g={g}: ids out of range or repeated")
            max_err = max(max_err, float(np.abs(vals_c[g, :n] - scores_c[g, got_ids]).max()))
            if (np.diff(vals_c[g, :n]) > 0).any():
                raise AssertionError(f"M={m} g={g}: values not sorted descending")
            diff = set(got_ids.tolist()) ^ set(ri_c[g, :n].tolist())
            kth = rv_c[g, n - 1]
            far = [e for e in diff if abs(scores_c[g, e] - kth) > TIE_TOL]
            if far:
                raise AssertionError(f"M={m} g={g}: ids {far} differ beyond the near-tie rule")
            swaps += len(diff) // 2
        if max_err > ATOL:
            raise AssertionError(f"M={m}: max score error {max_err:.3e} > {ATOL}")
        iters = max(3, int(40 * 256 / m))
        ms = cuda_ms(lambda: sk.per_question_topk(*args, k=K, weights=w), iters)
        plain_ms = cuda_ms(lambda: sk.per_question_topk_reference(*args, k=K, weights=w), max(2, iters // 4))
        bound_ms, bound_by = kernel_bound(lens, m, D, H, S, K)
        row = dict(M=m, G=G, valid_edges=int(np.minimum(lens, m).sum()), max_abs_err=max_err,
                   near_tie_swaps=swaps, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        log(f"[3 kernel] G={G} M={m} valid_edges={row['valid_edges']} max_abs_err={max_err:.3e} "
            f"(tol {ATOL}) near_tie_swaps={swaps} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) bound/ms={bound_ms / ms:.3f}")
        del h, r, t, struct, scores
    from evi_rag_tpu_torch.testing import PQT_DIGEST, pqt_digest

    digest = pqt_digest(dev)
    if digest != PQT_DIGEST:
        raise AssertionError(f"per_question_topk output changed: digest {digest} != {PQT_DIGEST}")
    log(f"[3 kernel] output on the fixed input is bit for bit the pre-header kernel's (sha256 {digest[:16]}...)")
    return rows


def phase_serve(bundle_np, num_questions: int):
    import numpy as np
    import torch

    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.serving import project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(
        num_samples=num_questions, emb_dim=D, num_relations=64, seed=7,
        min_nodes=128, max_nodes=1024, avg_extra_edges=3.0, num_entities=16384,
    )
    edges = np.array([s.edge_index.shape[1] for s in ds.samples])
    log(f"[4 serve] split: {num_questions} questions, edges median {int(np.median(edges))} "
        f"max {edges.max()}, made in {time.perf_counter() - t0:.1f} s")
    bundle = {"features": bundle_from_numpy(bundle_np["features"], device="cuda")}
    projected = project_tables(bundle, ds.entity_emb, ds.relation_emb, device="cuda")
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb,
              k=K, num_rounds=2, num_reverse_rounds=2, projected=projected, device="cuda")
    serve_split(bundle, ds.samples, **kw)  # first pass: allocator and library warm
    reset_launches()
    results, stats = serve_split(bundle, ds.samples, **kw)
    launches = sk.per_question_topk.launches
    # Every bucket of this split has m_pad >= 256: one launch per group, and
    # one (empty) launch of the warmup.
    if launches != stats.num_groups + 1:
        raise AssertionError(f"serve_split launched the kernel {launches} times for {stats.num_groups} groups")
    if len(results) != num_questions or any(
        r.edge_ids.size != min(K, s.edge_index.shape[1])
        for r, s in zip(results, ds.samples)
    ):
        raise AssertionError("a question got no (or a short) answer")
    passes = [stats]
    again, stats2 = serve_split(bundle, ds.samples, **kw)
    passes.append(stats2)
    passes.append(serve_split(bundle, ds.samples, **kw)[1])
    qps = sorted(p.queries_per_s for p in passes)
    for a, b in zip(results, again):
        if not (np.array_equal(a.edge_ids, b.edge_ids) and np.array_equal(a.scores, b.scores)):
            raise AssertionError(f"{a.sample_id}: a second serve pass gave other ids or score bits")
    scores = np.concatenate([r.scores for r in results])
    if not np.array_equal(scores, torch.as_tensor(scores).to(torch.bfloat16).float().numpy()):
        raise AssertionError("served scores are not bf16 values under bf16 compute")
    log(f"[4 serve] a second timed pass gave bitwise the same ids and scores for all {len(results)} "
        f"questions; all {scores.size} served scores are bf16 values")
    log(f"[4 serve] kernel launches in one serve_split: {launches} "
        f"({stats.num_groups} groups + 1 warmup launch that scores no edge)")
    log(f"[4 serve] q/s per pass {qps} median {qps[1]}; stats {stats}")

    _, plain_stats = serve_split(bundle, ds.samples, fused_fn=sk.per_question_topk_reference, **kw)
    full, _ = serve_split(bundle, ds.samples, fused_fn=plain_full_ranking, **kw)
    plain, swapped, max_err = check_against_plain(ds.samples, results, full)
    rec_k = serve_recall_at_k(ds.samples, results, [10, 100])
    rec_p = serve_recall_at_k(ds.samples, plain, [10, 100])
    slack = swapped / num_questions  # a swap moves one question's recall by at most 1
    for key in rec_k:
        if abs(rec_k[key] - rec_p[key]) > slack:
            raise AssertionError(f"{key}: kernel {rec_k[key]} vs plain {rec_p[key]} (slack {slack})")
    log(f"[4 serve] vs plain-version serve: max score error {max_err:.3e} (tol {ATOL}); "
        f"questions with a near-tie swap {swapped}/{num_questions} (at most {MAX_SWAPPED}); "
        f"recall kernel {rec_k} plain {rec_p}; plain-version serve q/s {plain_stats.queries_per_s}")
    out = dict(launches=launches, group_launches=stats.num_groups, warmup_launches=launches - stats.num_groups,
               qps=qps, stats=stats.__dict__, recall=rec_k, recall_plain=rec_p, max_abs_err=max_err,
               swapped=swapped, plain_qps=plain_stats.queries_per_s,
               edges_median=int(np.median(edges)), edges_max=int(edges.max()))
    out["profile"] = profile_serve(bundle, ds, kw)
    return out


def plain_full_ranking(bundle, q_emb, head_repr, *args, k, weights):
    """The plain version, ranking every candidate instead of the top k
    (padded with -inf to ``FULL_RANK`` slots, so that every bucket shape
    returns the same width); ``serve_split`` then keeps each question's whole
    ranking with its scores."""
    import torch.nn.functional as F

    from evi_rag_tpu_torch.ops import score_kernels as sk

    m = head_repr.shape[1]
    if m > FULL_RANK:
        raise ValueError(f"bucket M={m} > FULL_RANK={FULL_RANK}")
    vals, ids = sk.per_question_topk_reference(bundle, q_emb, head_repr, *args, k=m, weights=weights)
    return (F.pad(vals, (0, FULL_RANK - m), value=float("-inf")),
            F.pad(ids, (0, FULL_RANK - m), value=-1))


def check_against_plain(samples, results, full):
    """Hold the kernel serve's top-k to the plain-version serve's full
    rankings: ids valid and distinct, scores within ATOL of the plain score
    of the same edge, and every id in one top-k but not the other within
    TIE_TOL of the plain k-th score.  Both serves round their scores to
    bf16, so each bound is at least one bf16 ulp of the plain score.  At
    most MAX_SWAPPED questions may differ.  Returns (the plain serve cut to its top k, swapped questions,
    max score error)."""
    by_id = {r.sample_id: r for r in full}
    edges = {s.sample_id: s.edge_index.shape[1] for s in samples}
    plain, swapped, max_err = [], 0, 0.0
    for r in results:
        f = by_id[r.sample_id]
        if f.edge_ids.size != edges[r.sample_id]:
            raise AssertionError(f"{r.sample_id}: plain ranking has {f.edge_ids.size} of "
                                 f"{edges[r.sample_id]} edges")
        n = r.edge_ids.size
        plain.append(dataclasses.replace(f, edge_ids=f.edge_ids[:n], scores=f.scores[:n]))
        if n == 0:
            continue
        score_of = dict(zip(f.edge_ids.tolist(), f.scores.tolist()))
        got = r.edge_ids.tolist()
        if len(set(got)) != n or any(e not in score_of for e in got):
            raise AssertionError(f"{r.sample_id}: ids out of range or repeated")
        for e, v in zip(got, r.scores.tolist()):
            err = abs(score_of[e] - v)
            if err > max(ATOL, bf16_ulp(score_of[e])):
                raise AssertionError(f"{r.sample_id}: score error {err:.3e} at {e} > max({ATOL}, 1 bf16 ulp)")
            max_err = max(max_err, err)
        kth = float(f.scores[n - 1])
        diff = set(got) ^ set(f.edge_ids[:n].tolist())
        far = [e for e in diff if abs(score_of[e] - kth) > max(TIE_TOL, bf16_ulp(kth))]
        if far:
            raise AssertionError(f"{r.sample_id}: ids {far} differ beyond the near-tie rule")
        swapped += bool(diff)
    if swapped > MAX_SWAPPED:
        raise AssertionError(f"{swapped} questions differ by near-tie swaps (at most {MAX_SWAPPED})")
    return plain, swapped, max_err


def profile_serve(bundle, ds, kw):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from evi_rag_tpu_torch.serving import serve_split

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        serve_split(bundle, ds.samples, **kw)  # profiler start-up off the clock
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serve_split(bundle, ds.samples, **kw)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.key and not ev.key.startswith("cuda"):
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda x: -x[1])
    kernels = [r for r in rows if not r[0].startswith("aten::")]
    busy = sum(r[1] for r in kernels)
    if not kernels:
        log("[4 profile] device time: not measured (profiler saw no device events)")
        return None
    log(f"[4 profile] wall {wall_ms:.1f} ms (profiled), device kernel time {busy:.1f} ms, "
        f"busy share {busy / wall_ms:.3f}")
    for name, ms, n in kernels[:12]:
        log(f"[4 profile]   {ms:9.3f} ms  x{n:5d}  {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=busy, top=kernels[:12])


def phase_cli():
    import numpy as np

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint

    work = OUT_DIR / "chip_smoke_cli"
    params = {"params": make_bundle(64, 64, S, seed=3)["features"]}
    save_checkpoint(work / "ckpt", params, meta={"parity_meta": {"dde_rounds": 2, "dde_reverse_rounds": 2}})
    before = sk.per_question_topk.launches
    rc = cli.main([
        "serve", "--configs-dir", str(ROOT / "configs"), f"retriever.ckpt={work / 'ckpt'}",
        "serve.splits=[validation]", "serve.k=20", "serve.k_values=[1, 10, 20]",
        "serve.fused_threshold=64", "dataset.num_samples=24", "dataset.max_nodes=48",
        f"paths.log_dir={work / 'logs'}",
    ])
    metrics_files = sorted((work / "logs").glob("**/metrics.json"))
    if rc != 0 or not metrics_files:
        raise AssertionError("serve CLI wrote no metrics.json")
    m = json.loads(metrics_files[-1].read_text())
    run = metrics_files[-1].parent
    for name in ("validation_serve.jsonl", "validation.manifest.json"):
        if not (run / name).exists():
            raise AssertionError(f"serve CLI wrote no {name}")
    if not (m["validation/num_questions"] == 24 and m["validation/queries_per_s"] > 0
            and 0.0 <= m["validation/serve/recall@20"] <= 1.0
            and np.isfinite(m["validation/serve/recall@10"])):
        raise AssertionError(f"serve CLI metrics look wrong: {m}")
    launches = sk.per_question_topk.launches - before
    if launches <= 0:
        raise AssertionError("serve CLI did not launch the kernel")
    log(f"[5 cli] serve task: recall@10 {m['validation/serve/recall@10']} recall@20 "
        f"{m['validation/serve/recall@20']} q/s {m['validation/queries_per_s']} "
        f"kernel launches {launches} (D = H = 64)")
    return m


def hold_to_plain(vals, ids, plain, k: int) -> tuple[float, int]:
    """Hold a kernel's top-k rows to its plain version's full score rows:
    ids distinct and in range, values within ATOL of the plain score of the
    same id, sorted, and every id in one top-k but not the other within
    TIE_TOL of the plain k-th score.  Returns (max abs error, differing ids)."""
    import numpy as np

    v, i, s = vals.cpu().numpy(), ids.cpu().numpy(), plain.cpu().numpy()
    max_err, differing = 0.0, 0
    for b in range(v.shape[0]):
        if len(set(i[b].tolist())) != k or i[b].min() < 0 or i[b].max() >= s.shape[1]:
            raise AssertionError(f"query {b}: ids out of range or repeated")
        if (np.diff(v[b]) > 0).any():
            raise AssertionError(f"query {b}: values not sorted descending")
        max_err = max(max_err, float(np.abs(v[b] - s[b, i[b]]).max()))
        want = np.argsort(-s[b], kind="stable")[:k]
        kth = s[b, want[-1]]
        diff = set(i[b].tolist()) ^ set(want.tolist())
        far = [e for e in diff if abs(s[b, e] - kth) > TIE_TOL]
        if far:
            raise AssertionError(f"query {b}: ids {far} differ beyond the near-tie rule")
        differing += len(diff) // 2
    if max_err > ATOL:
        raise AssertionError(f"max score error {max_err:.3e} > {ATOL}")
    return max_err, differing


def phase_pooled(bundle_np):
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.ops.query import build_triple_index
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = {"features": bundle_from_numpy(bundle_np["features"], device=dev)}
    gen = torch.Generator(device=dev).manual_seed(13)
    tables = dict(
        entity_emb=torch.randn(ENTITIES, D, device=dev, generator=gen),
        relation_emb=torch.randn(RELATIONS, D, device=dev, generator=gen),
        nontext_mask=torch.rand(ENTITIES, device=dev, generator=gen) < 0.01,
        heads=torch.randint(0, ENTITIES, (POOLED_M,), device=dev, generator=gen),
        rels=torch.randint(0, RELATIONS, (POOLED_M,), device=dev, generator=gen),
        tails=torch.randint(0, ENTITIES, (POOLED_M,), device=dev, generator=gen),
        struct_raw=torch.randn(POOLED_M, S, device=dev, generator=gen),
    )
    q = torch.randn(POOLED_B, D, device=dev, generator=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_triple_index(bundle, **tables, device=dev)
    torch.cuda.synchronize()
    index_build_s = time.perf_counter() - t0
    del tables
    idx = index.to(dtype=torch.bfloat16)  # cast once, as bench.py's index_dtype=bf16
    del index
    w = sk.prep_weights(bundle["features"])
    log(f"[6 pooled] index: {POOLED_M} triples over {ENTITIES} entities / {RELATIONS} relations, "
        f"D = {D}, built on the card in index_build_s {index_build_s:.4f}")

    # The main path: counts at 0, a first (warm) pass and 3 timed passes of each engine.
    paths = {"per_query": sk.query_topk_per_query, "fused": sk.query_topk_fused}
    reset_launches()
    out, qps = {}, {}
    for name, fn in paths.items():
        out[name] = fn(bundle, q, idx, k=K, weights=w)
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            out[name] = fn(bundle, q, idx, k=K, weights=w)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        qps[name] = sorted(POOLED_B / x for x in walls)
    launches = {"score_bidirectional": sk.score_bidirectional.launches,
                "query_topk_fused": sk.query_topk_fused.launches}
    if min(launches.values()) <= 0 or sk.per_question_topk.launches:
        raise AssertionError(f"the pooled paths' kernel launches are {launches}")
    for name in paths:
        log(f"[6 pooled] {name}: q/s per pass {[round(x, 2) for x in qps[name]]} median {qps[name][1]:.2f}")
    log(f"[6 pooled] launches in the driven run (1 + 3 passes per path): {launches}")

    # Checks: POOLED_CHECK queries against each kernel's plain version.
    nq = POOLED_CHECK
    rows_args = (idx.head_repr, idx.rel_repr, idx.tail_repr, idx.struct_raw)
    plain1 = sk.score_bidirectional_reference(bundle, q[:nq], *rows_args, weights=w)
    plain2 = sk.fused_scores_reference(bundle, q[:nq], *rows_args, weights=w)
    err1, diff1 = hold_to_plain(out["per_query"][0][:nq], out["per_query"][1][:nq], plain1, K)
    err2, diff2 = hold_to_plain(out["fused"][0][:nq], out["fused"][1][:nq], plain2, K)
    dense = sk.score_bidirectional(bundle, q[:nq], *rows_args, weights=w)
    dense_err = float((dense - plain1).abs().max())
    if dense_err > ATOL:
        raise AssertionError(f"kernel 1's dense scores: max error {dense_err:.3e} > {ATOL}")
    log(f"[6 pooled] {nq} queries vs plain full rows: kernel 1 top-k max_abs_err {err1:.3e} "
        f"(dense [{nq}, {POOLED_M}] {dense_err:.3e}), differing ids {diff1}; kernel 2 max_abs_err "
        f"{err2:.3e}, differing ids {diff2} (tol {ATOL}, near-tie {TIE_TOL})")
    del plain1, plain2, dense

    # Times of one launch over all POOLED_B queries, and of the plain versions' same work.
    ms = {"score_bidirectional": cuda_ms(lambda: sk.score_bidirectional(bundle, q, *rows_args, weights=w), 2),
          "query_topk_fused": cuda_ms(lambda: sk.query_topk_fused(bundle, q, idx, k=K, weights=w), 2)}
    plain_ms = {
        "score_bidirectional": cuda_ms(
            lambda: sk.score_bidirectional_reference(bundle, q, *rows_args, weights=w), 1),
        "query_topk_fused": cuda_ms(lambda: sk.query_topk_fused_reference(bundle, q, idx, k=K, weights=w), 1),
    }
    bounds = pooled_bounds(POOLED_B, POOLED_M, D, H, S, K)
    for name in ms:
        log(f"[6 pooled] {name}: ms {ms[name]:.3f} per launch (B = {POOLED_B}) bound_ms "
            f"{bounds[name][0]:.3f} ({bounds[name][1]}) bound/ms {bounds[name][0] / ms[name]:.3f} "
            f"plain_ms {plain_ms[name]:.3f}")
    return dict(index_build_s=index_build_s, qps=qps, launches=launches, ms=ms, plain_ms=plain_ms,
                bounds=bounds, max_abs_err={"score_bidirectional": max(err1, dense_err),
                                            "query_topk_fused": err2},
                differing_ids={"per_query": diff1, "fused": diff2})


def main() -> int:
    if not (ROOT / "evi_rag_tpu_torch" / "serving.py").is_file():
        print("chip_smoke: run from a checkout of the repository (evi_rag_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script only runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    OUT_DIR.mkdir(exist_ok=True)

    t_all = time.perf_counter()
    smi = phase_device()
    build_s = phase_build()
    bundle_np = make_bundle(D, H, S, seed=11)
    rows = phase_kernel(bundle_np)
    serve = phase_serve(bundle_np, QUESTIONS)
    cli_metrics = phase_cli()
    pooled = phase_pooled(bundle_np)

    rep = next(r for r in rows if r["M"] == REPORT_M)
    kernels = [{
        "name": "per_question_topk",
        "route": "cuda",
        "source": "evi_rag_tpu_torch/csrc/per_question_topk.cu",
        "replaces": "evi_rag_tpu/ops/pallas_score.py:507",
        "launches": serve["launches"],
        "group_launches": serve["group_launches"],
        "warmup_launches": serve["warmup_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": None,
        "shape": f"G={G} M={REPORT_M} D={D} H={H} S={S} k={K}",
    }]
    replaces = {"score_bidirectional": 104, "query_topk_fused": 290}
    sources = {"score_bidirectional": "score_bidirectional.cu", "query_topk_fused": "pooled_query.cu"}
    for name in ("score_bidirectional", "query_topk_fused"):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"evi_rag_tpu_torch/csrc/{sources[name]}",
            "replaces": f"evi_rag_tpu/ops/pallas_score.py:{replaces[name]}",
            "launches": pooled["launches"][name],
            "max_abs_err": pooled["max_abs_err"][name],
            "ms": pooled["ms"][name],
            "plain_ms": pooled["plain_ms"][name],
            "bound_ms": pooled["bounds"][name][0],
            "bound_by": pooled["bounds"][name][1],
            "library_ms": None,
            "shape": f"B={POOLED_B} M={POOLED_M} D={D} H={H} S={S} k={K}",
        })
    details = dict(nvidia_smi=smi, build_s=build_s, kernel=rows, serve=serve, cli=cli_metrics,
                   pooled=pooled, kernels=kernels, wall_s=time.perf_counter() - t_all)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=2, default=str))
    log(f"[done] wall {details['wall_s']:.1f} s; details in chiprun_out/chip_smoke.json")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
