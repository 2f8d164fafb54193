"""Headline benchmark of the port: retriever query throughput on one card.

Counterpart of the repository's root ``bench.py`` (the JAX package's own
measuring tool).  It runs the same sections in the same order, at the same
sizes and seeds and with the same timing protocol, through the port's
modules:

1. the headline: the pooled query over 131,072 candidate triples, 128
   queries, top-100, D = H = 1024, through ``query_topk_fused`` (kernel 2,
   ``csrc/pooled_query.cu``); then the batch-8 point on the same index;
2. the torch-CPU reference of the same scorer (``vs_baseline``);
3. the index build: 1,048,576 candidates gathered from a 262,144-entity
   table (``ops.query.build_triple_index``);
4. the 1M-candidate point: kernel 2 against the plain bf16 scorer
   (``ops.query.query_topk``) over a bf16 index;
5. kNN over 262,144 rows (``ops.knn.knn_topk``, exact and approx);
6. the retriever train step at production width;
7. six GFlowNet step variants and the G = 64 width points
   (``scripts/profile_gfn_step._build``);
8. the serve surface (``serving.serve_split``, kernel 3 on the buckets of
   m_pad >= 256) at 256 toy and 1,024 WebQSP-sized questions.

Run on the card::

    python -m evi_rag_tpu_torch.bench [--details PATH] [--device cpu]

The details go to ``artifacts/bench_torch_details.json`` (or ``--details``)
and the last line of stdout is ``{"metric", "value", "unit",
"vs_baseline", "device", "power_limit_w"}``.  ``EVI_BENCH_GFN_AB=0`` and
``EVI_BENCH_GFN_KNOBS=0`` skip the GFlowNet A/B and knob variants, as in
JAX.

Deliberate differences from ``bench.py`` (``tests/test_torch_bench.py``
bounds each):

* No fallback.  The headline is kernel 2 or the run fails; a section that
  raises is not retried or swallowed; there is no backend probe.  A failing
  section still writes the details of the sections that finished and prints
  the structured error line, and ``run_cli`` then returns 1.
* ``query_qps_1m_candidates_xla`` is ``query_qps_1m_candidates_plain`` and
  ``fused_vs_xla_1m`` is ``fused_vs_plain_1m``: there is no XLA here.
* Added keys: ``device`` and ``power_limit_w`` (the card's name and power
  limit; ``"cpu"`` and null off the card), ``launches`` (per section, the
  launches of each kernel wrapper and the passes that made them) and
  ``checks`` (kernel 2's top-k held to its plain version on the first
  ``CHECK_QUERIES`` queries of each kernel point, before it is timed; each
  serve point's cold pass held to the plain-version serve).
* No compile cache (a JAX setting).
* ``--device cpu`` is the only way to run off the card; with no card and no
  ``--device cpu`` the entry point raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import traceback
from typing import Any, Callable

import numpy as np
import torch

from evi_rag_tpu_torch.data.feeder import Bucket
from evi_rag_tpu_torch.ops import score_kernels as sk
from evi_rag_tpu_torch.utils.device import resolve_device

METRIC_NAME = "query_throughput_131k_candidates_top100_d1024"
METRIC_UNIT = "queries/sec/chip"
DETAILS_PATH = "artifacts/bench_torch_details.json"  # artifacts/ is git-ignored
H100_BF16_PEAK_TFLOPS = 989.0  # NVIDIA H100 SXM dense bf16 (data sheet)
CHECK_QUERIES = 8      # queries of each kernel point held to the plain version
CHECK_ATOL = 5e-3      # kernel vs plain score (scores are O(1); bf16 operands, f32 sums)
CHECK_TIE_TOL = 5e-3   # ids may differ only where the plain scores are this close to the k-th
CHECK_MAX_SWAPPED = 8  # questions of a serve whose top-k may differ from the plain one by such swaps
WRAPPERS = (sk.per_question_topk, sk.score_bidirectional, sk.query_topk_fused)


@dataclasses.dataclass(frozen=True)
class Sizes:
    """``bench.py``'s constants; the tests run the same sections smaller."""

    dim: int = 1024                     # D = H
    candidates: int = 131_072
    batch: int = 128
    batch_small: int = 8
    k: int = 100
    chunk: int = 4096                   # the plain scorer's candidate chunk
    cpu_reduced: int = 2048             # candidates the torch-CPU reference scores
    candidates_1m: int = 1_048_576
    build_vocab: int = 262_144
    build_rels: int = 1024
    build_m: int = 1_048_576
    knn_rows: int = 262_144
    knn_batch: int = 64
    train_samples: int = 32
    train_max_nodes: int = 64
    train_bucket: Bucket = Bucket(graphs=33, nodes=4096, edges=16384)
    gfn_graphs: int = 16
    gfn_graphs_wide: int = 64
    serve_questions: int = 256
    serve_questions_realistic: int = 1024


FULL = Sizes()
_GFN = "gflownet_step_graphs_per_sec"
_SERVE = ("qps_all_passes", "qps_best", "pack_s", "dispatch_s", "drain_s", "index_build_s", "drain_frac",
          "dispatch_frac")
# The measured keys of a full run, in the order ``main`` writes them (beside
# them: device, power_limit_w, launches, checks).
DETAIL_KEYS = (
    "engine", "query_throughput_qps", "headline_batch", "query_latency_ms_batch128", "query_qps_batch8",
    "cpu_reference_qps", "mfu_fused_131k", "index_build_1m_candidates_ms", "query_qps_1m_candidates_fused",
    "query_qps_1m_candidates_plain", "fused_vs_plain_1m", "mfu_fused_1m", "knn_qps_262k_rows_d1024",
    "knn_qps_262k_rows_d1024_approx", "train_step_graphs_per_sec", _GFN,
    *(f"{_GFN}_{v}" for v in ("cached_embed", "bf16_policy", "no_precompute", "sts", "sts_bf16", "b64_bf16",
                              "b64_bf16_dots", "b64_bf16_sts", "b64_bf16_sts_dots")),
    "serve_qps_warm_256q_d1024", *(f"serve_{v}" for v in _SERVE),
    "serve_qps_realistic_1024q_d1024", *(f"serve_realistic_{v}" for v in _SERVE),
)


def _progress(msg: str) -> None:
    print(f"[bench] {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _free(dev: torch.device) -> None:
    """Between sections: drop the last section's tensors from the cache."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def card_info(dev: torch.device) -> tuple[str, float | None]:
    """(the card's name, its power limit in W from nvidia-smi); ("cpu",
    None) off the card."""
    if dev.type != "cuda":
        return "cpu", None
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    limit = lines[min(dev.index or 0, len(lines) - 1)].rsplit(",", 1)[1].split()[0]
    try:
        return torch.cuda.get_device_name(dev), float(limit)
    except ValueError:  # "[N/A]": the card reports no limit
        return torch.cuda.get_device_name(dev), None


def write_details(details: dict, path: str | os.PathLike) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(details, indent=2) + "\n")


def emit_structured_error(details: dict, path: str | os.PathLike, kind: str, detail: str) -> None:
    """The details of the finished sections with the error, and one
    parseable error line on stdout (``bench.py``'s shape)."""
    details.setdefault("error", kind)
    details.setdefault("error_detail", detail[:400])
    write_details(details, path)
    print(json.dumps({"metric": METRIC_NAME, "value": None, "unit": METRIC_UNIT, "vs_baseline": None,
                      "error": kind, "detail": detail[:400]}))


# ---------------------------------------------------------------- inputs

def build_inputs(num_candidates: int, dim: int, struct_dim: int, batch: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return {
        "head": rng.normal(size=(num_candidates, dim)).astype(np.float32) * 0.1,
        "rel": rng.normal(size=(num_candidates, dim)).astype(np.float32) * 0.1,
        "tail": rng.normal(size=(num_candidates, dim)).astype(np.float32) * 0.1,
        "struct": rng.normal(size=(num_candidates, struct_dim)).astype(np.float32),
        "q": rng.normal(size=(batch, dim)).astype(np.float32),
    }


def build_inputs_device(
    num_candidates: int, dim: int, struct_dim: int, batch: int,
    dtype: torch.dtype | None = None, device: str | torch.device | None = None,
):
    """Candidates drawn on the device (``torch.Generator`` seeded 0):
    ``bench.py``'s distributions and dtypes, not its draws.  A million-row
    index never crosses the host link; each f32 draw is cast before the next."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    dtype = dtype or torch.float32

    def mk(shape, scale):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x.mul_(scale) if scale != 1.0 else x).to(dtype)

    out = {name: mk((num_candidates, dim), 0.1) for name in ("head", "rel", "tail")}
    out["struct"] = mk((num_candidates, struct_dim), 1.0)
    out["q"] = torch.randn((batch, dim), generator=gen, device=dev)
    return out


def make_bundle(dim: int, hidden: int, struct_dim: int, seed: int = 0):
    """Random retriever feature bundle with the production geometry."""
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


def _device_bundle(bundle: dict, dev: torch.device) -> dict:
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    return {**bundle, "features": bundle_from_numpy(bundle["features"], device=dev)}


# ---------------------------------------------------------------- pooled query

def hold_to_plain(vals, ids, plain, k: int) -> tuple[float, int]:
    """Hold a kernel's top-k rows to its plain version's full score rows:
    ids distinct and in range, values within ``CHECK_ATOL`` of the plain
    score of the same id, sorted, and every id in one top-k but not the
    other within ``CHECK_TIE_TOL`` of the plain k-th score.  Returns (max
    abs error, differing ids); raises ``AssertionError`` on a breach."""
    v, i, s = vals.float().cpu().numpy(), ids.cpu().numpy(), plain.float().cpu().numpy()
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
        far = [e for e in diff if abs(s[b, e] - kth) > CHECK_TIE_TOL]
        if far:
            raise AssertionError(f"query {b}: ids {far} differ beyond the near-tie rule")
        differing += len(diff) // 2
    if max_err > CHECK_ATOL:
        raise AssertionError(f"max score error {max_err:.3e} > {CHECK_ATOL}")
    return max_err, differing


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(abs(x))) - 7) if x != 0 else 0.0


def full_ranking(bundle, q_emb, head_repr, *args, k, weights, width: int):
    """Kernel 3's plain version ranking every candidate instead of the top
    k, padded with -inf to ``width`` slots (>= every bucket's m_pad), so
    that ``serve_split(fused_fn=...)`` keeps each kernel-routed question's
    whole ranking with its scores."""
    m = head_repr.shape[1]
    if m > width:
        raise ValueError(f"bucket M={m} > width {width}")
    vals, ids = sk.per_question_topk_reference(bundle, q_emb, head_repr, *args, k=m, weights=weights)
    return (torch.nn.functional.pad(vals, (0, width - m), value=float("-inf")),
            torch.nn.functional.pad(ids, (0, width - m), value=-1))


def hold_serve_to_plain(samples, results, full) -> tuple[list, int, float]:
    """Hold a serve's top-k to the plain-version serve's full rankings
    (``full``, one per sample, every edge ranked): ids valid and distinct,
    scores within ``CHECK_ATOL`` of the plain score of the same edge, and
    every id in one top-k but not the other within ``CHECK_TIE_TOL`` of the
    plain k-th score.  Both serves round their scores to bf16, so each bound
    is at least one bf16 ulp of the plain score.  At most
    ``CHECK_MAX_SWAPPED`` questions may differ.  Returns (the plain serve
    cut to its top k, swapped questions, max score error); raises
    ``AssertionError`` on a breach."""
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
            if err > max(CHECK_ATOL, bf16_ulp(score_of[e])):
                raise AssertionError(f"{r.sample_id}: score error {err:.3e} at {e} > max({CHECK_ATOL}, 1 bf16 ulp)")
            max_err = max(max_err, err)
        kth = float(f.scores[n - 1])
        diff = set(got) ^ set(f.edge_ids[:n].tolist())
        far = [e for e in diff if abs(score_of[e] - kth) > max(CHECK_TIE_TOL, bf16_ulp(kth))]
        if far:
            raise AssertionError(f"{r.sample_id}: ids {far} differ beyond the near-tie rule")
        swapped += bool(diff)
    if swapped > CHECK_MAX_SWAPPED:
        raise AssertionError(f"{swapped} questions differ by near-tie swaps (at most {CHECK_MAX_SWAPPED})")
    return plain, swapped, max_err


@dataclasses.dataclass
class QueryRun:
    qps: float
    latency_s: float
    vals: torch.Tensor
    ids: torch.Tensor
    calls: int                  # calls of the engine, warm passes included
    check: dict | None = None   # the first pass held to the plain version (kernel engines)


_PLAIN_ROWS = {"fused": sk.fused_scores_reference, "per_query": sk.score_bidirectional_reference}


def bench_query(bundle, inputs, *, k: int, chunk: int, iters: int = 5, engine: str = "fused",
                index_dtype: torch.dtype | None = None, check_queries: int = 0,
                device: str | torch.device | None = None) -> QueryRun:
    """Time the pooled query (``bench_tpu``): two synced warm passes, then
    ``iters`` passes of which the last is synced, on the host clock.

    engine: ``"fused"`` (kernel 2, ``query_topk_fused``) | ``"per_query"``
    (kernel 1, ``query_topk_per_query``; one launch scores every query, where
    JAX launches per query tile) | ``"plain"`` (``ops.query.query_topk``).
    The index is f32 unless ``index_dtype`` is given (bf16 at 1M, as in
    JAX); the kernels take bf16 rows, and their cast stays in the timed
    call as the Pallas kernels' cast on entry does.  ``check_queries`` > 0
    holds the first pass's top-k of that many queries to the kernel's plain
    version's full score rows (``hold_to_plain``) before the timing."""
    from evi_rag_tpu_torch.ops.query import TripleIndex, query_topk

    dev = resolve_device(device)
    cast = lambda x: torch.as_tensor(x).to(device=dev, dtype=index_dtype)  # noqa: E731
    index = TripleIndex(head_repr=cast(inputs["head"]), rel_repr=cast(inputs["rel"]),
                        tail_repr=cast(inputs["tail"]), struct_raw=cast(inputs["struct"]))
    b = _device_bundle(bundle, dev)
    q = torch.as_tensor(inputs["q"]).to(device=dev, dtype=torch.float32)
    bf16 = torch.bfloat16
    if engine == "fused":
        run = lambda: sk.query_topk_fused(b, q, index.to(dtype=bf16), k=k)  # noqa: E731
    elif engine == "per_query":
        run = lambda: sk.query_topk_per_query(b, q, index.to(dtype=bf16), k=k)  # noqa: E731
    elif engine == "plain":
        run = lambda: query_topk(b, q, index, k=k, chunk=chunk, device=dev)  # noqa: E731
    else:
        raise ValueError(f"engine must be fused|per_query|plain, got {engine!r}")

    out = run()
    _sync(dev)
    check = None
    if check_queries > 0 and engine in _PLAIN_ROWS:
        n = min(check_queries, q.shape[0])
        rows = index.to(dtype=bf16)
        plain = _PLAIN_ROWS[engine](b, q[:n], rows.head_repr, rows.rel_repr, rows.tail_repr, rows.struct_raw)
        err, differing = hold_to_plain(out[0][:n], out[1][:n], plain, k)
        check = {"queries": n, "max_abs_err": err, "differing_ids": differing, "atol": CHECK_ATOL,
                 "tie_tol": CHECK_TIE_TOL}
        del rows, plain
    run()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters - 1):
        run()
    out = run()
    _sync(dev)
    dt = (time.perf_counter() - t0) / iters
    return QueryRun(q.shape[0] / dt, dt, out[0], out[1], iters + 2, check)


def fused_kernel_mfu(qps: float, num_candidates: int, d: int, h: int, bq: int) -> float:
    """Analytic MFU of the fused batched top-k kernel, ``bench.py``'s count
    over the H100's bf16 peak: per (candidate, query) 2 per-query [D] x [D,
    H] rows (u, r_ctx) plus 3 query-independent rows amortized over bq
    queries, 2 D H (2 + 3 / bq) FLOP; matvecs, the struct projection and the
    epilogues are excluded.  At B = bq = 128, M = 131,072, D = H = 1024 one
    pass is ``chip_smoke.pooled_bounds``' kernel-2 bound, 71.985 ms."""
    flops_per_cand_query = 2.0 * d * h * (2.0 + 3.0 / bq)
    return qps * num_candidates * flops_per_cand_query / (H100_BF16_PEAK_TFLOPS * 1e12)


def auto_bq(batch: int) -> int:
    """``bench.py``'s mirror of ``pallas_query_topk_fused``'s bq auto-select
    (for the MFU count; kernel 2 takes every query of a launch at once)."""
    bq = 8
    while bq < min(batch, 128):
        bq *= 2
    return bq


def bench_cpu_reference(bundle, inputs, *, reduced: int, scale_to: int):
    """Torch-CPU run of the same scorer on a reduced set, scaled linearly
    to ``scale_to`` candidates.

    A timing baseline only, copied from ``bench.py``: its LayerNorm eps
    (1e-6) and exact GELU differ from the kernels' (eps 1e-5, and the Pallas
    kernels' tanh GELU), so it is no correctness oracle."""
    def to_torch(x):
        if isinstance(x, dict):
            return {k: to_torch(v) for k, v in x.items()}
        return torch.from_numpy(np.asarray(x))

    f = to_torch(bundle["features"])

    def dense(p, x):
        return x @ p["kernel"] + p["bias"]

    def lnorm(p, x):
        m = x.mean(-1, keepdim=True)
        v = x.var(-1, unbiased=False, keepdim=True)
        return (x - m) / torch.sqrt(v + 1e-6) * p["scale"] + p["bias"]

    h = torch.from_numpy(inputs["head"][:reduced])
    r = torch.from_numpy(inputs["rel"][:reduced])
    t = torch.from_numpy(inputs["tail"][:reduced])
    s = torch.from_numpy(inputs["struct"][:reduced])
    q = torch.from_numpy(inputs["q"][:1])
    s_dim = s.shape[-1] // 2

    def score(qrow, h, r, t, s):
        qp = torch.tanh(dense(f["query_proj"]["proj"], qrow))
        gate = torch.sigmoid(dense(f["q_gate"], qp))
        bias = torch.tanh(dense(f["q_bias"], qp))
        r_ctx = r * gate + bias
        sc = torch.nn.functional.gelu(lnorm(f["struct_norm"], dense(f["struct_proj"], s)))
        nav = torch.sigmoid(dense(f["struct_gate"], sc))
        inter = h * r_ctx * t * nav
        err = h + r_ctx - t
        dist = -torch.sqrt((err * err).sum(-1, keepdim=True) + 1e-12)
        comb = torch.cat([inter, sc, err, dist], dim=-1)
        z = torch.nn.functional.gelu(lnorm(f["state_norm"], dense(f["state_net_0"], comb)))
        z = dense(f["state_net_1"], z)
        return dense(f["score_head"], z)[..., 0]

    with torch.no_grad():
        score(q[0], h, r, t, s)  # warm
        dt_reduced = float("inf")
        for _rep in range(3):  # best-of-3: host CPU timing is noisy under load
            t0 = time.perf_counter()
            fwd = score(q[0], h, r, t, s)
            s_swap = torch.cat([s[:, s_dim:], s[:, :s_dim]], dim=-1)
            bwd = score(q[0], t, r, h, s_swap)
            st = torch.stack([fwd, bwd])
            w = torch.softmax(st, dim=0)
            _ = torch.topk((w * st).sum(0), k=min(100, reduced))
            dt_reduced = min(dt_reduced, time.perf_counter() - t0)
    dt_full = dt_reduced * (scale_to / reduced)
    return 1.0 / dt_full  # queries/sec (single CPU)


# ---------------------------------------------------------------- secondary sections

def bench_index_build(dim: int = FULL.dim, vocab: int = FULL.build_vocab, rels: int = FULL.build_rels,
                      m: int = FULL.build_m, device: str | torch.device | None = None) -> float:
    """Index build ms: project the entity / relation tables through the
    projectors and gather ``m`` candidate rows (``build_triple_index``),
    tables made on the device (``torch.Generator`` seeded 2); one warm build,
    then one timed."""
    from evi_rag_tpu_torch.ops.query import build_triple_index

    dev = resolve_device(device)
    bundle = _device_bundle(make_bundle(dim, dim, 20, seed=3), dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tables = dict(
        entity_emb=torch.randn((vocab, dim), generator=gen, device=dev).mul_(0.1),
        relation_emb=torch.randn((rels, dim), generator=gen, device=dev).mul_(0.1),
        nontext_mask=torch.rand((vocab,), generator=gen, device=dev) < 0.05,
        heads=torch.randint(0, vocab, (m,), generator=gen, device=dev, dtype=torch.int32),
        rels=torch.randint(0, rels, (m,), generator=gen, device=dev, dtype=torch.int32),
        tails=torch.randint(0, vocab, (m,), generator=gen, device=dev, dtype=torch.int32),
        struct_raw=torch.randn((m, 20), generator=gen, device=dev),
    )
    build_triple_index(bundle, **tables, device=dev).head_repr[0].cpu()  # warm
    t0 = time.perf_counter()
    build_triple_index(bundle, **tables, device=dev).head_repr[0].cpu()
    return (time.perf_counter() - t0) * 1e3


def bench_knn(dim: int = FULL.dim, table_rows: int = FULL.knn_rows, batch: int = FULL.knn_batch,
              k: int = FULL.k, device: str | torch.device | None = None) -> tuple[float, float]:
    """kNN q/s over an embedding table (the entity-linking path), exact and
    approx, cosine: two warm calls, then the best of 3 windows of 5 calls."""
    from evi_rag_tpu_torch.ops.knn import knn_topk

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((table_rows, dim), generator=gen, device=dev)
    q = torch.randn((batch, dim), generator=gen, device=dev)
    out = {}
    for method in ("exact", "approx"):
        def run():
            return knn_topk(q, table, k=k, metric="cosine", method=method)

        run()[0].cpu()
        run()[0].cpu()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(4):
                run()
            run()[0].cpu()
            best = min(best, (time.perf_counter() - t0) / 5)
        out[method] = batch / best
    return out["exact"], out["approx"]


def bench_train_step(*, samples: int = FULL.train_samples, dim: int = FULL.dim,
                     max_nodes: int = FULL.train_max_nodes, bucket: Bucket = FULL.train_bucket,
                     device: str | torch.device | None = None) -> float:
    """Retriever train-step graphs/s at production width (D = H = 1024,
    bf16, dropout 0.1): one warm step, then the best of 3 windows of 5
    steps.  The batch is on the card before the timing, as JAX's collated
    batch is."""
    from evi_rag_tpu_torch.data.feeder import collate_stacked
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.models.retriever import Retriever
    from evi_rag_tpu_torch.ops.graph import batch_to
    from evi_rag_tpu_torch.train.retriever_trainer import (
        RetrieverTrainConfig,
        create_train_state,
        make_train_step,
    )

    dev = resolve_device(device)
    ds = make_synthetic_dataset(num_samples=samples, emb_dim=dim, max_nodes=max_nodes, seed=0)
    batch = collate_stacked(ds.samples, num_shards=1, entity_emb=ds.entity_emb,
                            relation_emb=ds.relation_emb, question_emb=ds.question_emb, bucket=bucket)
    model = Retriever(emb_dim=dim, hidden_dim=dim, dropout_p=0.1, compute_dtype="bfloat16")
    cfg = RetrieverTrainConfig(k_values=(100,))
    state, tx = create_train_state(model, batch, cfg, seed=0, device=dev)
    batch = batch_to(batch, dev)
    step = make_train_step(model, tx, cfg)
    state, m = step(state, batch)
    float(m["loss"])  # sync
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        iters = 5
        for _ in range(iters):
            state, m = step(state, batch)
        float(m["loss"])
        dt = min(dt, (time.perf_counter() - t0) / iters)
    return samples / dt


def _best_step_s(step: Callable, state, batch, fe=None) -> float:
    """One warm GFlowNet step, then the best of 3 windows of 5 steps, in s
    per step (each window ends on a host read of the loss)."""
    args = (batch,) if fe is None else (batch, fe)
    state, m = step(state, *args)
    float(m["loss"])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            state, m = step(state, *args)
        float(m["loss"])
        best = min(best, (time.perf_counter() - t0) / 5)
    return best


def bench_gflownet_step(*, graphs: int = FULL.gfn_graphs, dim: int = FULL.dim,
                        device: str | torch.device | None = None):
    """GFlowNet train-step graphs/s at production width (4 sampled rollouts
    + SubTB + BC per step) on ``profile_gfn_step._build``'s batch: canonical
    (frozen embed inline), cached frozen embed, bf16 policy, the per-step
    policy (``precompute_policy=False``; skipped under
    ``EVI_BENCH_GFN_AB=0``, then None) and sample-then-score at f32 and
    bf16, the last four on the cached embed."""
    from evi_rag_tpu_torch.models.gflownet.embedder import embed_agent_batch_frozen
    from evi_rag_tpu_torch.scripts import profile_gfn_step as pg
    from evi_rag_tpu_torch.train.optim import setup_optimizer
    from evi_rag_tpu_torch.train.checkpoint import flatten_tree
    from evi_rag_tpu_torch.train.retriever_trainer import TrainState

    dev = resolve_device(device)
    cfg, mods, bundle, batch, params, tx, state, step = pg._build(graphs, emb=dim, device=dev)
    dt = _best_step_s(step, state, batch)
    fe = embed_agent_batch_frozen(bundle, batch)
    dt_cached = _best_step_s(step, state, batch, fe)

    def timed(cfg_v):
        _, _, _, st_v, step_v = pg.fresh_step(cfg_v, bundle, dev)
        return _best_step_s(step_v, st_v, batch, fe)

    dt16 = timed(dataclasses.replace(cfg, compute_dtype="bfloat16"))
    dt_off = None
    if os.environ.get("EVI_BENCH_GFN_AB", "1") == "1":
        # The canonical modules and parameters with a fresh optimizer state,
        # stepped by the per-step policy, as JAX does.
        cfg_off = dataclasses.replace(cfg, precompute_policy=False)
        tx_off = setup_optimizer(cfg_off.optimizer, flatten_tree(params))
        state_off = TrainState(params=params, opt_state=tx_off.init(flatten_tree(params)), step=0,
                               generator=torch.Generator(device=dev).manual_seed(1))
        dt_off = _best_step_s(pg.gt.make_gfn_train_step(mods, tx_off, cfg_off, bundle), state_off, batch, fe)
    dt_sts = timed(dataclasses.replace(cfg, sample_then_score=True))
    dt_sts16 = timed(dataclasses.replace(cfg, sample_then_score=True, compute_dtype="bfloat16"))
    g = graphs
    return (g / dt, g / dt_cached, g / dt16, (g / dt_off if dt_off else None), g / dt_sts, g / dt_sts16)


def bench_gflownet_step_wide(graphs: int = FULL.gfn_graphs_wide, *, dim: int = FULL.dim,
                             device: str | torch.device | None = None) -> dict[str, float]:
    """The GFlowNet step at G = 64 (``profile_gfn_step._build(64)``), bf16
    policy on the cached frozen embed; under ``EVI_BENCH_GFN_KNOBS`` (default
    on) also "dots" remat, sample-then-score, and both."""
    from evi_rag_tpu_torch.models.gflownet.embedder import embed_agent_batch_frozen
    from evi_rag_tpu_torch.scripts import profile_gfn_step as pg

    dev = resolve_device(device)
    cfg, _, bundle, batch, _, _, _, _ = pg._build(graphs, emb=dim, device=dev)
    fe = embed_agent_batch_frozen(bundle, batch)

    def timed(cfg_v):
        _, _, _, st_v, step_v = pg.fresh_step(cfg_v, bundle, dev)
        return graphs / _best_step_s(step_v, st_v, batch, fe)

    cfg16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    out = {"b64_bf16": timed(cfg16)}
    if os.environ.get("EVI_BENCH_GFN_KNOBS", "1") == "1":
        out["b64_bf16_dots"] = timed(dataclasses.replace(cfg16, remat_policy="dots"))
        out["b64_bf16_sts"] = timed(dataclasses.replace(cfg16, sample_then_score=True))
        out["b64_bf16_sts_dots"] = timed(dataclasses.replace(cfg16, sample_then_score=True, remat_policy="dots"))
    return out


def bench_serve_surface(num_questions: int = FULL.serve_questions, dim: int = FULL.dim, k: int = FULL.k, *,
                        realistic: bool = False, device: str | torch.device | None = None):
    """The serving surface (``serve_split``, the engine of ``cli serve``) at
    production width: one cold pass, then 5 warm passes.  ``realistic``
    sizes the subgraphs like the WebQSP-scale build (128-1024 nodes, ~3
    extra edges a node, 16,384 entities) instead of the toy 64-node graphs.

    The cold pass's questions that kernel 3 served (``_kernel_routed``) are
    held to its plain version's whole rankings (``full_ranking``,
    ``hold_serve_to_plain``).  Returns (the median warm pass's stats, every
    warm pass's q/s, the best q/s, the serve passes, the check)."""
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.serving import bucket_width, project_tables, serve_split

    dev = resolve_device(device)
    size_kw = (
        dict(min_nodes=128, max_nodes=1024, avg_extra_edges=3.0, num_entities=16384)
        if realistic
        else dict(max_nodes=64, num_entities=4096)
    )
    ds = make_synthetic_dataset(num_samples=num_questions, emb_dim=dim, num_relations=64, seed=7, **size_kw)
    struct_dim = 2 * 2 * (1 + 2 + 2)
    bundle = _device_bundle(make_bundle(dim, dim, struct_dim, seed=11), dev)
    projected = project_tables(bundle, ds.entity_emb, ds.relation_emb, device=dev)
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb, k=k,
              num_rounds=2, num_reverse_rounds=2, projected=projected, device=dev)
    cold, _ = serve_split(bundle, ds.samples, **kw)
    runs = []
    for _ in range(5):
        _, stats = serve_split(bundle, ds.samples, **kw)
        runs.append(stats)
    runs.sort(key=lambda s: s.queries_per_s)
    all_qps = [s.queries_per_s for s in runs]

    groups, held = _kernel_routed(ds.samples, k) if sk.kernel_supports(dim, dim, struct_dim, k) else (0, [])
    check = {"questions": len(held), "groups": groups, "max_abs_err": 0.0, "swapped": 0, "atol": CHECK_ATOL,
             "tie_tol": CHECK_TIE_TOL}
    if held:
        # Every bucket of these questions through the plain version (any
        # regrouping is harmless: a question's scores do not depend on its group).
        sub = [ds.samples[i] for i in held]
        width = bucket_width(sub, k)  # >= the m_pad of every bucket of these questions
        full, _ = serve_split(bundle, sub, fused_threshold=0, fused_fn=functools.partial(full_ranking, width=width),
                              **kw)
        _, check["swapped"], check["max_abs_err"] = hold_serve_to_plain(sub, [cold[i] for i in held], full)
    return runs[len(runs) // 2], all_qps, max(all_qps), 1 + len(runs), check


def _kernel_routed(samples, k: int) -> tuple[int, list[int]]:
    """(groups, sample indices) that ``serve_split`` at its defaults (groups
    of 16 in edge-count order, ``fused_threshold`` 256) sends to kernel 3
    when the kernels take the shape: the groups whose padded width m_pad is
    256 or more."""
    from evi_rag_tpu_torch.serving import bucket_width

    order = sorted(range(len(samples)), key=lambda i: samples[i].edge_index.shape[1])
    groups, routed = 0, []
    for g0 in range(0, len(order), 16):
        group = order[g0:g0 + 16]
        if bucket_width([samples[i] for i in group], k) >= 256:
            groups, routed = groups + 1, routed + group
    return groups, sorted(routed)


# ---------------------------------------------------------------- main

def _launches() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def _section(details: dict, name: str, fn: Callable[[], Any], dev: torch.device):
    """Run one section: its kernel launches (the wrappers' counts after less
    before) under ``details["launches"][name]``, then free its tensors.  The
    sections that drive a kernel add the passes that made them."""
    _progress(name)
    before = _launches()
    try:
        return fn()
    finally:
        details.setdefault("launches", {})[name] = {k: v - before[k] for k, v in _launches().items()}
        _free(dev)


def _serve_keys(details: dict, prefix: str, stats, all_qps, best_qps) -> None:
    # One phase-key set for every serve point: the median pass, every
    # pass's q/s, the best, and the phase breakdown of the median pass.
    details[prefix] = stats.queries_per_s
    base = prefix.rsplit("_qps", 1)[0] + ("_realistic" if "realistic" in prefix else "")
    details[f"{base}_qps_all_passes"] = all_qps
    details[f"{base}_qps_best"] = best_qps
    details[f"{base}_pack_s"] = stats.pack_s
    details[f"{base}_dispatch_s"] = stats.dispatch_s
    details[f"{base}_drain_s"] = stats.drain_s
    details[f"{base}_index_build_s"] = stats.index_build_s
    wall = max(stats.scoring_s, 1e-9)
    details[f"{base}_drain_frac"] = round(stats.drain_s / wall, 3)
    details[f"{base}_dispatch_frac"] = round(stats.dispatch_s / wall, 3)


def main(details: dict, *, device: str | torch.device | None = None, sizes: Sizes = FULL,
         details_path: str | os.PathLike = DETAILS_PATH) -> dict:
    """Every section in ``bench.py``'s order; fills ``details``, writes them
    to ``details_path`` and prints the result line (returned).  A section
    that raises ends the run: ``run_cli`` reports it."""
    dev = resolve_device(device)
    s = sizes
    name, power = card_info(dev)
    details.update(device=name, power_limit_w=power)
    checks = details.setdefault("checks", {})
    dim = s.dim
    struct_dim = 2 * 2 * (1 + 2 + 2)  # edge struct = concat(head, tail) topic features
    bundle = make_bundle(dim, dim, struct_dim)
    qkw = dict(k=s.k, chunk=s.chunk, check_queries=CHECK_QUERIES, device=dev)

    _progress(f"gen {s.candidates} inputs on the device")
    inputs = build_inputs_device(s.candidates, dim, struct_dim, s.batch, device=dev)
    head = _section(details, "headline", lambda: bench_query(bundle, inputs, engine="fused", **qkw), dev)
    details["launches"]["headline"]["passes"], checks["headline"] = head.calls, head.check
    small = _section(details, "batch8", lambda: bench_query(
        bundle, {**inputs, "q": inputs["q"][:s.batch_small]}, engine="fused", **qkw), dev)
    details["launches"]["batch8"]["passes"], checks["batch8"] = small.calls, small.check
    del inputs  # free the 131k index before the large-memory sections
    _free(dev)
    _progress("torch cpu reference")
    cpu_qps = bench_cpu_reference(bundle, build_inputs(s.cpu_reduced, dim, struct_dim, s.batch),
                                  reduced=s.cpu_reduced, scale_to=s.candidates)
    vs = head.qps / cpu_qps if cpu_qps else float("nan")
    details.update(
        engine="fused",
        query_throughput_qps=round(head.qps, 3),
        headline_batch=s.batch,
        **{f"query_latency_ms_batch{s.batch}": round(head.latency_s * 1e3, 2)},
        query_qps_batch8=round(small.qps, 2),
        cpu_reference_qps=round(cpu_qps, 4) if cpu_qps else None,
        mfu_fused_131k=round(fused_kernel_mfu(head.qps, s.candidates, dim, dim, auto_bq(s.batch)), 4),
    )
    details["index_build_1m_candidates_ms"] = round(_section(details, "index build", lambda: bench_index_build(
        dim, s.build_vocab, s.build_rels, s.build_m, device=dev), dev), 1)

    def million():
        _progress(f"gen {s.candidates_1m} inputs on the device")
        inputs = build_inputs_device(s.candidates_1m, dim, struct_dim, s.batch, dtype=torch.bfloat16, device=dev)
        kw = dict(qkw, iters=3, index_dtype=torch.bfloat16)
        fused = bench_query(bundle, inputs, engine="fused", **kw)
        checks["1m_fused"] = fused.check
        _progress("1M plain")
        return fused, bench_query(bundle, inputs, engine="plain", **kw)

    fused_1m, plain_1m = _section(details, "1m", million, dev)
    details["launches"]["1m"]["passes"] = fused_1m.calls
    details["query_qps_1m_candidates_fused"] = round(fused_1m.qps, 2)
    details["query_qps_1m_candidates_plain"] = round(plain_1m.qps, 2)
    details["fused_vs_plain_1m"] = round(fused_1m.qps / plain_1m.qps, 2)
    details["mfu_fused_1m"] = round(fused_kernel_mfu(fused_1m.qps, s.candidates_1m, dim, dim, auto_bq(s.batch)), 4)
    del fused_1m, plain_1m

    knn_exact, knn_approx = _section(details, "knn", lambda: bench_knn(dim, s.knn_rows, s.knn_batch, s.k,
                                                                       device=dev), dev)
    details["knn_qps_262k_rows_d1024"] = round(knn_exact, 2)
    details["knn_qps_262k_rows_d1024_approx"] = round(knn_approx, 2)
    details["train_step_graphs_per_sec"] = round(_section(details, "train step", lambda: bench_train_step(
        samples=s.train_samples, dim=dim, max_nodes=s.train_max_nodes, bucket=s.train_bucket, device=dev), dev), 2)

    def gfn():
        return (bench_gflownet_step(graphs=s.gfn_graphs, dim=dim, device=dev),
                bench_gflownet_step_wide(s.gfn_graphs_wide, dim=dim, device=dev))

    (qps_gfn, qps_cached, qps_bf16, qps_noprecomp, qps_sts, qps_sts16), wide = _section(
        details, "gflownet step", gfn, dev)
    details["gflownet_step_graphs_per_sec"] = round(qps_gfn, 2)
    details["gflownet_step_graphs_per_sec_cached_embed"] = round(qps_cached, 2)
    details["gflownet_step_graphs_per_sec_bf16_policy"] = round(qps_bf16, 2)
    if qps_noprecomp:
        details["gflownet_step_graphs_per_sec_no_precompute"] = round(qps_noprecomp, 2)
    details["gflownet_step_graphs_per_sec_sts"] = round(qps_sts, 2)
    details["gflownet_step_graphs_per_sec_sts_bf16"] = round(qps_sts16, 2)
    for lbl, v in wide.items():
        details[f"gflownet_step_graphs_per_sec_{lbl}"] = round(v, 2)

    for section, prefix, questions, realistic in (
            ("serve surface", "serve_qps_warm_256q_d1024", s.serve_questions, False),
            ("serve realistic", "serve_qps_realistic_1024q_d1024", s.serve_questions_realistic, True)):
        stats, all_qps, best, passes, check = _section(details, section, lambda: bench_serve_surface(
            questions, dim, s.k, realistic=realistic, device=dev), dev)
        details["launches"][section]["passes"] = passes
        checks["serve_realistic" if realistic else "serve"] = check
        _serve_keys(details, prefix, stats, all_qps, best)

    print(json.dumps(details), file=sys.stderr)
    write_details(details, details_path)
    line = {"metric": METRIC_NAME, "value": round(head.qps, 3), "unit": METRIC_UNIT,
            "vs_baseline": round(vs, 2) if np.isfinite(vs) else None, "device": name, "power_limit_w": power}
    print(json.dumps(line))
    return line


def run_cli(argv: list[str] | None = None, *, sizes: Sizes = FULL) -> int:
    """Entry point: 0 with the result line, or 1 with the structured error
    line after a section raised (the details of the sections that finished
    are written either way).  Without a card and without ``--device cpu``
    it raises before any section runs."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--details", default=DETAILS_PATH, help=f"details JSON path (default {DETAILS_PATH})")
    ap.add_argument("--device", default=None, help="cpu to run off the card (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    details: dict = {}
    try:
        main(details, device=dev, sizes=sizes, details_path=args.details)
    except Exception as exc:  # noqa: BLE001 -- a failed section is reported, then the run fails
        traceback.print_exc()
        emit_structured_error(details, args.details, "bench_exception", repr(exc))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(run_cli())
