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
   rule, the kernel's, the plain version's and the bound's times, and the
   kernel's TFLOP/s (as it does the work, whole tiles of 128 edges, and as
   the bound counts it, valid edges); then the kernel's output on a fixed
   input against its pinned digest (``PQT_DIGEST``: bit for bit the same
   from run to run and from change to change) and the ptxas report of its
   wgmma kernel;
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
   ``query_topk_fused`` (kernel 2), q/s as the median of 3 warm passes and
   the phase's peak device memory; 8 queries held to each kernel's plain
   version's full score rows; each kernel's ms per launch (scoring
   launches and the select timed apart), achieved TFLOP/s (as the kernel
   does the work and as the bound counts it), bound, plain version's ms,
   and the ptxas report of the wgmma kernels;
7. training (no kernel lies on it: eager PyTorch with autograd).
   7a: the production retriever (D = H = 1024, bf16, hide-and-seek, T =
   0.07, AdamW at a constant 1e-4) on a 256-question realistic train split
   (seed 8), batch 16, 3 warmup steps then two timed epochs: step ms
   (median, CUDA events), graphs/s, real edges/s, the padded-edge share,
   TFLOP/s as ``train_flops`` counts it over padded and over real edges with
   that count's bound at 989 TFLOP/s, peak memory, loss and grad norm, and
   the validation metrics of phase 4's split with the eval pass's seconds
   and component sweeps; a remat step; a traced step (device time by
   kernel, busy share).  7b: one f32 step at D = H = 256 on the card held
   to the same step on the CPU (``testing.card_vs_cpu_step``) and one bf16
   step at full width.  7c: the ``train_retriever`` CLI on the card in the
   small synthetic setting (``testing.small_train_gain``: validation
   recall@5 must rise by more than 0.05 over the untrained parameters),
   then ``serve`` on its ``ckpt/best`` through kernel 3;
8. the GFlowNet stage (no kernel lies on it either), on phase 7a's
   retriever, kept as a port checkpoint under ``chiprun_out/``.  8a:
   ``eval_retriever`` at D = H = 1024 on phase 4's validation split and
   phase 7a's train split (``eval.g_agent`` defaults): the collate / device
   / artifact seconds, the agent samples, the store's bytes and the recall
   metrics.  8b: GFlowNet training at production width on the train store
   (``configs/experiment/train_gflownet.yaml``: hidden 1024, T = 4, 4
   rollouts, batch 8, f32 policy), 3 warmup steps then one timed epoch:
   step ms (median, CUDA events), graphs/s, the bucket, TFLOP/s as
   ``gfn_flops`` counts it, peak memory, a traced step (device time by
   kernel, busy share), a remat step and a bf16-policy step.  8c:
   ``eval_gflownet`` with 10 rollouts on the validation store
   (``answer_hit@k``, the rollout records) and the eval pass's q/s.  8d: one
   f32 GFlowNet step at H = 64 from perturbed parameters (every leaf's
   gradient non-zero) on the card held to the CPU
   (``testing.gfn_card_vs_cpu_step``).  8e: ``train_retriever ->
   eval_retriever -> train_gflownet -> eval_gflownet`` through the CLI at the
   small setting, then 6 steps on one fixed batch must lower the loss;
   ``bfs_chains`` runs in that chain after ``eval_retriever`` (9e); then the
   ``reasoner`` over the chain's validation store (the oracle, equal to a
   numpy recomputation; the mock LLM over triplets, over eval_gflownet's
   rollouts and over eval_bfs's chains; ``reasoner=ollama`` against a stub
   ``/api/chat`` on 127.0.0.1) and ``sweep=gflownet_tpe`` with 2 trials,
   both ``ok``.  8f: on 8b's setup and trained modules, one train batch and
   one set of draws, the sample-then-score rollout against the canonical
   loop (equal actions or one graph at a near tie, outputs within rtol
   1e-4 / atol 1e-5, the loss within rtol 1e-3 / atol 1e-4), step ms and
   peak memory of canonical, sample-then-score, + remat, + "dots", and
   canonical + "dots", and one traced sample-then-score step.  8g: the
   reasoner (oracle, mock triplets with ``configs/reasoner/ollama.yaml``'s
   nine windows) over 8a's validation store: records/s and the share of
   ``count_tokens``;
debug. ``experiment=debug`` (``extras.deterministic`` and
   ``extras.debug_nans``, ``utils/extras.py``) through the CLI, every run a
   fresh process (deterministic mode needs ``CUBLAS_WORKSPACE_CONFIG``
   before the process's first cuBLAS call; ``debug_child``).  (a)
   ``train_retriever retriever=production``, 1 epoch on phase 7a's split:
   without extras, with each mode alone and twice under the profile, whose
   two checkpoint digests must be equal; step ms of each.  (b)
   ``train_gflownet`` at hidden 1024 on 8a's stores, 1 epoch, without extras
   and twice under the profile (equal digests); step ms.  (c) ``serve`` of
   (a)'s checkpoint on phase 4's split under the profile and without it:
   ids and scores bit for bit equal, through kernel 3.  (d) under both
   modes, kernels 1 and 2 launched twice on phase 6's inputs (16 queries)
   give bit for bit the same output, kernel 3 its pinned digest; a NaN made
   in a backward op raises.  (e) a NaN learning rate raises
   ``FloatingPointError`` in the first step (non-zero exit, no
   ``ckpt/best``); a NaN row of W1 in the checkpoint raises it from kernel
   3's wrapper, which names the kernel.  (d) and (e) run at once.  (f)
   ``build`` (9c's gte-large geometry with random weights on a few dozen
   texts, so that SDPA runs), ``eval_retriever`` (8a's checkpoint and
   validation split), ``eval_gflownet`` (8b's checkpoint and validation
   store) and ``sweep`` (2 trials of 1 epoch at production width), each twice
   under the profile and once without extras, in two waves of fresh
   processes (``FOUR_TASK_WAVES``): the outputs' digests (``testing.output_digest``: the stores and embeddings,
   the records, checkpoints and ``metrics.json`` without run times) equal.
   Each run's stdout and stderr under ``chiprun_out/chip_smoke_debug/``;
9. the data build (no kernel lies on it: the gte GEMMs and attention are
   library calls).  9a: ``csrc/graphcore.cpp`` built with g++ and held to
   the numpy BFS engine on random graphs in both path modes.  9b: gte-large
   at its published geometry (24 layers, hidden 1024, 16 heads, gated MLP
   4096, vocab 30,528) with seeded random weights, card (f32, TF32 off)
   against CPU on 8 ragged rows of 64 tokens: pooled min cosine >= 0.99999
   and max abs error <= 1e-4 x max |x|.  9c: the WebQSP preset's 246-question
   validation split (``testing.synthetic_rows``, seed 0) through the build's
   passes 1-4 with that encoder (``testing.HashTokenizer``, 64 tokens, batch
   256) and the native engine: texts, real and padded tokens, encode s,
   texts/s, TFLOP/s as counted and the share of the f32 bound, one batch
   timed alone, the graph pass s and the engine that ran, bytes, peak
   memory.  9d: ``seed_stats`` through the CLI on the built split, and
   ``serve`` of it with phase 7a's retriever through kernel 3, held to the
   plain-version serve by phase 4's rule (q/s, bucket shapes);
10. ``sweep`` at full width: ``sweep=retriever_lr``, ``retriever=production``,
   3 trials of 1 epoch at a constant lr on phase 7a's train split and phase
   4's validation split: every trial ``ok``, the best the trial with the
   highest ``answer/reachability@100``, each trial's wall time and peak
   memory (a later peak 10% above the first's fails as a leak), then
   ``serve`` of the best trial's ``ckpt/best`` through kernel 3 under phase
   4's rule;
11. the multi-device paths, on one card standing in for a mesh (``[cuda:0]
   * 4`` beside ``make_mesh()``; the shards run one after another, so no
   number is a multi-card speed), each sub-phase's wall time printed.  11a:
   ``build_triple_index_sharded`` from a 4,194,304 x 1024 f32 entity table
   (16 GiB), 1,024 relations, 131,072 candidates, held to
   ``build_triple_index`` (rtol 1e-5 / atol 1e-6): seconds and peak memory
   of each.  11b: that index in bf16 through ``query_topk_sharded_fused``
   (kernel 2 once per shard; 128 queries, k = 100) held to the unsharded
   kernel (values within 1e-5, or the near-tie rule), ms per pass and
   launches per pass, and ``query_topk_sharded`` (f32, 8 queries) held to
   ``query_topk``.  11c: kNN at ``bench.py:353``'s shape (262,144 x 1024,
   64 queries, k = 100, cosine, bf16) one-shot, chunked, approx and over 4
   shards, held to an f32 brute force (approx: overlap >= 0.8 k), q/s.
   11d: phase 4's split through ``serve_split(mesh=...)`` over
   ``make_mesh()`` and ``[cuda:0] * 2``, kernel 3 on every entry, held to
   phase 4's serve and its plain full rankings: q/s, launches by device.
   11e: 2 ranks spawned with the ``EVI_*`` variables (the backend and the
   cards printed): one f32 step at D = H = 256 and one stacked GFlowNet step
   at hidden 1024, the ranks bit for bit equal and held to the
   single-process step; the production retriever's step ms with 2 shards x
   8; ``gather_records`` and the single-process-eval refusal across the
   ranks; the ``train_retriever`` CLI with ``num_shards=2`` (one
   ``ckpt/best``, the same digest on both ranks);
12. 12a, the kernel route's shape limits: ``serve`` (the CLI, then
   ``serve_split``) of phase 4's split cut to 64 questions at each shape the
   kernels refuse (emb_dim 96; S = 36 from 4 + 4 DDE rounds; k = 1500 at
   D = 1024), random weights: exit 0 with its metrics, jsonl and manifest,
   one routing line naming the limit, no kernel-3 launch, bit for bit the
   plain serve (every bucket on the plain bf16 scorer) and held to the
   plain full ranking by phase 4's rule; phase 4's serve again (17 kernel-3
   launches, bit for bit) and ``PQT_DIGEST``; kernels 1 and 2 at 70,000
   queries over 1,024 candidates (two launches each; the rows at both sides
   of the cut and at the ends held to the plain versions).  12b, the
   quality lane: the quality gate (``scripts/quality_gate.py``) trained on
   the card, its floors held; the quality baseline
   (``scripts/benchmark_quality.py``) at seed 0 held to the CPU seed-spread
   bar (``QUALITY_BAR``); ``eval_retriever`` of the baseline's retriever
   on the card against the CPU at f32 (metrics within 1e-4, ranked edges
   equal by the near-tie rule).  12c (run after the debug phase, while
   phase 8's checkpoint and stores exist): ``eval_gflownet`` of 8b's
   checkpoint on the first ``EVAL_GFN_SAMPLES`` samples of 8a's validation
   store, on the card and on the CPU at f32 (TF32 off), both with one set of
   rollout draws made on a CPU generator (``actor.make_rollout_draws``) and
   moved to the card: rollouts, hits and records equal, every metric within
   1e-4, a differing action only at a near tie (8f's rule).

``python3 chip_smoke.py --quality`` runs only the WebQSP-scale chain of
``scripts/run_webqsp_synth_hw.sh`` on the card: ``testing.synthetic_rows``'
WebQSP preset (2826 / 246 / 1628 questions) built with the hash encoder at
D = 1024 (``read_raw_rows`` + ``build_from_samples``), then the port's CLI
under ``experiment=webqsp_synth_hw`` at the config's own epochs (14
retriever and 20 GFlowNet epochs, patience 4 each): train_retriever,
eval_retriever over both dataset variants, train_gflownet, eval_gflownet
(25 rollouts), reasoner (oracle) and serve (k = 100, kernel 3).  Every
stage must exit 0 and write its manifest; it prints each stage's wall
seconds, the validation monitor of every training epoch with the best
epoch (and the epoch where patience stopped a run), and round 4's metrics
(``docs/RESULTS_synthetic.md``) beside the TPU run's values and the reduced
CPU chain's JAX values (``CPU_CHAIN_JAX``, marked reduced-scale) (~30 min
on the H100; the dataset, checkpoints and artifacts go to
``chiprun_out/chip_smoke_quality/work/`` and are removed when the chain
ends).

``python3 chip_smoke.py --ablation [M]`` runs only an ablation of the three
wgmma kernels instead: each source built again with a switch of
``csrc/twin_wgmma.cuh`` (``WG_NO_MMA``: no wgmma; ``WG_NO_EPI``: no epilogue;
``WG_NO_BUILD``: zero A rows sent without loads or math) and timed against the
full build, the pooled ones at B = 128 queries over M
candidates (default 32,768, scaled to the headline's 131,072), the
per-question one at phase 3's G = 16, M = 2048 input, where the full build
is also timed with one cluster per (question, tile) against its persistent
clusters (and must give bitwise the same output).  The switched builds
compute wrong scores; they only show where the time goes.

``python3 chip_smoke.py --crossover`` runs only the card's counterpart of
``scripts/measure_fused_crossover.py``: ``serve_window`` through kernel 3
and through the plain bf16 scorer on the same feeds (two buckets of 16
questions, D = 1024) at m_pad 8 .. 4096, wall ms per call, and the smallest
m_pad from which the kernel is faster at every larger width
(``serve.fused_threshold`` stays at the JAX package's 256).

Then a line ``{"kernels": [...]}``, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero without
that last line; so does a machine without CUDA or a directory without the
rest of the repository.  Weights and data are random, made from seeds.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import shutil
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
# The realistic synthetic split (bench.py's generator settings): phase 4's
# validation split is seed 7, phase 7a's train split seed 8.
REALISTIC = dict(emb_dim=D, num_relations=64, min_nodes=128, max_nodes=1024, avg_extra_edges=3.0,
                 num_entities=16384)
REPORT_M = 2048           # realistic serve buckets: median ~1.2k edges -> m_pad 2048
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
TRAIN_QUESTIONS = 256      # phase 7a: the train split (16 steps an epoch)
TRAIN_BATCH = 16           # configs/retriever/production.yaml per_shard_batch
TRAIN_WARMUP = 3
GFN_DIR = OUT_DIR / "chip_smoke_gfn"  # phase 8: the retriever checkpoint and the run logs stay
GFN_WORK = GFN_DIR / "work"           # stores, artifacts and checkpoints, removed when phase 8 ends
GFN_BATCH = 8              # configs/experiment/train_gflownet.yaml batch_size
GFN_ROLLOUTS = 4           # num_train_rollouts
GFN_EVAL_ROLLOUTS = 10     # configs/gflownet/default.yaml eval_rollouts
# Phase 9: gte-large-en-v1.5's published geometry (GTEConfig's defaults), the
# JAX build's padded encode shape, and the WebQSP preset's validation split.
GTE = dict(vocab_size=30528, hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
           intermediate_size=4096, type_vocab_size=2, rope_theta=160000.0, layer_norm_eps=1e-12, hidden_act="gelu")
GTE_LEN, GTE_BATCH = 64, 256
# Matrix FLOP per padded token: per layer 2 x 16,777,216 for the qkv, o,
# up_gate and down GEMMs and 4 T D for the scores and the weighted sum.
GTE_FLOP_PER_TOKEN = 24 * (2 * 16_777_216 + 4 * GTE_LEN * 1024)
GTE_COS_MIN = 0.99999      # 9b: card vs CPU, pooled f32 outputs
GTE_REL_ERR = 1e-4         # 9b: max abs error <= this x max |x|
BUILD_QUESTIONS = 246      # the WebQSP preset's validation split
BUILD_DIR = OUT_DIR / "chip_smoke_build"  # phase 9: logs stay
BUILD_WORK = BUILD_DIR / "work"           # the built dataset, removed when phase 9 ends
BUILT_RANK = 8192          # >= the largest bucket of the built split (edge cap 6144)


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


def per_question_flops(lengths, m: int, d: int, h: int) -> tuple[float, float]:
    """Tensor FLOP of one per-question launch: (as the kernel does it, every
    row of each live tile of 128 edges, zero rows included; as the bound
    counts it, valid edges), [inter|sc|err] @ W1[:3D] in two directions."""
    live = [min(max(int(n), 0), m) for n in lengths]
    per_edge = 2 * 3 * 2 * d * h
    return sum(-(-n // 128) * 128 for n in live) * per_edge, sum(live) * per_edge


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


def pooled_flops(b: int, m: int, d: int, h: int) -> dict[str, tuple[float, float]]:
    """(tensor FLOP as the kernel does it, as the bound counts it) per
    launch.  Kernel 1 runs [inter|sc|err] @ W1[:3D] in two directions per
    (edge, query); kernel 2 runs u @ W1i and r_ctx @ W1e per (edge, query)
    and [sc_f|hmt] @ [W1s; W1e] and [sc_b|-hmt] @ [W1s; W1e] per edge."""
    pairs = b * m
    return {
        "score_bidirectional": (pairs * 2 * 3 * 2 * d * h, pairs * 2 * 2 * 2 * d * h + m * 2 * 2 * d * h),
        "query_topk_fused": (pairs * 2 * 2 * d * h + m * 2 * 2 * 2 * d * h,
                             pairs * 2 * 2 * d * h + m * 3 * 2 * d * h),
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
        done, counted = per_question_flops(lens, m, D, H)
        row = dict(M=m, G=G, valid_edges=int(np.minimum(lens, m).sum()), max_abs_err=max_err,
                   near_tie_swaps=swaps, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   tflops_as_done=done / ms / 1e9, tflops_bound_count=counted / ms / 1e9)
        rows.append(row)
        log(f"[3 kernel] G={G} M={m} valid_edges={row['valid_edges']} max_abs_err={max_err:.3e} "
            f"(tol {ATOL}) near_tie_swaps={swaps} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) bound/ms={bound_ms / ms:.3f} TFLOP/s "
            f"{row['tflops_as_done']:.1f} as done, {row['tflops_bound_count']:.1f} as the bound counts")
        del h, r, t, struct, scores
    from evi_rag_tpu_torch.testing import PQT_DIGEST, pqt_digest

    digest = pqt_digest(dev)
    if digest != PQT_DIGEST:
        raise AssertionError(f"per_question_topk output changed: digest {digest} != {PQT_DIGEST}")
    log(f"[3 kernel] output on the fixed input matches its pinned digest (sha256 {digest[:16]}...)")
    for ln in wgmma_ptxas([sk.KERNEL_SOURCE]):
        log(f"[3 kernel] ptxas {ln}")
    return rows


def phase_serve(bundle_np, num_questions: int):
    import numpy as np
    import torch

    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.serving import project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    t0 = time.perf_counter()
    ds = make_synthetic_dataset(num_samples=num_questions, seed=7, **REALISTIC)
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
    out["_ctx"] = (bundle, ds, kw, results, full)  # phase 11d serves the same split over meshes
    return out


def plain_full_ranking(bundle, q_emb, head_repr, *args, k, weights, width: int = FULL_RANK):
    """The plain version, ranking every candidate instead of the top k
    (padded with -inf to ``width`` slots, so that every bucket shape returns
    the same width); ``serve_split`` then keeps each question's whole
    ranking with its scores."""
    import torch.nn.functional as F

    from evi_rag_tpu_torch.ops import score_kernels as sk

    m = head_repr.shape[1]
    if m > width:
        raise ValueError(f"bucket M={m} > width {width}")
    vals, ids = sk.per_question_topk_reference(bundle, q_emb, head_repr, *args, k=m, weights=weights)
    return (F.pad(vals, (0, width - m), value=float("-inf")),
            F.pad(ids, (0, width - m), value=-1))


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


def pooled_inputs(bundle_np, dev):
    """Phase 6's inputs: the bundle on ``dev``, the bf16 index of POOLED_M
    triples built on the card (and its build seconds), POOLED_B queries and
    the prepared weights."""
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.ops.query import build_triple_index
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

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
    idx = index.to(dtype=torch.bfloat16)  # cast once, as bench.py's index_dtype=bf16
    return bundle, idx, q, sk.prep_weights(bundle["features"]), index_build_s


def phase_pooled(bundle_np):
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk

    dev = torch.device("cuda", torch.cuda.current_device())
    bundle, idx, q, w, index_build_s = pooled_inputs(bundle_np, dev)
    log(f"[6 pooled] index: {POOLED_M} triples over {ENTITIES} entities / {RELATIONS} relations, "
        f"D = {D}, built on the card in index_build_s {index_build_s:.4f}")

    # The main path: counts at 0, a first (warm) pass and 3 timed passes of each engine.
    paths = {"per_query": sk.query_topk_per_query, "fused": sk.query_topk_fused}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_bytes = torch.cuda.memory_allocated(dev)
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
    peak_bytes = torch.cuda.max_memory_allocated(dev)
    log(f"[6 pooled] peak device memory of the pooled passes {peak_bytes / 2**30:.3f} GiB "
        f"({(peak_bytes - base_bytes) / 2**30:.3f} GiB above the index, weights and queries)")
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

    # Times of one launch over all POOLED_B queries (scoring launches and the
    # select apart), and of the plain versions' same work.
    scores_fn = {
        "score_bidirectional": lambda: sk.score_bidirectional(bundle, q, *rows_args, weights=w),
        "query_topk_fused": lambda: sk._pooled_scores(sk.POOLED_SOURCE, "pq_forward", "query_topk_fused",
                                                      bundle, q, rows_args, w, fused=True),
    }
    score_ms = {name: cuda_ms(fn, 2) for name, fn in scores_fn.items()}
    dense = scores_fn["score_bidirectional"]()
    select_ms = cuda_ms(lambda: sk._select(dense, K, "select"), 5)
    del dense
    ms = {"score_bidirectional": score_ms["score_bidirectional"],
          "query_topk_fused": cuda_ms(lambda: sk.query_topk_fused(bundle, q, idx, k=K, weights=w), 2)}
    plain_ms = {
        "score_bidirectional": cuda_ms(
            lambda: sk.score_bidirectional_reference(bundle, q, *rows_args, weights=w), 1),
        "query_topk_fused": cuda_ms(lambda: sk.query_topk_fused_reference(bundle, q, idx, k=K, weights=w), 1),
    }
    bounds = pooled_bounds(POOLED_B, POOLED_M, D, H, S, K)
    flops = pooled_flops(POOLED_B, POOLED_M, D, H)
    tflops = {name: (flops[name][0] / score_ms[name] / 1e9, flops[name][1] / score_ms[name] / 1e9)
              for name in ms}
    log(f"[6 pooled] select over [{POOLED_B}, {POOLED_M}] scores (k = {K}): {select_ms:.3f} ms per launch")
    for name in ms:
        log(f"[6 pooled] {name}: ms {ms[name]:.3f} per launch (B = {POOLED_B}; scoring launches "
            f"{score_ms[name]:.3f}) bound_ms {bounds[name][0]:.3f} ({bounds[name][1]}) "
            f"bound/ms {bounds[name][0] / ms[name]:.3f} plain_ms {plain_ms[name]:.3f}; scoring at "
            f"{tflops[name][0]:.1f} TFLOP/s as done, {tflops[name][1]:.1f} as the bound counts")
    ptxas = wgmma_ptxas([sk.SCORE_SOURCE, sk.POOLED_SOURCE])
    for ln in ptxas:
        log(f"[6 pooled] ptxas {ln}")
    return dict(index_build_s=index_build_s, qps=qps, launches=launches, ms=ms, plain_ms=plain_ms,
                score_ms=score_ms, select_ms=select_ms, tflops=tflops, peak_bytes=peak_bytes,
                bounds=bounds, max_abs_err={"score_bidirectional": max(err1, dense_err),
                                            "query_topk_fused": err2},
                differing_ids={"per_query": diff1, "fused": diff2}, ptxas=ptxas)


def train_flops(edges: int, nodes: int, graphs: int, d: int, h: int) -> float:
    """FLOP of one training step as this script counts it: 3 x the forward's
    matrix products, forward = 2 [3 E D^2 (relation projection, q_gate,
    q_bias) + 2 E ((3D + 1) H + H^2 + 21 D + H) (two directions: state_net_0,
    state_net_1, struct projection and gate, head) + N D^2 (entity
    projection) + G D^2 (query projection)]."""
    fwd = 2 * (3 * edges * d * d + 2 * edges * ((3 * d + 1) * h + h * h + 21 * d + h)
               + nodes * d * d + graphs * d * d)
    return 3.0 * fwd


def phase_train(smi: str):
    """7a: timed training at production width; 7b: one step on the card
    against the CPU; 7c: the train_retriever CLI, then serve on its
    checkpoint through kernel 3."""
    import numpy as np
    import torch

    from evi_rag_tpu_torch.data.feeder import collate_retriever, fixed_bucket_for, iter_stacked_batches, prefetch
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.models.losses import RetrieverLossConfig
    from evi_rag_tpu_torch.models.retriever import Retriever
    from evi_rag_tpu_torch.train.optim import OptimizerConfig
    from evi_rag_tpu_torch.train.retriever_trainer import (
        RetrieverTrainConfig, create_train_state, evaluate_results, make_eval_step, make_train_step)

    dev = torch.device("cuda", torch.cuda.current_device())
    t0 = time.perf_counter()
    train_ds = make_synthetic_dataset(num_samples=TRAIN_QUESTIONS, seed=8, **REALISTIC)
    val_ds = make_synthetic_dataset(num_samples=QUESTIONS, seed=7, **REALISTIC)
    bucket = fixed_bucket_for(list(train_ds.samples) + list(val_ds.samples), TRAIN_BATCH)
    edges = np.array([s.edge_index.shape[1] for s in train_ds.samples])
    log(f"[7a train] splits made in {time.perf_counter() - t0:.1f} s: train {TRAIN_QUESTIONS} questions "
        f"(seed 8, edges median {int(np.median(edges))} max {edges.max()}), validation {QUESTIONS} (seed 7); "
        f"bucket graphs {bucket.graphs} nodes {bucket.nodes} edges {bucket.edges}")
    model = Retriever(emb_dim=D, hidden_dim=H, dropout_p=0.1, compute_dtype="bfloat16", hide_seek_enabled=True,
                      hide_seek_p_near=0.7, hide_seek_p_far=0.1, hide_seek_bias_near=-2.0, hide_seek_bias_far=-0.5)
    cfg = RetrieverTrainConfig(loss=RetrieverLossConfig(infonce_temperature=0.07),
                               optimizer=OptimizerConfig(name="adamw", learning_rate=1e-4), k_values=(10, 100))
    train_tables = make_tables(train_ds.entity_emb, train_ds.relation_emb, device=dev)
    val_tables = make_tables(val_ds.entity_emb, val_ds.relation_emb, device=dev)
    state, tx = create_train_state(model, None, cfg, seed=0, device=dev)
    step_fn = make_train_step(model, tx, cfg, tables=train_tables)
    eval_fn = make_eval_step(model, cfg, tables=val_tables)

    def epoch_batches(epoch: int):
        return prefetch(iter_stacked_batches(
            train_ds.samples, num_shards=1, per_shard_batch=TRAIN_BATCH, entity_emb=train_ds.entity_emb,
            relation_emb=train_ds.relation_emb, question_emb=train_ds.question_emb, bucket=bucket,
            seed=epoch, id_feed=True, pin=True))

    def val_pass():
        torch.cuda.synchronize()
        t = time.perf_counter()
        results, sweeps = [], 0
        for i in range(0, QUESTIONS, TRAIN_BATCH):
            b = collate_retriever(val_ds.samples[i : i + TRAIN_BATCH], entity_emb=val_ds.entity_emb,
                                  relation_emb=val_ds.relation_emb, question_emb=val_ds.question_emb,
                                  bucket=bucket, id_feed=True, pin=True)
            results.append(eval_fn(state.params, b))
            sweeps += results[-1]["cc_sweeps"]
        out = evaluate_results(results)
        return out, time.perf_counter() - t, sweeps

    warm = epoch_batches(100)
    for _ in range(TRAIN_WARMUP):
        state, m = step_fn(state, next(warm))
    torch.cuda.synchronize()
    del warm
    epochs = []
    for epoch in range(2):
        torch.cuda.reset_peak_memory_stats(dev)
        starts, ends, real_e, real_n, walls = [], [], 0, 0, time.perf_counter()
        for batch in epoch_batches(epoch):
            real_e += int(batch.graph.edge_mask.sum())
            real_n += int(batch.graph.node_mask.sum())
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            state, m = step_fn(state, batch)
            e.record()
            starts.append(s)
            ends.append(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - walls
        steps = len(starts)
        ms = float(np.median([a.elapsed_time(b) for a, b in zip(starts, ends)]))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            raise AssertionError(f"epoch {epoch}: loss {loss} grad_norm {gnorm} not finite")
        padded = train_flops(bucket.edges, bucket.nodes, bucket.graphs, D, H)
        real = train_flops(real_e / steps, real_n / steps, TRAIN_BATCH, D, H)
        peak = torch.cuda.max_memory_allocated(dev)
        val, val_s, sweeps = val_pass()
        row = dict(epoch=epoch, steps=steps, step_ms=ms, wall_s=wall, graphs_per_s=steps * TRAIN_BATCH / wall,
                   real_edges_per_s=real_e / wall, padded_edge_share=1 - real_e / (steps * bucket.edges),
                   tflops_padded=padded / ms / 1e9, tflops_real=real / ms / 1e9,
                   bound_ms_padded=padded / PEAK_BF16_FLOPS * 1e3, bound_ms_real=real / PEAK_BF16_FLOPS * 1e3,
                   peak_gib=peak / 2**30, loss=loss, grad_norm=gnorm, val_s=val_s, cc_sweeps=sweeps,
                   reach100=val["answer/reachability@100"], recall100=val["edge/recall@100"])
        epochs.append(row)
        log(f"[7a train] epoch {epoch}: {steps} steps, step ms median {ms:.2f} (CUDA events), "
            f"{row['graphs_per_s']:.1f} graphs/s, {row['real_edges_per_s']:.0f} real edges/s, padded-edge "
            f"share {row['padded_edge_share']:.3f}; TFLOP/s {row['tflops_padded']:.1f} over padded edges "
            f"(bound {row['bound_ms_padded']:.2f} ms at 989 TFLOP/s), {row['tflops_real']:.1f} over real "
            f"edges (bound {row['bound_ms_real']:.2f} ms); peak {row['peak_gib']:.2f} GiB; loss {loss:.4f} "
            f"grad_norm {gnorm:.4f}; validation reachability@100 {row['reach100']:.4f} recall@100 "
            f"{row['recall100']:.4f}, eval pass {val_s:.2f} s ({sweeps} component sweeps)")

    # Steps with remat: activations recomputed in the backward (the first
    # call pays the checkpoint machinery's one-time set-up, off the clock).
    remat_fn = make_train_step(model, tx, dataclasses.replace(cfg, remat=True), tables=train_tables)
    remat_batches = epoch_batches(200)
    state, _ = remat_fn(state, next(remat_batches))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    batch = next(remat_batches)
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    state, m = remat_fn(state, batch)
    e.record()
    torch.cuda.synchronize()
    remat = dict(step_ms=s.elapsed_time(e), peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 loss=float(m["loss"]))
    if not np.isfinite(remat["loss"]):
        raise AssertionError("the remat step's loss is not finite")
    log(f"[7a train] remat step: {remat['step_ms']:.2f} ms (the second remat step), "
        f"peak {remat['peak_gib']:.2f} GiB, loss {remat['loss']:.4f}")
    profile = profile_train(step_fn, state, epoch_batches(300))
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint

    retriever_ckpt = GFN_DIR / "retriever"   # phase 8 evaluates and embeds with it
    save_checkpoint(retriever_ckpt, state.params, meta={"parity_meta": model.parity_meta()})

    # 7b: the card against the CPU.
    from evi_rag_tpu_torch.testing import bf16_card_step, card_vs_cpu_step

    vs = card_vs_cpu_step()  # TF32 is off (phase 1)
    if not (vs["loss_rel"] <= 1e-5 and vs["grad_ratio"] <= 1.0 and vs["param_diff"] <= 1e-6):
        raise AssertionError(f"the card's f32 step differs from the CPU's: {vs}")
    bf = bf16_card_step(D)
    if not (np.isfinite(bf["loss"]) and np.isfinite(bf["grad_norm"]) and bf["grads_finite"]):
        raise AssertionError(f"the bf16 step at D = H = {D} is not finite: {bf}")
    log(f"[7b card vs cpu] f32 step at D = H = 256, 4 questions ({vs['edges']} edges): loss card "
        f"{vs['loss_card']:.7f} cpu {vs['loss_cpu']:.7f} (rel {vs['loss_rel']:.2e}, tol 1e-5); worst gradient "
        f"leaf at {vs['grad_ratio']:.3f} of atol 1e-5 + rtol 1e-3; AdamW on the CPU's gradients: parameters "
        f"within {vs['param_diff']:.2e} (tol 1e-6); bf16 step at D = H = {D}: loss {bf['loss']:.4f} "
        f"grad_norm {bf['grad_norm']:.4f}, finite")

    # 7c: train_retriever on the card, then serve its checkpoint through kernel 3.
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.testing import SMALL_TRAIN_MIN_GAIN, small_train_gain
    from evi_rag_tpu_torch.train.checkpoint import load_checkpoint

    work = OUT_DIR / "chip_smoke_train"
    t = time.perf_counter()
    gain = small_train_gain(ROOT / "configs", work, "cuda")
    train_s = time.perf_counter() - t
    if gain["gain"] <= SMALL_TRAIN_MIN_GAIN:
        raise AssertionError(f"edge/recall@5 rose by {gain['gain']:.4f} <= {SMALL_TRAIN_MIN_GAIN}: {gain}")
    _, best_meta = load_checkpoint(gain["ckpt"] / "best")   # verifies the digests
    _, last_meta = load_checkpoint(gain["ckpt"] / "last")
    if best_meta["params_sha256"] != gain["metrics"]["best_ckpt_sha256"] or not last_meta["has_opt_state"]:
        raise AssertionError("ckpt/best or ckpt/last does not hold what train_retriever reported")
    reset_launches()
    rc = cli.main([
        "serve", "--configs-dir", str(ROOT / "configs"), f"retriever.ckpt={gain['ckpt'] / 'best'}",
        "serve.splits=[validation]", "serve.k=20", "serve.k_values=[1, 10, 20]", "serve.fused_threshold=32",
        "dataset.num_samples=48", "dataset.emb_dim=64", "dataset.max_nodes=16", f"paths.log_dir={work / 'serve'}",
    ])
    serve_launches = sk.per_question_topk.launches
    metrics_files = sorted((work / "serve").glob("**/metrics.json"))
    if rc != 0 or not metrics_files or serve_launches <= 0:
        raise AssertionError(f"serve on the trained checkpoint: rc {rc}, kernel 3 launches {serve_launches}")
    served = json.loads(metrics_files[-1].read_text())
    log(f"[7c cli] train_retriever on the card in {train_s:.1f} s: validation edge/recall@5 "
        f"{gain['before']:.4f} untrained -> {gain['after']:.4f} (gain {gain['gain']:.4f} > "
        f"{SMALL_TRAIN_MIN_GAIN}); ckpt/best and ckpt/last hold their digests; serve on ckpt/best: "
        f"kernel 3 launches {serve_launches}, recall@10 {served['validation/serve/recall@10']:.4f} "
        f"recall@20 {served['validation/serve/recall@20']:.4f}")
    return dict(nvidia_smi=smi, bucket=dataclasses.asdict(bucket), epochs=epochs, remat=remat, profile=profile,
                card_vs_cpu=vs, bf16_step=bf, cli=dict(before=gain["before"], after=gain["after"],
                                                       gain=gain["gain"], seconds=train_s),
                serve=dict(launches=serve_launches, recall=served), retriever_ckpt=str(retriever_ckpt))


def profile_train(step_fn, state, batches, label: str = "7a profile"):
    """Device time by kernel and the busy share of one traced train step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = next(batches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        state, _ = step_fn(state, batch)  # profiler start-up off the clock
        torch.cuda.synchronize()
    batch = next(batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return kernel_summary(prof, wall_ms, label)


def kernel_summary(prof, wall_ms: float, label: str):
    """Device time by kernel, launches and the busy share of a profiled
    train step (printed; None when the profiler saw no kernel)."""
    from torch.autograd import DeviceType

    # Kernels only: the autograd and aten ops that launched them carry the
    # same device time again.
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.key and getattr(ev, "device_type", None) == DeviceType.CUDA:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda x: -x[1])
    if not rows:
        log(f"[{label}] device time: not measured (profiler saw no kernel events)")
        return None
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    log(f"[{label}] one train step: wall {wall_ms:.1f} ms (profiled), device kernel time {busy:.1f} ms in "
        f"{launches} launches, busy share {busy / wall_ms:.3f}")
    for name, ms, n in rows[:12]:
        log(f"[{label}]   {ms:9.3f} ms  x{n:5d}  {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=busy, launches=launches, top=rows[:12])


def realistic_loader():
    """A stand-in for the CLI's ``_load_split`` that returns phase 8's
    realistic splits, each made once: phase 4's validation split (seed 7)
    and phase 7a's train split (seed 8).  The CLI's synthetic source (the
    JAX CLI's too) sets only the generator's sample count, width and node
    cap, so the realistic splits reach the tasks through this loader."""
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset

    made: dict = {}

    def load_split(cfg, split):
        if split not in made:
            seed, n = {"validation": (7, QUESTIONS), "train": (8, TRAIN_QUESTIONS)}[split]
            made[split] = make_synthetic_dataset(num_samples=n, seed=seed, **REALISTIC)
        ds = made[split]
        return ds.samples, ds.entity_emb, ds.relation_emb, ds.question_emb

    return load_split


def gfn_flops(edges: int, nodes: int, graphs: int, h: int, steps: int, rollouts: int) -> float:
    """FLOP of one GFlowNet train step as this script counts it (matrix
    products over the bucket's padded edges): per rollout the policy's
    forward takes 2 E H^2 for edge_base and, in each of the T steps, 2 E H^2
    for each of k, v and the edge half of the edge head (6 T E H^2), and its
    backward twice the forward; the frozen embedder runs once a batch with
    no backward: state_net_0 over [3H + 1] inputs in two directions
    (12 E H^2), q_gate and q_bias in two directions (8 E H^2), state_net_1
    (4 E H^2), the relation projection (2 E H^2) and the entity and query
    projections (2 N H^2 + 2 G H^2)."""
    policy = 3.0 * rollouts * (2 + 6 * steps) * edges * h * h
    return policy + 26.0 * edges * h * h + 2.0 * (nodes + graphs) * h * h


def latest_metrics(log_dir: pathlib.Path) -> dict:
    files = sorted(log_dir.glob("**/metrics.json"))
    if not files:
        raise AssertionError(f"no metrics.json under {log_dir}")
    return json.loads(files[-1].read_text())


def gfn_train_setup(cfg, bundle, tables, dev, seed: int = 0):
    """(modules, train state, train step) of a fresh GFlowNet on ``dev``."""
    import torch

    from evi_rag_tpu_torch.train import gflownet_trainer as gt
    from evi_rag_tpu_torch.train.checkpoint import flatten_tree
    from evi_rag_tpu_torch.train.retriever_trainer import TrainState

    modules = gt.build_modules(cfg)
    params = gt.init_gflownet_params(cfg, modules, seed=seed, device=dev)
    tx = gt.setup_optimizer(cfg.optimizer, flatten_tree(params))
    state = TrainState(params=params, opt_state=tx.init(flatten_tree(params)), step=0,
                       generator=torch.Generator(device=dev).manual_seed(seed + 1))
    return modules, state, gt.make_gfn_train_step(modules, tx, cfg, bundle, tables=tables)


def endless(batches, seed: int):
    """Batches of the epochs seed, seed + 1, ... one after another."""
    while True:
        yield from batches(seed)
        seed += 1


def timed_step(step_fn, state, batch):
    """(state, metrics, ms by CUDA events) of one step."""
    import torch

    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    state, m = step_fn(state, batch)
    e.record()
    torch.cuda.synchronize()
    return state, m, s.elapsed_time(e)


def phase_gflownet(smi: str, retriever_ckpt: str, load_split):
    """8a: eval_retriever at production width writes the g_agent stores;
    8b: timed GFlowNet training on the train store; 8f: sample-then-score
    against the canonical loop and five timed variants; 8c: eval_gflownet
    on the validation store; 8g: the reasoner over the validation store
    (8a-8c, 8f, 8g on the realistic splits of ``load_split``); 8d: one f32
    step on the card against the CPU; 8e: the CLI chain at the small setting
    with the reasoner and a sweep (no kernel lies on these paths)."""
    from unittest import mock

    from evi_rag_tpu_torch import cli

    with mock.patch.object(cli, "_load_split", load_split):
        out = phase_gflownet_realistic(smi, retriever_ckpt)
    out["chain"] = phase_gflownet_chain(str(ROOT / "configs"))
    return out


def phase_gflownet_realistic(smi: str, retriever_ckpt: str):
    """8a-8d (see ``phase_gflownet``)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.feeder import fixed_agent_bucket, prefetch
    from evi_rag_tpu_torch.models.batches import make_tables
    from evi_rag_tpu_torch.testing import gfn_card_vs_cpu_step
    from evi_rag_tpu_torch.train import gflownet_trainer as gt
    from evi_rag_tpu_torch.train.checkpoint import export_retriever_features, load_checkpoint
    from evi_rag_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    configs, art = str(ROOT / "configs"), GFN_WORK / "art"
    # The phase-7a retriever's widths, on the card.
    data = ["device=cuda", f"retriever.model.emb_dim={D}", f"retriever.model.hidden_dim={H}",
            "retriever.model.compute_dtype=bfloat16"]
    out: dict = {"nvidia_smi": smi}

    # 8a: eval_retriever on the validation and the train split.
    for split in ("validation", "train"):
        logs = GFN_DIR / "logs" / f"eval_retriever_{split}"
        t = time.perf_counter()
        rc = cli.main(["eval_retriever", "--configs-dir", configs, *data,
                       f"retriever.ckpt={retriever_ckpt}", f"eval.splits=[{split}]", f"eval.artifacts_dir={art}",
                       f"paths.log_dir={logs}"])
        wall = time.perf_counter() - t
        m = latest_metrics(logs)
        store = art / "g_agent" / split
        if rc != 0 or not (store / "manifest.json").exists() or m.get(f"{split}/num_agent_samples", 0) <= 0 \
                or not (art / "eval_retriever" / f"{split}.manifest.json").exists():
            raise AssertionError(f"eval_retriever on {split}: rc {rc}, metrics {m}")
        row = {k.split("/", 1)[1]: v for k, v in m.items()}
        row.update(wall_s=wall, store_bytes=sum(f.stat().st_size for f in store.iterdir()))
        out[f"eval_retriever_{split}"] = row
        log(f"[8a eval_retriever] {split} ({QUESTIONS} questions, D = H = {D}, bf16, edge_top_k 500, "
            f"node_softmax, start_keep_ratio 0.25): collate_s {row['phase/collate_s']} device_s "
            f"{row['phase/device_s']} artifact_s {row['phase/artifact_s']} (task wall {wall:.1f} s with the split's "
            f"generation); {row['num_agent_samples']} agent samples, store {row['store_bytes']} bytes; "
            f"edge/recall@100 {row['edge/recall@100']:.4f} answer/reachability@100 "
            f"{row['answer/reachability@100']:.4f} answer_recall@100 {row['answer_recall@100']:.4f} "
            f"answer_hit@10 {row['answer_hit@10']:.4f}")

    # 8b: GFlowNet training at production width on the train store.
    cfg = load_config(configs, "train_gflownet", ["experiment=train_gflownet", *data, f"gflownet.hidden_dim={H}",
                                                  f"retriever.ckpt={retriever_ckpt}",
                                                  f"gflownet.g_agent_dir={art / 'g_agent'}"])
    tree, rmeta = load_checkpoint(retriever_ckpt)
    bundle_np = export_retriever_features(tree["params"], rmeta["parity_meta"])
    bundle = gt.bundle_on(bundle_np, dev)
    gcfg = cli._gfn_cfg(cfg, inferred_dim=H)
    samples, batches, emb = cli._agent_batches_fn(cfg, "train", GFN_BATCH, seed=0, id_feed=True, pin=True)
    tables = make_tables(*emb, device=dev)
    bucket = fixed_agent_bucket(samples, GFN_BATCH)
    modules, state, step_fn = gfn_train_setup(gcfg, bundle, tables, dev)
    warm = endless(batches, 100)
    for _ in range(TRAIN_WARMUP):
        state, m = step_fn(state, next(warm))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    starts, ends, losses, real_e, t0 = [], [], [], 0, time.perf_counter()
    for batch in prefetch(batches(0)):
        real_e += int(batch.graph.edge_mask.sum())
        s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s_ev.record()
        state, m = step_fn(state, batch)
        e_ev.record()
        starts.append(s_ev)
        ends.append(e_ev)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(starts)
    ms = float(np.median([a.elapsed_time(b) for a, b in zip(starts, ends)]))
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"8b: non-finite losses {losses}")
    flops = gfn_flops(bucket.edges, bucket.nodes, bucket.graphs, H, gcfg.actor.num_steps, GFN_ROLLOUTS)
    train = dict(samples=len(samples), steps=steps, step_ms=ms, wall_s=wall, graphs_per_s=steps * GFN_BATCH / wall,
                 bucket=dc.asdict(bucket), real_edges_per_step=real_e / steps,
                 padded_edge_share=1 - real_e / (steps * bucket.edges), peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                 tflop_per_step=flops / 1e12, tflops=flops / ms / 1e9, loss_first=losses[0], loss_last=losses[-1],
                 bc_weight=float(m["bc_weight"]), answer_hit=float(m["answer_hit"]))
    log(f"[8b train_gflownet] {len(samples)} train agent samples, batch {GFN_BATCH}, {GFN_ROLLOUTS} rollouts, "
        f"T = {gcfg.actor.num_steps}, hidden {H}, f32 policy, dropout {gcfg.dropout}, bc_weight {gcfg.bc_weight}, "
        f"AdamW {gcfg.optimizer.learning_rate} clip {gcfg.optimizer.grad_clip_norm}; bucket graphs {bucket.graphs} "
        f"nodes {bucket.nodes} edges {bucket.edges} (real {train['real_edges_per_step']:.0f} a step, padded share "
        f"{train['padded_edge_share']:.3f}); {TRAIN_WARMUP} warmup steps, then {steps} steps: step ms median "
        f"{ms:.2f} (CUDA events), {train['graphs_per_s']:.1f} graphs/s, {train['tflop_per_step']:.3f} TFLOP a step "
        f"as counted -> {train['tflops']:.1f} TFLOP/s; peak {train['peak_gib']:.2f} GiB; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}")
    train["profile"] = profile_train(step_fn, state, endless(batches, 300), label="8b profile")
    del warm
    for name, change in (("remat", dict(remat_policy=True)), ("bf16", dict(compute_dtype="bfloat16"))):
        _, st, fn = gfn_train_setup(dc.replace(gcfg, **change), bundle, tables, dev)
        extra = endless(batches, 200)
        st, _ = fn(st, next(extra))  # first call off the clock
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        st, mm, step_ms = timed_step(fn, st, next(extra))
        row = dict(step_ms=step_ms, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, loss=float(mm["loss"]))
        if not np.isfinite(row["loss"]):
            raise AssertionError(f"8b: the {name} step's loss is not finite: {row}")
        train[name] = row
        log(f"[8b train_gflownet] {name} step: {step_ms:.2f} ms, peak {row['peak_gib']:.2f} GiB, loss {row['loss']:.4f}")
        del st, fn, extra
    out["train"] = train
    out["sts"] = phase_sts(gcfg, modules, bundle, batches, tables, dev)
    gfn_ckpt = GFN_WORK / "gfn" / "best"
    cli.save_gflownet_checkpoint(gfn_ckpt, state.params, bundle_np, {
        "parity_meta": rmeta["parity_meta"], "retriever_ckpt_sha256": rmeta.get("params_sha256")}, None)

    # 8c: eval_gflownet on the validation store (10 rollouts), through the
    # CLI for its artifacts, and the eval pass alone for q/s.
    logs = GFN_DIR / "logs" / "eval_gflownet"
    rc = cli.main(["eval_gflownet", "--configs-dir", configs, *data, f"gflownet.hidden_dim={H}",
                   f"gflownet.ckpt={gfn_ckpt}", f"gflownet.g_agent_dir={art / 'g_agent'}",
                   f"gflownet.eval_rollouts={GFN_EVAL_ROLLOUTS}", "eval.splits=[validation]",
                   f"eval.artifacts_dir={art}", f"paths.log_dir={logs}"])
    m = latest_metrics(logs)
    rollouts = art / "eval_gflownet" / "validation.jsonl"
    records = rollouts.read_text().splitlines() if rollouts.exists() else []
    vsamples, vbatches, vemb = cli._agent_batches_fn(cfg, "validation", GFN_BATCH, id_feed=True, pin=True)
    if rc != 0 or len(records) != len(vsamples) or "validation/answer_hit@1" not in m:
        raise AssertionError(f"eval_gflownet: rc {rc}, {len(records)} records for {len(vsamples)} samples, {m}")
    eval_step = gt.make_gfn_eval_step(modules, gcfg, bundle, num_rollouts=GFN_EVAL_ROLLOUTS,
                                      tables=make_tables(*vemb, device=dev))
    gen = torch.Generator(device=dev).manual_seed(7)
    vb = list(vbatches())
    eval_step(state.params, vb[0], gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for b in vb:
        eval_step(state.params, b, gen)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    out["eval"] = dict({k.split("/", 1)[1]: v for k, v in m.items()}, records=len(records), eval_s=eval_s,
                       questions_per_s=len(vsamples) / eval_s, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    log(f"[8c eval_gflownet] validation store ({len(vsamples)} agent samples, {GFN_EVAL_ROLLOUTS} rollouts): "
        f"answer_hit@1 {m['validation/answer_hit@1']:.4f} @10 {m['validation/answer_hit@10']:.4f}, answer_hit_ref@1 "
        f"{m['validation/answer_hit_ref@1']:.4f} @10 {m['validation/answer_hit_ref@10']:.4f}; {len(records)} rollout "
        f"records written; eval pass {eval_s:.2f} s = {out['eval']['questions_per_s']:.1f} q/s, peak "
        f"{out['eval']['peak_gib']:.2f} GiB")

    out["reasoner"] = phase_reasoner_realistic(configs, art)

    # 8d: one f32 step on the card against the CPU (TF32 is off, phase 1).
    vs = gfn_card_vs_cpu_step()
    if vs["zero_grad_leaves"] or not (vs["loss_rel"] <= 1e-5 and vs["grad_ratio"] <= 1.0
                                      and vs["param_diff"] <= 1e-6):
        raise AssertionError(f"the card's f32 GFlowNet step differs from the CPU's: {vs}")
    out["card_vs_cpu"] = vs
    log(f"[8d card vs cpu] f32 GFlowNet step at H = 64, 4 graphs ({vs['edges']} edges), 4 rollouts, parameters "
        f"perturbed (every leaf's gradient non-zero, the smallest leaf's max |g| {vs['min_leaf_grad']:.3e}): loss "
        f"card {vs['loss_card']:.7f} cpu {vs['loss_cpu']:.7f} (rel {vs['loss_rel']:.2e}, tol 1e-5); worst gradient "
        f"leaf at {vs['grad_ratio']:.3f} of atol 1e-5 + rtol 1e-3; AdamW on the CPU's gradients: parameters within "
        f"{vs['param_diff']:.2e} (tol 1e-6)")
    return out


STS_VARIANTS = (("canonical", {}), ("sample-then-score", dict(sample_then_score=True)),
                ("sample-then-score + remat", dict(sample_then_score=True, remat_policy=True)),
                ("sample-then-score + dots", dict(sample_then_score=True, remat_policy="dots")),
                ("canonical + dots", dict(remat_policy="dots")))
STS_TIMED = 5              # 8f: timed steps per variant, after one off the clock


def phase_sts(gcfg, modules, bundle, batches, tables, dev):
    """8f: on 8b's setup, 8b's trained modules and one train batch with one
    set of draws (dropout masks included), the sample-then-score rollout
    held to the canonical loop (``testing.sts_vs_canonical``: equal actions
    or at most one graph at a near tie, rollout outputs within rtol 1e-4 /
    atol 1e-5, the step's loss within rtol 1e-3 / atol 1e-4); then step ms
    (median of ``STS_TIMED`` pipelined steps, CUDA events, as 8b times its
    epoch) and peak memory of five variants on the same batches, and one
    traced sample-then-score step (``utils.profiling.trace``)."""
    import dataclasses as dc

    import numpy as np
    import torch

    from evi_rag_tpu_torch import testing
    from evi_rag_tpu_torch.models.batches import replicate_agent_batch
    from evi_rag_tpu_torch.models.gflownet.actor import make_rollout_draws
    from evi_rag_tpu_torch.train import gflownet_trainer as gt
    from evi_rag_tpu_torch.utils.profiling import trace

    r = gcfg.num_train_rollouts
    batch = gt._prepare(next(batches(0)), dev, tables)
    draws = make_rollout_draws(gcfg.actor, replicate_agent_batch(batch, r), hidden_dim=H, dropout=gcfg.dropout,
                               train=True, sample=True, generator=torch.Generator(device=dev).manual_seed(11))
    res = testing.sts_vs_canonical(gcfg, modules, bundle, batch, draws, bc_weight=gcfg.bc_weight)
    del draws
    bad = [d for d in res["differing"] if not d["near_tie"]]
    if bad or len(res["differing"]) > 1 or max(res["ratios"].values()) > 1.0 or res["loss_ratio"] > 1.0:
        raise AssertionError(f"8f: sample-then-score differs from the canonical loop: {res}")
    log(f"[8f sts] sample-then-score vs canonical on one train batch ({res['graphs']} graphs = {GFN_BATCH} x {r} "
        f"rollouts, {res['acting_steps']} acting steps, dropout {gcfg.dropout}, one set of draws): "
        f"{len(res['differing'])} graphs differ " + (f"{res['differing']} " if res["differing"] else "")
        + "; worst ratio to rtol 1e-4 / atol 1e-5: " + ", ".join(f"{k} {v:.3f}" for k, v in res["ratios"].items())
        + f"; loss canonical {res['loss_canonical']:.6f} sts {res['loss_sts']:.6f} (ratio to rtol 1e-3 / atol "
        f"1e-4: {res['loss_ratio']:.3f})")

    rows = {}
    for name, change in STS_VARIANTS:
        _, st, fn = gfn_train_setup(dc.replace(gcfg, **change), bundle, tables, dev)
        it = endless(batches, 400)  # the same batches for every variant
        st, _ = fn(st, next(it))  # first call off the clock
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        events, losses = [], []
        for _ in range(STS_TIMED):  # pipelined as 8b's epoch: one sync after the last step
            s_ev, e_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s_ev.record()
            st, m = fn(st, next(it))
            e_ev.record()
            events.append((s_ev, e_ev))
            losses.append(m["loss"])
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in events]
        losses = [float(x) for x in losses]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"8f {name}: non-finite losses {losses}")
        rows[name] = dict(step_ms=float(np.median(times)), step_ms_all=times,
                          peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30, losses=losses)
        if name == "sample-then-score":
            t0 = time.perf_counter()
            with trace(GFN_WORK / "sts_trace") as prof:
                st, _ = fn(st, next(it))
            prof_row = kernel_summary(prof, (time.perf_counter() - t0) * 1e3, "8f sts profile")
            rows[name]["profile"] = prof_row
            if prof_row:
                log(f"[8f sts profile] device kernel time / pipelined step ms: "
                    f"{prof_row['device_ms'] / rows[name]['step_ms']:.3f} (busy share without the profiler)")
        del st, fn, it
    log("[8f sts] step ms (median of " + f"{STS_TIMED} pipelined steps, CUDA events) and peak: " + "; ".join(
        f"{n} {v['step_ms']:.2f} ms {v['peak_gib']:.2f} GiB" for n, v in rows.items()))
    return dict(check=res, variants=rows)


def phase_reasoner_realistic(configs: str, art: pathlib.Path):
    """8g: the reasoner over 8a's validation store (``QUESTIONS``
    questions) with ``configs/reasoner/ollama.yaml``'s window grid: the
    oracle, then the mock LLM over triplets; records, records/s and the
    share of the task's time spent in ``count_tokens``."""
    from unittest import mock

    import yaml

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.eval import reasoner
    from evi_rag_tpu_torch.eval.artifacts import load_agent_store

    rule = offline_token_rule()
    samples = len(load_agent_store(art / "g_agent" / "validation"))  # oracle mode: one record a sample
    grid = yaml.safe_load((ROOT / "configs" / "reasoner" / "ollama.yaml").read_text())["window_k"]
    store = [f"eval.artifacts_dir={art}", f"gflownet.g_agent_dir={art / 'g_agent'}", "eval.splits=[validation]"]
    spent = {"s": 0.0, "calls": 0}
    count = reasoner.count_tokens

    def timed_count(text, **kw):
        t = time.perf_counter()
        try:
            return count(text, **kw)
        finally:
            spent["s"] += time.perf_counter() - t
            spent["calls"] += 1

    out = {}
    for name, overrides in (("oracle", ["experiment=reasoner_oracle"]),
                            ("mock triplets", ["reasoner=mock", f"reasoner.window_k={json.dumps(grid)}"])):
        logs = GFN_DIR / "logs" / f"reasoner_{name.replace(' ', '_')}"
        spent.update(s=0.0, calls=0)
        t = time.perf_counter()
        with mock.patch.object(reasoner, "count_tokens", timed_count):
            rc = cli.main(["reasoner", "--configs-dir", configs, *store, *overrides, f"paths.log_dir={logs}"])
        wall = time.perf_counter() - t
        m = latest_metrics(logs)
        records = int(m["validation/results/total"]) if name != "oracle" else samples
        if rc != 0 or records <= 0:
            raise AssertionError(f"8g reasoner {name}: rc {rc}, {records} records, {m}")
        out[name] = dict(records=records, wall_s=wall, records_per_s=records / wall, count_tokens_s=spent["s"],
                         count_tokens_calls=spent["calls"], count_tokens_share=spent["s"] / wall)
        log(f"[8g reasoner] {name} over the validation store ({samples} agent samples"
            + (f", windows {grid}" if name != "oracle" else "") + f"): {records} records in {wall:.2f} s = "
            f"{records / wall:.1f} records/s; count_tokens {spent['calls']} calls, {spent['s']:.3f} s "
            f"({spent['s'] / wall:.3f} of the task); rule {rule}")
    return out


def phase_gflownet_chain(configs: str):
    """8e: train_retriever -> eval_retriever (validation, train) ->
    train_gflownet -> eval_gflownet through the CLI on the card at the small
    setting; then 6 GFlowNet steps on one fixed train batch, with one fixed
    set of rollout draws, must lower the loss."""
    import dataclasses as dc

    import numpy as np

    import torch

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.models.batches import make_tables, replicate_agent_batch
    from evi_rag_tpu_torch.models.gflownet.actor import make_rollout_draws
    from evi_rag_tpu_torch.ops.graph import batch_to
    from evi_rag_tpu_torch.train import gflownet_trainer as gt
    from evi_rag_tpu_torch.train.checkpoint import export_retriever_features, load_checkpoint
    from evi_rag_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    small = GFN_WORK / "small"
    art, ck = small / "art", small / "ckpt"
    common = ["experiment=quick_synthetic", "device=cuda", f"eval.artifacts_dir={art}",
              f"gflownet.g_agent_dir={art / 'g_agent'}"]
    stages = [
        ("train_retriever", [f"retriever.train.ckpt_dir={ck / 'r'}"], [ck / "r" / "best" / "meta.json"]),
        ("eval_retriever", [f"retriever.ckpt={ck / 'r' / 'best'}", "eval.splits=[validation]",
                            "eval.g_agent.edge_top_k=50"],
         [art / "g_agent" / "validation" / "manifest.json", art / "eval_retriever" / "validation.manifest.json"]),
        ("eval_retriever", [f"retriever.ckpt={ck / 'r' / 'best'}", "eval.splits=[train]", "eval.g_agent.edge_top_k=50"],
         [art / "g_agent" / "train" / "manifest.json", art / "eval_retriever" / "train.manifest.json"]),
        # 9e: the BFS chain baseline over the validation agent store.
        ("bfs_chains", ["eval.splits=[validation]"], [art / "eval_bfs" / "validation.manifest.json",
                                                      art / "eval_bfs" / "validation.jsonl"]),
        ("train_gflownet", [f"retriever.ckpt={ck / 'r' / 'best'}", f"gflownet.ckpt_dir={ck / 'g'}"],
         [ck / "g" / "best" / "meta.json"]),
        ("eval_gflownet", [f"gflownet.ckpt={ck / 'g' / 'best'}", "eval.splits=[validation]"],
         [art / "eval_gflownet" / "validation.manifest.json"]),
    ]
    rows = []
    for i, (task, overrides, outputs) in enumerate(stages):
        t = time.perf_counter()
        rc = cli.main([task, "--configs-dir", configs, *common, *overrides, f"paths.log_dir={GFN_DIR / 'logs' / str(i)}"])
        missing = [str(p) for p in outputs if not p.exists()]
        if rc != 0 or missing:
            raise AssertionError(f"8e {task}: rc {rc}, missing {missing}")
        rows.append(dict(task=task, seconds=time.perf_counter() - t, metrics=latest_metrics(GFN_DIR / "logs" / str(i))))
    cfg = load_config(configs, "train_gflownet", [*common, f"retriever.ckpt={ck / 'r' / 'best'}"])
    tree, rmeta = load_checkpoint(ck / "r" / "best")
    bundle = gt.bundle_on(export_retriever_features(tree["params"], rmeta["parity_meta"]), dev)
    gcfg = cli._gfn_cfg(cfg, inferred_dim=int(bundle["features"]["q_gate"]["kernel"].shape[0]))
    gcfg = dc.replace(gcfg, max_steps=2, num_train_rollouts=2, total_steps=50, dropout=0.0,
                      optimizer=dc.replace(gcfg.optimizer, learning_rate=1e-3))
    _, batches, emb = cli._agent_batches_fn(cfg, "train", 4, id_feed=True)
    batch = batch_to(next(batches(0)), dev)
    _, state, step_fn = gfn_train_setup(gcfg, bundle, make_tables(*emb, device=dev), dev)
    # One fixed set of draws: the rollouts then change only as the policy
    # does, and the sampling noise of 2 rollouts does not hide the trend.
    draws = make_rollout_draws(gcfg.actor, replicate_agent_batch(batch, gcfg.num_train_rollouts),
                               hidden_dim=gcfg.hidden_dim, dropout=0.0, train=True, sample=True,
                               generator=torch.Generator(device=dev).manual_seed(0))
    losses = []
    for _ in range(6):
        state, m = step_fn(state, batch, draws=draws)
        losses.append(float(m["loss"]))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"8e: the GFlowNet loss on one fixed batch did not fall: {losses}")
    bfs = next(r for r in rows if r["task"] == "bfs_chains")
    log(f"[9e bfs_chains] in the chain after eval_retriever: exit 0 in {bfs['seconds']:.1f} s, "
        f"{bfs['metrics']['validation/num_samples']} samples, eval_bfs/validation.jsonl and its manifest written")
    hit = rows[-1]["metrics"]["validation/answer_hit@1"]
    log(f"[8e cli chain] " + ", ".join(f"{r['task']} {r['seconds']:.1f} s" for r in rows)
        + f" (exit 0, manifests written); eval_gflownet answer_hit@1 {hit:.4f}; 6 steps on one fixed batch: loss "
        + " -> ".join(f"{x:.4f}" for x in losses))
    return dict(stages=rows, losses=losses, reasoner_sweep=phase_reasoner_sweep_chain(configs, common, art, ck))


def numpy_oracle(samples, ks) -> dict:
    """The oracle reasoner's metrics, recomputed with a plain loop: per
    sample the edges ranked by score (stable), an answer found at k when it
    is the head or tail of one of the top k edges; hit@k and recall@k
    averaged over the samples."""
    import numpy as np

    per = {f"answer_{m}@{k}": [] for m in ("hit", "recall") for k in ks}
    for s in samples:
        order = np.argsort(-s.edge_scores, kind="stable")
        heads = s.node_entity_ids[s.edge_head_locals[order]].tolist()
        tails = s.node_entity_ids[s.edge_tail_locals[order]].tolist()
        answers = set(int(a) for a in s.answer_entity_ids)
        for k in ks:
            seen = set(heads[:k]) | set(tails[:k])
            found = len(answers & seen) if heads and answers else 0
            per[f"answer_hit@{k}"].append(1.0 if found else 0.0)
            per[f"answer_recall@{k}"].append(found / len(answers) if answers and heads else 0.0)
    return {k: float(np.mean(v)) for k, v in per.items()}


def ollama_stub():
    """A stub of Ollama's ``/api/chat`` on 127.0.0.1 (a thread of this
    process): it records each request and answers with one fixed JSON
    answer list; ``(url, requests, server)``, the caller shuts it down."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    seen: list = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):  # noqa: N802 (http.server API)
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            seen.append((self.path, body))
            payload = json.dumps({"message": {"role": "assistant", "content": '{"answers": ["1"]}'}}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}", seen, srv


def offline_token_rule() -> str:
    """``count_tokens``' rule on this machine: tiktoken needs its encoding
    file, which it would fetch over the network; with no network the rule
    is ``len // 4``, so an installed tiktoken is kept from trying."""
    import importlib.util

    from evi_rag_tpu_torch.eval import prompting

    if "tiktoken" in sys.modules and sys.modules["tiktoken"] is None or importlib.util.find_spec("tiktoken"):
        sys.modules["tiktoken"] = None  # an import now fails: no download is attempted
        prompting.token_encoding.cache_clear()
        return "len // 4 (tiktoken installed, kept from fetching its encoding file)"
    return "len // 4 (tiktoken not installed)"


def phase_reasoner_sweep_chain(configs: str, common: list, art: pathlib.Path, ck: pathlib.Path):
    """8e, after eval_gflownet: the reasoner over the chain's validation
    store (oracle, held to ``numpy_oracle``; the mock LLM over triplets, over
    eval_gflownet's rollouts and over eval_bfs's chains; ollama against a
    stub on 127.0.0.1), then ``sweep=gflownet_tpe`` with 2 trials on the
    chain's retriever, each of which must end ``ok``."""
    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.eval.artifacts import load_agent_store

    rule = offline_token_rule()
    store = [f"eval.artifacts_dir={art}", f"gflownet.g_agent_dir={art / 'g_agent'}", "eval.splits=[validation]"]
    preds = art / "reasoner" / "validation.jsonl"
    url, seen, srv = ollama_stub()
    runs = [
        ("oracle", ["experiment=reasoner_oracle"]),
        ("mock triplets", ["reasoner=mock"]),
        ("mock paths (eval_gflownet)", ["experiment=reasoner_paths", "reasoner=mock"]),
        ("mock paths (eval_bfs)", ["experiment=reasoner_bfs_paths", "reasoner=mock",
                                   f"reasoner.chains_dir={art / 'eval_bfs'}"]),
        ("ollama (stub)", ["reasoner=ollama", f"reasoner.ollama_base_url={url}", "reasoner.window_k=[1,10]"]),
    ]
    rows = []
    try:
        for i, (name, overrides) in enumerate(runs):
            logs = GFN_DIR / "logs" / f"reasoner_{i}"
            preds.unlink(missing_ok=True)
            t = time.perf_counter()
            rc = cli.main(["reasoner", "--configs-dir", configs, *store, *overrides, f"paths.log_dir={logs}"])
            m = latest_metrics(logs)
            if rc != 0:
                raise AssertionError(f"8e reasoner {name}: rc {rc}")
            if name == "oracle":
                want = numpy_oracle(load_agent_store(art / "g_agent" / "validation"), (1, 10, 25, 50, 100))
                got = {k.split("/", 1)[1]: v for k, v in m.items()}
                if got.keys() != want.keys() or any(abs(got[k] - want[k]) > 1e-12 for k in want):
                    raise AssertionError(f"8e reasoner oracle: {got} vs numpy {want}")
            elif not (preds.exists() and pathlib.Path(str(preds) + ".metrics.json").exists()
                      and m["validation/results/total"] == len(preds.read_text().splitlines()) > 0):
                raise AssertionError(f"8e reasoner {name}: no predictions or metrics ({m})")
            rows.append(dict(run=name, seconds=time.perf_counter() - t, metrics=m))
    finally:
        srv.shutdown()
        srv.server_close()
    if not seen or any(path != "/api/chat" or body["stream"] is not False for path, body in seen):
        raise AssertionError(f"8e reasoner ollama: {len(seen)} requests to the stub")
    log("[8e reasoner] " + "; ".join(
        f"{r['run']} {r['seconds']:.1f} s" + (f" answer_hit@10 {r['metrics']['validation/answer_hit@10']:.4f}"
                                             if r["run"] == "oracle" else
                                             f" {int(r['metrics']['validation/results/total'])} records, hit "
                                             f"{r['metrics']['validation/results/hit']:.4f}") for r in rows)
        + f" (oracle equal to numpy's; {len(seen)} requests to the stub /api/chat; count_tokens rule: {rule})")

    logs = GFN_DIR / "logs" / "sweep"
    t = time.perf_counter()
    rc = cli.main(["sweep", "--configs-dir", configs, *common, "sweep=gflownet_tpe", "sweep.num_trials=2",
                   f"retriever.ckpt={ck / 'r' / 'best'}", f"paths.log_dir={logs}"])
    (doc_path,) = sorted(logs.glob("**/sweep.json"))
    doc = json.loads(doc_path.read_text())
    statuses = [tr["status"] for tr in doc["trials"]]
    if rc != 0 or statuses != ["ok", "ok"]:
        raise AssertionError(f"8e sweep: rc {rc}, trials {[(tr['status'], tr.get('error')) for tr in doc['trials']]}")
    if not all((doc_path.parent / f"trial_{i}" / "ckpt" / "best" / "meta.json").exists() for i in range(2)):
        raise AssertionError("8e sweep: a trial wrote no ckpt/best")
    sweep = dict(seconds=time.perf_counter() - t, trials=[dict(overrides=tr["overrides"], score=tr["score"])
                                                         for tr in doc["trials"]])
    log(f"[8e sweep] sweep=gflownet_tpe, 2 trials of train_gflownet on the chain's retriever in "
        f"{sweep['seconds']:.1f} s, both ok: " + "; ".join(
            f"lr {tr['overrides']['gflownet.optimizer.learning_rate']:.3g} bc {tr['overrides']['gflownet.bc_weight']} "
            f"T {tr['overrides']['gflownet.policy_temperature']:.3f} -> best_score {tr['score']:.4f}"
            for tr in doc["trials"]))
    return dict(reasoner=rows, sweep=sweep, token_rule=rule)


def phase_native():
    """9a: ``csrc/graphcore.cpp`` built with g++ here and held to the numpy
    engine on the random graphs of ``tests/test_native_graphcore.py``, in
    both path modes (mask, pairs, on-path edge ids in order, counts,
    lengths), and its BFS distances to numpy's."""
    import numpy as np

    from evi_rag_tpu_torch.data import bfs_label, native
    from evi_rag_tpu_torch.ops import _build

    found = _build.host_library_path(native.SOURCE).exists()
    t0 = time.perf_counter()
    if native.load_library() is None:
        raise AssertionError(f"g++ could not build csrc/graphcore.cpp: {_build.BUILD_LOG.get(native.SOURCE)}")
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(42)
    cases = 0
    for mode in ("undirected", "qa_directed"):
        for _ in range(12):
            n, e = 40, 120
            src, dst = rng.integers(0, n, size=e), rng.integers(0, n, size=e)
            src[rng.random(e) < 0.02] = -1
            dst[rng.random(e) < 0.02] = n + 5
            case = dict(num_nodes=n, edge_src=src, edge_dst=dst, sources=rng.integers(0, n, size=2),
                        targets=rng.integers(0, n, size=3))
            want = bfs_label.shortest_path_union_by_pair(path_mode=mode, **case)
            got = native.shortest_path_union_by_pair_native(path_mode=mode, **case)
            if not (np.array_equal(got[0], want[0]) and list(got[1:]) == list(want[1:])):
                raise AssertionError(f"native BFS engine differs from numpy ({mode}): {got} vs {want}")
            seeds = case["sources"]
            if not np.array_equal(native.bfs_dist(n, src, dst, seeds, undirected=mode == "undirected"),
                                  bfs_label.bfs_dist(n, *bfs_label.build_csr(n, src, dst, undirected=mode == "undirected"),
                                                     seeds)):
                raise AssertionError(f"native bfs_dist differs from numpy ({mode})")
            cases += 1
    how = "found built" if found else f"built with g++ in {build_s:.2f} s"
    log(f"[9a native] graphcore {how}; {cases} random graphs (both path modes) equal to the numpy engine, "
        f"edge ids in order, and BFS distances equal")
    return dict(build_s=None if found else build_s, cases=cases)


def gte_probe():
    """8 rows of 64 token ids: [CLS] ids [SEP] with ragged lengths, the
    last row [CLS] [SEP] only, the rest padding."""
    import numpy as np

    rng = np.random.default_rng(29)
    ids = np.zeros((8, GTE_LEN), np.int64)
    mask = np.zeros((8, GTE_LEN), np.int64)
    for row, n in enumerate((64, 50, 33, 17, 9, 5, 3, 2)):
        ids[row, :n] = rng.integers(5, GTE["vocab_size"], size=n)
        ids[row, 0], ids[row, n - 1] = 2, 3
        mask[row, :n] = 1
    return ids, mask


def phase_gte():
    """9b: gte-large at its published geometry with seeded random weights,
    on the card (TF32 off) against the CPU on ``gte_probe``'s rows: the
    pooled f32 outputs' min cosine and max abs error.  Returns the card's
    model for 9c."""
    import numpy as np
    import torch

    from evi_rag_tpu_torch.data.gte import GTEConfig, GTEModel, mean_pool
    from evi_rag_tpu_torch.testing import random_gte_state

    cfg = GTEConfig(**GTE)
    t0 = time.perf_counter()
    state = random_gte_state(cfg, seed=23)
    params = sum(v.numel() for v in state.values())
    made_s = time.perf_counter() - t0
    card = GTEModel.from_state_dict(state, cfg, device="cuda")
    cpu = GTEModel.from_state_dict(state, cfg, device="cpu")  # shares the state's memory
    del state
    ids, mask = gte_probe()
    out = {}
    for name, model in (("cpu", cpu), ("cuda", card)):
        dev = torch.device(name)
        with torch.inference_mode():
            i, m = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
            t = time.perf_counter()
            out[name] = mean_pool(model(i, m), m).cpu().numpy()
            out[f"{name}_s"] = time.perf_counter() - t
    del cpu
    a, b = out["cpu"].astype(np.float64), out["cuda"].astype(np.float64)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    err, scale = float(np.abs(a - b).max()), float(np.abs(a).max())
    finite = bool(np.isfinite(b).all())
    log(f"[9b gte] gte-large geometry ({cfg.num_hidden_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, gated MLP {cfg.intermediate_size}, vocab {cfg.vocab_size}), "
        f"{params / 1e6:.1f} M parameters made from seed 23 in {made_s:.1f} s; 8 rows x {GTE_LEN} tokens "
        f"(real {mask.sum(1).tolist()}): card vs CPU min cosine {cos.min():.8f} (bar {GTE_COS_MIN}), max abs error "
        f"{err:.3e} = {err / scale:.3e} x max |x| {scale:.4f} (bar {GTE_REL_ERR}); CPU forward {out['cpu_s']:.2f} s")
    if not finite or cos.min() < GTE_COS_MIN or err > GTE_REL_ERR * scale:
        raise AssertionError(f"9b: gte on the card differs from the CPU: min cosine {cos.min()}, max abs error {err}")
    return card, dict(params=params, min_cos=float(cos.min()), max_abs_err=err, max_abs=scale,
                      rel_err=err / scale, cpu_s=out["cpu_s"])


def phase_build_data(smi: str, retriever_ckpt: str):
    """9b-9d: gte on the card against the CPU, the build of the WebQSP
    preset's validation split with the full-width gte encoder, then
    ``seed_stats`` and ``serve`` (kernel 3) on the built split."""
    model, gte = phase_gte()
    out = {"nvidia_smi": smi, "gte": gte}
    out.update(phase_build_split(model, smi))
    del model
    out.update(phase_built_serve(retriever_ckpt))
    shutil.rmtree(BUILD_WORK)  # ~200 MB of embeddings and stores
    return out


def phase_build_split(model, smi: str):
    """9c: the WebQSP preset's validation split (seed 0; pool 120,000
    entities, 600 relations, log-normal edges, cap 6,144) through the port's
    build passes 1-4 with the full-width gte encoder (stand-in tokenizer,
    max_length 64, batch 256) and the native BFS engine."""
    import numpy as np
    import torch

    from evi_rag_tpu_torch.data import native
    from evi_rag_tpu_torch.data.gte import GTETextEncoder
    from evi_rag_tpu_torch.data.pipeline import PipelineConfig, TextEntityPolicy, build_from_samples, read_raw_rows
    from evi_rag_tpu_torch.testing import HashTokenizer, synthetic_rows

    t0 = time.perf_counter()
    tables = list(synthetic_rows("webqsp", seed=0, counts={"train": 0, "validation": BUILD_QUESTIONS, "test": 0}))
    rows = tables[0][1]
    edges = np.array([len(r["graph"]) for r in rows])
    log(f"[9c build] WebQSP preset validation split (seed 0): {len(rows)} questions, triples median "
        f"{int(np.median(edges))} max {edges.max()} total {edges.sum()}, made in {time.perf_counter() - t0:.1f} s")
    encoder = GTETextEncoder.from_model(model, HashTokenizer(GTE["vocab_size"]), max_length=GTE_LEN)
    # One timed 256 x 64 batch alone (CUDA events): the model without the host.
    ids = torch.randint(5, GTE["vocab_size"], (GTE_BATCH, GTE_LEN), device="cuda")
    mask = torch.ones_like(ids)
    with torch.inference_mode():
        batch_ms = cuda_ms(lambda: model(ids, mask), 3)
        profile = profile_encode(model, ids, mask)
    cfg = PipelineConfig(dataset="webqsp_synth", raw_root="", out_dir=str(BUILD_WORK / "normalized"),
                         text_policy=TextEntityPolicy(mode="regex", match_regex=r"^(?!m\.|g\.).*"),
                         encode_batch_size=GTE_BATCH)
    native.best_shortest_path_union.runs.update(native=0, numpy=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, _ = build_from_samples(cfg, encoder, read_raw_rows(tables, "webqsp_synth"))
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    engines = dict(native.best_shortest_path_union.runs)
    if engines["native"] == 0 or engines["numpy"] != 0:
        raise AssertionError(f"9c: the BFS labels did not all come from the native engine: {engines}")
    st = encoder.stats
    flops = st["padded_tokens"] * GTE_FLOP_PER_TOKEN
    enc_s = res.phase_s["encode_s"]
    tflops = flops / enc_s / 1e12
    share = flops / PEAK_F32_FLOPS / enc_s
    root = pathlib.Path(cfg.out_dir)
    store_bytes = sum(f.stat().st_size for f in (root / "materialized").rglob("*") if f.is_file())
    emb_bytes = sum(f.stat().st_size for f in (root / "embeddings").glob("*.npy"))
    if st["texts"] != sum(res.num_texts.values()):
        raise AssertionError(f"9c: {st['texts']} texts encoded, {res.num_texts} expected")
    ent = np.load(root / "embeddings" / "entity_embeddings.npy", mmap_mode="r")
    if ent.shape != (res.num_text_entities + 1, GTE["hidden_size"]) or not np.isfinite(ent[1:]).all():
        raise AssertionError(f"9c: entity embeddings {ent.shape} or not finite")
    batch_tflops = GTE_BATCH * GTE_LEN * GTE_FLOP_PER_TOKEN / batch_ms / 1e9
    log(f"[9c build] texts encoded {res.num_texts} = {st['texts']} in {st['batches']} batches of {GTE_BATCH} x "
        f"{GTE_LEN}; tokens real {st['real_tokens']} of {st['padded_tokens']} padded (real share "
        f"{st['real_tokens'] / st['padded_tokens']:.4f})")
    log(f"[9c build] encode {enc_s:.2f} s: {st['texts'] / enc_s:.1f} texts/s, {tflops:.2f} TFLOP/s as counted "
        f"({GTE_FLOP_PER_TOKEN / 1e6:.1f} MFLOP a padded token), {share:.4f} of the f32 bound "
        f"({PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s, TF32 off); one 256 x 64 batch alone {batch_ms:.2f} ms "
        f"({batch_tflops:.2f} TFLOP/s, bound {GTE_BATCH * GTE_LEN * GTE_FLOP_PER_TOKEN / PEAK_F32_FLOPS * 1e3:.1f} ms)")
    log(f"[9c build] graph pass + stores {res.phase_s['graph_s']:.2f} s, BFS engine runs {engines}; "
        f"{res.counts['kept']} kept, {res.counts['sub']} sub; stores {store_bytes} bytes, embeddings "
        f"{emb_bytes} bytes; peak device memory {peak / 2**30:.3f} GiB; build wall {wall_s:.1f} s; {smi}")
    return {"build": dict(num_texts=res.num_texts, stats=dict(st), encode_s=enc_s, texts_per_s=st["texts"] / enc_s,
                          tflops=tflops, f32_bound_share=share, batch_ms=batch_ms, batch_tflops=batch_tflops,
                          real_share=st["real_tokens"] / st["padded_tokens"], graph_s=res.phase_s["graph_s"],
                          engines=engines, counts=res.counts, store_bytes=store_bytes, emb_bytes=emb_bytes,
                          peak_gib=peak / 2**30, wall_s=wall_s, num_entities=res.num_entities, profile=profile,
                          num_text_entities=res.num_text_entities)}


def profile_encode(model, ids, mask):
    """Device time by kernel and the busy share of one traced 256 x 64
    gte batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        model(ids, mask)  # profiler start-up off the clock
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(ids, mask)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.key and not ev.key.startswith(("cuda", "aten::")):
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda x: -x[1])
    if not rows:
        log("[9c profile] device time: not measured (profiler saw no device events)")
        return None
    busy = sum(r[1] for r in rows)
    log(f"[9c profile] one 256 x 64 batch: wall {wall_ms:.1f} ms (profiled), device kernel time {busy:.1f} ms, "
        f"busy share {busy / wall_ms:.3f}")
    for name, ms, n in rows[:10]:
        log(f"[9c profile]   {ms:9.3f} ms  x{n:4d}  {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=busy, top=rows[:10])


def phase_built_serve(retriever_ckpt: str):
    """9d: ``seed_stats`` through the CLI on the built split, then ``serve``
    of it with phase 7a's D = 1024 retriever through kernel 3, held to the
    plain-version serve by phase 4's rule."""
    import numpy as np

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.pipeline import load_retrieval_split

    root = BUILD_WORK / "normalized"
    rc = cli.main(["seed_stats", "--configs-dir", str(ROOT / "configs"), "dataset.source=normalized",
                   f"dataset.normalized_dir={root}", "eval.splits=[validation]",
                   f"paths.log_dir={BUILD_DIR / 'logs'}"])
    stats = latest_metrics(BUILD_DIR / "logs")
    if rc != 0 or not all(np.isfinite(v) for v in stats.values()) or "validation/onehop_edges/mean" not in stats:
        raise AssertionError(f"9d seed_stats: rc {rc}, metrics {stats}")
    log(f"[9d seed_stats] on the built split: " + ", ".join(f"{k.split('/', 1)[1]} {v:.4g}" for k, v in stats.items()))

    samples, q_emb = load_retrieval_split(root, "validation")
    ent = np.load(root / "embeddings" / "entity_embeddings.npy")
    rel = np.load(root / "embeddings" / "relation_embeddings.npy")
    return {"seed_stats": stats, "serve": serve_against_plain("9d serve", retriever_ckpt, samples, ent, rel, q_emb,
                                                             BUILT_RANK)}


def serve_against_plain(label: str, retriever_ckpt, samples, ent, rel, q_emb, width: int) -> dict:
    """``serve_split`` of a split with a retriever checkpoint through kernel
    3 (launches counted from 0 over one warm pass), held to the plain-version
    serve by phase 4's rule (``width`` >= the largest bucket)."""
    import collections
    import functools

    import numpy as np

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.serving import _pow2_at_least, project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, export_retriever_features, load_checkpoint

    tree, meta = load_checkpoint(retriever_ckpt)
    exported = export_retriever_features(tree["params"], meta["parity_meta"])
    bundle = {"features": bundle_from_numpy(exported["features"], device="cuda")}
    projected = project_tables(bundle, ent, rel, device="cuda")
    kw = dict(entity_emb=ent, relation_emb=rel, question_emb=q_emb, k=K, num_rounds=2, num_reverse_rounds=2,
              projected=projected, device="cuda")
    serve_split(bundle, samples, **kw)  # warm
    reset_launches()
    results, st = serve_split(bundle, samples, **kw)
    launches = sk.per_question_topk.launches
    if launches == 0:
        raise AssertionError(f"{label}: serve never launched kernel 3")
    order = sorted(samples, key=lambda s: s.edge_index.shape[1])
    buckets = collections.Counter(
        max(_pow2_at_least(max(s.edge_index.shape[1] for s in g)), _pow2_at_least(K),
            _pow2_at_least(max(s.num_nodes for s in g) + 1))
        for g in (order[i : i + 16] for i in range(0, len(order), 16)))
    full, _ = serve_split(bundle, samples, fused_fn=functools.partial(plain_full_ranking, width=width), **kw)
    plain, swapped, max_err = check_against_plain(samples, results, full)
    rec_k = serve_recall_at_k(samples, results, [10, 100])
    rec_p = serve_recall_at_k(samples, plain, [10, 100])
    slack = swapped / len(samples)
    for key in rec_k:
        if abs(rec_k[key] - rec_p[key]) > slack:
            raise AssertionError(f"{label} {key}: kernel {rec_k[key]} vs plain {rec_p[key]} (slack {slack})")
    edges = np.array([s.edge_index.shape[1] for s in samples])
    log(f"[{label}] {len(samples)} questions, edges median {int(np.median(edges))} max {edges.max()}; "
        f"buckets (M: groups of 16) {dict(sorted(buckets.items()))}; kernel 3 launches {launches} for "
        f"{st.num_groups} groups; {st.queries_per_s:.2f} q/s (scoring {st.scoring_s:.3f} s); vs plain-version serve: "
        f"max score error {max_err:.3e}, near-tie swaps {swapped}/{len(samples)}; recall kernel {rec_k} plain {rec_p}")
    return dict(launches=launches, groups=st.num_groups, qps=st.queries_per_s, buckets=dict(buckets),
                max_abs_err=max_err, swapped=swapped, recall=rec_k, recall_plain=rec_p)


SWEEP_DIR = OUT_DIR / "chip_smoke_sweep"  # phase 10: the run logs stay
SWEEP_WORK = SWEEP_DIR / "work"           # the trials' checkpoints, removed when phase 10 ends
SWEEP_TRIALS = 3
SWEEP_LEAK = 1.10          # a later trial's peak above the first's by more than this factor is a leak


def phase_sweep(smi: str, load_split):
    """10: ``sweep`` (``sweep=retriever_lr``, ``retriever=production``, 3
    trials of 1 epoch, a constant lr) through the CLI on the card, on phase
    7a's train split and phase 4's validation split (``load_split``): every
    trial ``ok``, ``sweep.json``'s best the trial with the highest
    ``answer/reachability@100``, each trial's wall time and peak memory (a
    later peak above the first's by more than 10% fails as a leak); then
    ``serve`` of the best trial's ``ckpt/best`` through kernel 3 under
    phase 4's rule."""
    from unittest import mock

    import torch

    from evi_rag_tpu_torch import cli

    dev = torch.device("cuda")
    train_task = cli.task_train_retriever
    trials = []

    def measured(cfg, *, run_dir):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        row = dict(start_gib=torch.cuda.memory_allocated(dev) / 2**30)
        t = time.perf_counter()
        try:
            return train_task.__wrapped__(cfg, run_dir=run_dir)
        finally:
            torch.cuda.synchronize()
            row.update(wall_s=time.perf_counter() - t, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
            trials.append(row)

    measured.__wrapped__ = measured  # task_sweep calls its objective's __wrapped__
    t = time.perf_counter()
    with mock.patch.object(cli, "_load_split", load_split), mock.patch.object(cli, "task_train_retriever", measured):
        rc = cli.main(["sweep", "--configs-dir", str(ROOT / "configs"), "sweep=retriever_lr", "retriever=production",
                       f"sweep.num_trials={SWEEP_TRIALS}", "retriever.train.max_epochs=1",
                       "retriever.train.optimizer.schedule=constant", "device=cuda", f"paths.log_dir={SWEEP_WORK}"])
    wall = time.perf_counter() - t
    (doc_path,) = sorted(SWEEP_WORK.glob("**/sweep.json"))
    doc = json.loads(doc_path.read_text())
    shutil.copy(doc_path, SWEEP_DIR / "sweep.json")
    statuses = [tr["status"] for tr in doc["trials"]]
    if rc != 0 or statuses != ["ok"] * SWEEP_TRIALS:
        raise AssertionError(f"10 sweep: rc {rc}, trials {[(tr['status'], tr.get('error')) for tr in doc['trials']]}")
    scores = [tr["metrics"]["answer/reachability@100"] for tr in doc["trials"]]
    first_best = scores.index(max(scores))
    if doc["best"]["trial"] != first_best or doc["best"]["score"] != scores[first_best]:
        raise AssertionError(f"10 sweep: best {doc['best']['trial']} but answer/reachability@100 {scores}")
    leaks = [i for i, tr in enumerate(trials[1:], 1) if tr["peak_gib"] > SWEEP_LEAK * trials[0]["peak_gib"]]
    if len(trials) != SWEEP_TRIALS or leaks:
        raise AssertionError(f"10 sweep: trial peaks {trials} (leak in trials {leaks})")
    for tr, row in zip(doc["trials"], trials):
        row.update(overrides=tr["overrides"], score=tr["score"])
    log(f"[10 sweep] sweep=retriever_lr, retriever=production (D = H = 1024, bf16, batch 16), {SWEEP_TRIALS} trials "
        f"of 1 epoch ({len(load_split(None, 'train')[0])} train questions, constant lr) in {wall:.1f} s, all ok:")
    for i, row in enumerate(trials):
        o = row["overrides"]
        log(f"[10 sweep]   trial {i}: lr {o['retriever.train.optimizer.learning_rate']:.3g} T "
            f"{o['retriever.train.loss.infonce_temperature']:.3f} dropout {o['retriever.model.dropout_p']} -> "
            f"answer/reachability@100 {row['score']:.4f}; wall {row['wall_s']:.1f} s, peak {row['peak_gib']:.2f} GiB "
            f"(allocated at start {row['start_gib']:.3f} GiB)")
    best_ckpt = doc_path.parent / f"trial_{first_best}" / "ckpt" / "best"
    samples, ent, rel, q_emb = load_split(None, "validation")
    serve = serve_against_plain("10 serve", best_ckpt, samples, ent, rel, q_emb, FULL_RANK)
    shutil.rmtree(SWEEP_WORK)  # 3 trials' checkpoints with optimizer state
    return dict(nvidia_smi=smi, wall_s=wall, trials=trials, best=first_best, serve=serve)


# Phase 11: the multi-device paths.  One card stands in for a mesh of
# several entries ([cuda:0] * n): each entry holds its own shard and the
# shards run one after another, so no number here is a multi-card speed.
DP_DIR = OUT_DIR / "chip_smoke_dp"       # phase 11: rank rows and logs stay
DP_WORK = DP_DIR / "work"                # parameters and the CLI's checkpoints, removed when phase 11 ends
SHARDED_V = 4_194_304      # 11a: entity rows, 16 GiB in f32 (cut from JAX's "tens of millions" to fit one card)
MESH_ENTRIES = 4           # 11a-11c: the one-card stand-in mesh
KNN_V, KNN_B = 262_144, 64  # 11c: bench.py:353's kNN shape
SHARD_TOL = 1e-5           # 11b: sharded vs unsharded kernel 2 values
DP_RANKS = 2               # 11e: ranks spawned, sharing the card


def tol_ratio(got, want, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): at most 1 passes."""
    return float(((got.float() - want.float()).abs() / (atol + rtol * want.float().abs())).max())


def cuda_median_ms(fn, passes: int = 3) -> tuple[float, object]:
    """Median CUDA-event ms of ``passes`` calls after one warm call, and the
    last call's result."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(passes):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return sorted(times)[len(times) // 2], out


def meshes():
    import torch

    from evi_rag_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    return {f"[cuda:0]*{MESH_ENTRIES}": make_mesh(devices=[dev] * MESH_ENTRIES), "make_mesh()": make_mesh()}


def phase_multidevice(smi: str, bundle_np, serve_ctx) -> dict:
    """11a-11e (see the module docstring)."""
    import torch

    out = {"nvidia_smi": smi}
    for name, fn in (("11a", lambda: phase_sharded_build(bundle_np)),
                     ("11b", lambda: phase_sharded_query(bundle_np, out["11a"]["index"])),
                     ("11c", phase_knn),
                     ("11d", lambda: phase_dp_serve(serve_ctx)),
                     ("11e", phase_dp_train)):
        t = time.perf_counter()
        out[name] = fn()
        out[name]["wall_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        log(f"[{name}] wall {out[name]['wall_s']:.1f} s")
    out["11a"].pop("index")
    return out


def phase_sharded_build(bundle_np) -> dict:
    """11a: ``build_triple_index_sharded`` over both meshes against
    ``build_triple_index`` on the card (rtol 1e-5 / atol 1e-6,
    ``tests/test_sharded.py:236-238``): seconds and peak memory of each."""
    import torch

    from evi_rag_tpu_torch.ops.query import build_triple_index, build_triple_index_sharded
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = {"features": bundle_from_numpy(bundle_np["features"], device=dev)}
    gen = torch.Generator(device=dev).manual_seed(29)
    tables = dict(
        entity_emb=torch.randn(SHARDED_V, D, device=dev, generator=gen),
        relation_emb=torch.randn(RELATIONS, D, device=dev, generator=gen),
        nontext_mask=torch.rand(SHARDED_V, device=dev, generator=gen) < 0.01,
        heads=torch.randint(0, SHARDED_V, (POOLED_M,), device=dev, generator=gen),
        rels=torch.randint(0, RELATIONS, (POOLED_M,), device=dev, generator=gen),
        tails=torch.randint(0, SHARDED_V, (POOLED_M,), device=dev, generator=gen),
        struct_raw=torch.randn(POOLED_M, S, device=dev, generator=gen),
    )
    rows = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        index = fn()
        torch.cuda.synchronize()
        rows[label] = dict(seconds=time.perf_counter() - t, peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
        return index

    ref = timed("unsharded", lambda: build_triple_index(bundle, **tables, device=dev))
    got = {}
    for label, mesh in meshes().items():
        got[label] = timed(label, lambda m=mesh: build_triple_index_sharded(bundle, mesh=m, **tables))
        ratio = max(tol_ratio(getattr(got[label], f), getattr(ref, f), 1e-5, 1e-6)
                    for f in ("head_repr", "rel_repr", "tail_repr", "struct_raw"))
        rows[label]["tol_ratio"] = ratio
        if ratio > 1.0:
            raise AssertionError(f"11a {label}: the sharded index differs from the unsharded one ({ratio:.3f} of "
                                 "rtol 1e-5 / atol 1e-6)")
    log(f"[11a sharded build] entity table {SHARDED_V} x {D} f32 ({SHARDED_V * D * 4 / 2**30:.0f} GiB), "
        f"{RELATIONS} relations, {POOLED_M} candidates, S = {S}:")
    for label, row in rows.items():
        log(f"[11a sharded build]   {label}: {row['seconds']:.3f} s, peak {row['peak_gib']:.2f} GiB"
            + (f", vs unsharded at {row['tol_ratio']:.4f} of rtol 1e-5 / atol 1e-6" if "tol_ratio" in row else ""))
    index = got[f"[cuda:0]*{MESH_ENTRIES}"]
    del tables, ref, got
    return dict(rows=rows, index=index)


def phase_sharded_query(bundle_np, index) -> dict:
    """11b: 11a's index in bf16 through ``query_topk_sharded_fused`` (kernel
    2 per shard) over both meshes against ``query_topk_fused`` unsharded, and
    POOLED_CHECK queries of every result (the unsharded one too) against
    kernel 2's plain version on the same bf16 index (``hold_to_plain``, as
    phase 6); ``query_topk_sharded`` (f32, 8 queries) against ``query_topk``."""
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.ops.query import query_topk, query_topk_sharded, query_topk_sharded_fused
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = {"features": bundle_from_numpy(bundle_np["features"], device=dev)}
    q = torch.randn(POOLED_B, D, device=dev, generator=torch.Generator(device=dev).manual_seed(31))
    idx = index.to(dtype=torch.bfloat16)
    w = sk.prep_weights(bundle["features"])
    ref_v, ref_i = sk.query_topk_fused(bundle, q, idx, k=K, weights=w)
    nq = POOLED_CHECK
    plain = sk.fused_scores_reference(bundle, q[:nq], idx.head_repr, idx.rel_repr, idx.tail_repr, idx.struct_raw,
                                      weights=w)
    ref_err, ref_diff = hold_to_plain(ref_v[:nq], ref_i[:nq], plain, K)
    log(f"[11b sharded pooled] unsharded kernel 2 on this index, {nq} queries vs its plain version: max abs err "
        f"{ref_err:.3e}, differing ids {ref_diff} (tol {ATOL}, near-tie {TIE_TOL})")
    rows = {"unsharded": dict(plain_max_abs_err=ref_err, plain_differing_ids=ref_diff)}
    for label, mesh in meshes().items():
        reset_launches()  # the main path of this slice: counts at 0 just before, read just after
        ms, (v, i) = cuda_median_ms(lambda m=mesh: query_topk_sharded_fused(bundle, q, idx, mesh=m, k=K))
        launches = sk.query_topk_fused.launches
        if launches != 4 * mesh.size or sk.per_question_topk.launches or sk.score_bidirectional.launches:
            raise AssertionError(f"11b {label}: kernel 2 launched {launches} times in 4 passes over {mesh.size} shards")
        equal = bool(torch.equal(v, ref_v) and torch.equal(i, ref_i))
        differing = hold_sharded(v, i, ref_v, ref_i)
        err, diff = hold_to_plain(v[:nq], i[:nq], plain, K)
        rows[label] = dict(ms=ms, qps=POOLED_B / ms * 1e3, launches_per_pass=launches // 4, bit_equal=equal,
                           differing_ids=differing, max_abs_err=float((v - ref_v).abs().max()),
                           plain_max_abs_err=err, plain_differing_ids=diff)
        log(f"[11b sharded pooled] {label}: query_topk_sharded_fused {ms:.3f} ms per {POOLED_B}-query pass "
            f"(CUDA events, median of 3; {rows[label]['qps']:.2f} q/s), kernel 2 launches per pass "
            f"{launches // 4}; vs unsharded kernel 2: bit for bit {equal}, differing ids {differing}; {nq} "
            f"queries vs the plain version: max abs err {err:.3e}, differing ids {diff}")
    del plain
    nq = 8
    plain_ref = query_topk(bundle, q[:nq], index, k=K, dtype=torch.float32, device=dev)
    for label, mesh in meshes().items():
        t = time.perf_counter()
        v, i = query_topk_sharded(bundle, q[:nq], index, mesh=mesh, k=K, dtype=torch.float32)
        torch.cuda.synchronize()
        ratio = tol_ratio(v, plain_ref[0], 1e-5, 1e-5)
        same = all(set(a) == set(b) for a, b in zip(i.tolist(), plain_ref[1].tolist()))
        if ratio > 1.0 or not same:
            raise AssertionError(f"11b {label}: query_topk_sharded vs query_topk at {ratio:.3f} of rtol 1e-5 / "
                                 f"atol 1e-5, equal id sets {same}")
        rows[label].update(plain_s=time.perf_counter() - t, plain_tol_ratio=ratio)
        log(f"[11b sharded pooled] {label}: query_topk_sharded (f32, {nq} queries) vs query_topk at {ratio:.4f} of "
            f"rtol 1e-5 / atol 1e-5, equal id sets, {rows[label]['plain_s']:.2f} s")
    return dict(rows=rows, launches=rows[f"[cuda:0]*{MESH_ENTRIES}"]["launches_per_pass"] * 4)


def hold_sharded(v, i, ref_v, ref_i) -> int:
    """The sharded top-k against the unsharded one: values of shared ids
    within SHARD_TOL, and every id in one but not the other within TIE_TOL
    of the other's k-th value.  Returns the differing ids."""
    v, i, rv, ri = (x.cpu().numpy() for x in (v, i, ref_v, ref_i))
    differing = 0
    for b in range(v.shape[0]):
        got, want = dict(zip(i[b].tolist(), v[b].tolist())), dict(zip(ri[b].tolist(), rv[b].tolist()))
        for e in set(got) & set(want):
            if abs(got[e] - want[e]) > SHARD_TOL:
                raise AssertionError(f"11b query {b}: id {e} scores {got[e]} vs {want[e]}")
        for e in set(got) ^ set(want):
            val, kth = (got[e], rv[b, -1]) if e in got else (want[e], v[b, -1])
            if abs(val - kth) > TIE_TOL:
                raise AssertionError(f"11b query {b}: id {e} differs beyond the near-tie rule")
        differing += len(set(got) ^ set(want)) // 2
    return differing


def phase_knn() -> dict:
    """11c: kNN at bench.py:353's shape (cosine, bf16) one-shot, chunked,
    approx and over MESH_ENTRIES shards, held to an f32 brute force on the
    card (the near-tie rule; approx by its overlap >= 0.8 k)."""
    import torch

    from evi_rag_tpu_torch.ops import knn
    from evi_rag_tpu_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(37)
    table = torch.randn(KNN_V, D, device=dev, generator=gen)
    q = torch.randn(KNN_B, D, device=dev, generator=gen)
    unit = lambda x: x / x.norm(dim=-1, keepdim=True)  # noqa: E731
    brute = unit(q) @ unit(table).T                     # [B, V] f32 cosine
    want_v, want_i = torch.topk(brute, K)
    oneshot = knn._ONESHOT_BYTES

    def chunked():
        knn._ONESHOT_BYTES = 0
        try:
            return knn.knn_topk(q, table, k=K, metric="cosine")
        finally:
            knn._ONESHOT_BYTES = oneshot

    runs = {"one-shot": lambda: knn.knn_topk(q, table, k=K, metric="cosine"),
            "chunked": chunked,
            "approx": lambda: knn.knn_topk(q, table, k=K, metric="cosine", method="approx"),
            f"sharded [cuda:0]*{MESH_ENTRIES}": lambda: knn.knn_topk_sharded(
                q, table, mesh=make_mesh(devices=[dev] * MESH_ENTRIES), k=K, metric="cosine")}
    rows = {}
    for label, fn in runs.items():
        ms, (v, i) = cuda_median_ms(fn)
        row = dict(ms=ms, qps=KNN_B / ms * 1e3)
        if label == "approx":
            row["min_overlap"] = min(len(set(a) & set(b)) for a, b in zip(i.tolist(), want_i.tolist()))
            if row["min_overlap"] < int(0.8 * K):
                raise AssertionError(f"11c approx: overlap {row['min_overlap']} < {int(0.8 * K)} of k = {K}")
        else:
            row["max_abs_err"], row["differing_ids"] = hold_to_plain(v, i, brute, K)
        rows[label] = row
        log(f"[11c knn] {label}: {ms:.3f} ms for {KNN_B} queries over {KNN_V} x {D} bf16 (CUDA events, median of "
            f"3), {row['qps']:.1f} q/s; " + (f"min overlap with the exact top-{K} {row['min_overlap']}"
                                             if label == "approx" else
                                             f"vs the f32 brute force: max abs err {row['max_abs_err']:.2e}, "
                                             f"differing ids {row['differing_ids']} (near-tie rule)"))
    return dict(rows=rows, bins=knn.partial_reduce_bins(K))


def phase_dp_serve(ctx) -> dict:
    """11d: phase 4's split through ``serve_split(mesh=...)`` over
    ``make_mesh()`` and ``[cuda:0] * 2``, held to phase 4's single-device
    serve (bit for bit expected: a question's scoring does not depend on its
    group) and to the plain-version full rankings by phase 4's rule."""
    import numpy as np
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.parallel.mesh import make_mesh
    from evi_rag_tpu_torch.serving import serve_recall_at_k, serve_split

    bundle, ds, kw, single, full = ctx
    kw = {k: v for k, v in kw.items() if k != "device"}
    dev = torch.device("cuda", torch.cuda.current_device())
    rows = {}
    for label, mesh in {"make_mesh()": make_mesh(), "[cuda:0]*2": make_mesh(devices=[dev] * 2)}.items():
        by_device: dict[str, int] = {}

        def counted(b, q, h, *args, **kw2):
            by_device[str(h.device)] = by_device.get(str(h.device), 0) + 1
            return sk.per_question_topk(b, q, h, *args, **kw2)

        serve_split(bundle, ds.samples, mesh=mesh, **kw)  # first pass: allocator warm
        reset_launches()
        by_device.clear()
        results, stats = serve_split(bundle, ds.samples, mesh=mesh, fused_fn=counted, **kw)
        launches = sk.per_question_topk.launches
        if launches != mesh.size * (stats.num_groups + 1) or sum(by_device.values()) != launches:
            raise AssertionError(f"11d {label}: kernel 3 launched {launches} times ({by_device}) for "
                                 f"{stats.num_groups} groups over {mesh.size} entries")
        qps = sorted([stats.queries_per_s] + [serve_split(bundle, ds.samples, mesh=mesh, **kw)[1].queries_per_s
                                              for _ in range(2)])
        equal = sum(np.array_equal(a.edge_ids, b.edge_ids) and np.array_equal(a.scores, b.scores)
                    for a, b in zip(single, results))
        _, swapped, max_err = check_against_plain(ds.samples, results, full)
        rec = serve_recall_at_k(ds.samples, results, [10, 100])
        rows[label] = dict(qps=qps, launches=launches, launches_by_device=by_device, groups=stats.num_groups,
                           bit_equal_questions=equal, swapped=swapped, max_abs_err=max_err, recall=rec)
        log(f"[11d dp serve] {label} ({mesh.size} entries): q/s per pass {qps} median {qps[1]}; kernel 3 launches "
            f"{launches} = {mesh.size} x ({stats.num_groups} groups + 1 warmup), by device {by_device}; "
            f"{equal}/{len(single)} questions bit for bit phase 4's single-device serve; vs the plain full "
            f"rankings: max score error {max_err:.3e}, near-tie swaps {swapped}; recall {rec}")
    # Phase 4's own call (no mesh) alternated with make_mesh(), here after
    # 11a-11c: whether a gap between phase 4's q/s and 11d's follows the
    # path or the state of the run.
    alt: dict[str, list[float]] = {"mesh=None (phase 4's call)": [], "make_mesh()": []}
    one = make_mesh()
    for _ in range(3):
        alt["mesh=None (phase 4's call)"].append(serve_split(bundle, ds.samples, **ctx[2])[1].queries_per_s)
        alt["make_mesh()"].append(serve_split(bundle, ds.samples, mesh=one, **kw)[1].queries_per_s)
    for label, qps in alt.items():
        log(f"[11d dp serve] alternated, {label}: q/s per pass {qps} median {sorted(qps)[1]}")
    return dict(rows=rows, alternated=alt, launches=rows["[cuda:0]*2"]["launches"])


def phase_dp_train() -> dict:
    """11e: data-parallel training on DP_RANKS ranks spawned with the EVI_*
    variables (``testing_dp``), all on this card: (i) one f32 step
    at D = H = 256 with 2 shards (7b's setting), the ranks bit for bit
    equal and held to the single-process two-shard step (loss rtol 1e-5,
    parameters rtol 1e-3 / atol 5e-5); (ii) the production retriever (7a's)
    with 2 shards x 8, step ms; (iii) one stacked GFlowNet step at 8b's
    width, held like (i) to the single-process loop over the same shards and
    draws; the glue (``gather_records`` across the ranks, ``serve`` refused
    under the group); (iv) the ``train_retriever`` CLI with num_shards=2:
    one ``ckpt/best`` written by rank 0, the same digest on both ranks."""
    import numpy as np
    import torch

    from evi_rag_tpu_torch import testing_dp
    from evi_rag_tpu_torch.testing import SMALL_TRAIN_OVERRIDES

    DP_WORK.mkdir(parents=True, exist_ok=True)
    step_256 = dict(kind="retriever_step", name="step256", shards=2, per_shard=2,
                    dataset=dict(num_samples=4, emb_dim=256, num_relations=64, num_entities=4096, min_nodes=64,
                                 max_nodes=256, avg_extra_edges=3.0, seed=0),
                    model=dict(emb_dim=256, hidden_dim=256, dropout_p=0.0),
                    optimizer=dict(name="adamw", learning_rate=1e-4))
    production = dict(kind="retriever_step", name="production", shards=2, per_shard=8, id_feed=True, warmup=2,
                      steps=5, dataset=dict(num_samples=16, seed=8, **REALISTIC),
                      model=dict(emb_dim=D, hidden_dim=H, dropout_p=0.1, compute_dtype="bfloat16",
                                 hide_seek_enabled=True, hide_seek_p_near=0.7, hide_seek_p_far=0.1,
                                 hide_seek_bias_near=-2.0, hide_seek_bias_far=-0.5),
                      loss=dict(infonce_temperature=0.07), optimizer=dict(name="adamw", learning_rate=1e-4))
    gfn = dict(kind="gflownet_step", name="gflownet", questions=GFN_BATCH, shards=2,
               cfg=dict(hidden_dim=H, max_steps=4, num_train_rollouts=GFN_ROLLOUTS, bc_weight=0.5, dropout=0.1,
                        optimizer=dict(name="adamw", learning_rate=1e-4)))
    checks = [step_256, production, gfn, dict(kind="glue", name="glue")]
    spec = dict(device="cuda", out_dir=str(DP_WORK / "ranks"), timeout_s=300, checks=checks)
    t = time.perf_counter()
    rows = testing_dp.spawn_checks(spec, DP_RANKS, timeout_s=600)
    ranks_s = time.perf_counter() - t
    cards = sorted({r["device"] for r in rows})
    label = f"{DP_RANKS} ranks on {len(cards)} card(s)"
    log(f"[11e dp train] {label} {cards} ({rows[0].get('card', rows[0]['device'])}), backend {rows[0]['backend']}, ranks' wall {ranks_s:.1f} s")
    # The single-process references of (i) and (iii), here on the same card.
    single = testing_dp.run_checks({**spec, "out_dir": str(DP_WORK / "single"), "checks": [step_256, gfn]})
    out = dict(label=label, backend=rows[0]["backend"], cards=cards, ranks_s=ranks_s)
    for name in ("step256", "gflownet"):
        p = [np.load(DP_WORK / "ranks" / f"{name}_rank{r}.npz") for r in range(DP_RANKS)]
        ref = np.load(DP_WORK / "single" / f"{name}_rank0.npz")
        if not all(np.array_equal(p[0][k], p[r][k]) for r in range(1, DP_RANKS) for k in p[0].files):
            raise AssertionError(f"11e {name}: the ranks' parameters differ")
        ratio = max(float((np.abs(p[0][k] - ref[k]) / (5e-5 + 1e-3 * np.abs(ref[k]))).max()) for k in ref.files)
        loss_rel = abs(rows[0]["checks"][name]["loss"] - single["checks"][name]["loss"]) / abs(
            single["checks"][name]["loss"])
        if ratio > 1.0 or loss_rel > 1e-5:
            raise AssertionError(f"11e {name}: ranks vs one process: parameters at {ratio:.3f} of rtol 1e-3 / "
                                 f"atol 5e-5, loss rel {loss_rel:.2e}")
        bitwise = all(np.array_equal(p[0][k], ref[k]) for k in ref.files)
        out[name] = dict(tol_ratio=ratio, loss_rel=loss_rel, bit_equal_to_single=bitwise,
                         loss=rows[0]["checks"][name]["loss"], edges=rows[0]["checks"][name]["edges"])
        log(f"[11e dp train] {name}: ranks bit for bit equal; vs the single-process step: parameters at "
            f"{ratio:.4f} of rtol 1e-3 / atol 5e-5 (bit for bit {bitwise}), loss rel {loss_rel:.2e}")
    prod = rows[0]["checks"]["production"]
    out["production"] = dict(step_ms=prod["step_ms"], median_ms=float(np.median(prod["step_ms"])),
                             loss=prod["loss"], edges=prod["edges"])
    if not np.isfinite(prod["loss"]):
        raise AssertionError("11e production: loss not finite")
    log(f"[11e dp train] production retriever (D = H = {D}, bf16, 2 shards x 8): step ms {prod['step_ms']} "
        f"median {out['production']['median_ms']:.2f} ({label}; wall clock per step with a sync), loss "
        f"{prod['loss']:.4f}")
    for r, row in enumerate(rows):
        g = row["checks"]["glue"]
        if [x["id"] for x in g["merged"]] != list(range(DP_RANKS + 1)) or "single process" not in (
                g["errors"]["serve"] or "") or g["main_only"] != (0 if r == 0 else None):
            raise AssertionError(f"11e glue on rank {r}: {g}")
    log(f"[11e dp train] gather_records merged ids {[x['id'] for x in rows[0]['checks']['glue']['merged']]} on "
        "every rank; serve under the group refused: the single-process-eval ConfigError")

    ckpt = DP_WORK / "cli_ckpt"
    overrides = [o for o in SMALL_TRAIN_OVERRIDES if not o.startswith(("retriever.train.per_shard_batch",
                                                                       "retriever.train.max_epochs"))]
    argv = lambda r: [sys.executable, "-m", "evi_rag_tpu_torch.cli", "train_retriever", "--configs-dir",  # noqa: E731
                      str(ROOT / "configs"), *overrides, "retriever.train.max_epochs=2",
                      f"retriever.train.num_shards={DP_RANKS}", "retriever.train.per_shard_batch=8",
                      "extras.print_config=false", f"retriever.train.ckpt_dir={ckpt}",
                      f"paths.log_dir={DP_DIR / f'cli_logs_rank{r}'}"]
    t = time.perf_counter()
    results = testing_dp.spawn(argv, DP_RANKS, timeout_s=600)
    cli_s = time.perf_counter() - t
    for r, (rc, _, err) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"11e cli: rank {r} exited {rc}:\n{err[-3000:]}")
    from evi_rag_tpu_torch.train.checkpoint import load_checkpoint

    digests = [json.loads(sorted((DP_DIR / f"cli_logs_rank{r}").glob("**/metrics.json"))[-1].read_text())
               ["best_ckpt_sha256"] for r in range(DP_RANKS)]
    _, meta = load_checkpoint(ckpt / "best")
    if sorted(p.name for p in ckpt.iterdir()) != ["best", "last"] or len(set(digests + [meta["params_sha256"]])) != 1:
        raise AssertionError(f"11e cli: checkpoints {sorted(ckpt.iterdir())}, digests {digests}")
    out["cli"] = dict(seconds=cli_s, digest=digests[0])
    log(f"[11e dp train] train_retriever CLI, num_shards={DP_RANKS}, {label}: {cli_s:.1f} s; one ckpt/best "
        f"(rank 0 writes), digest {digests[0][:16]}... on every rank")
    (DP_DIR / "ranks.json").write_text(json.dumps(rows, indent=1))
    shutil.rmtree(DP_WORK)
    return out


# The debug phase: experiment=debug (extras.deterministic + extras.debug_nans)
# through the CLI.  Every run is a process of its own: deterministic mode
# needs CUBLAS_WORKSPACE_CONFIG before the process's first cuBLAS call.
DEBUG_DIR = OUT_DIR / "chip_smoke_debug"  # the runs' logs stay
DEBUG_WORK = DEBUG_DIR / "work"           # their checkpoints, removed when the phase ends
DEBUG_B = 16               # (d): queries of phase 6's inputs
NAN_ROW = 5                # (e): the row of W1 set to NaN (the inter block, which kernel 3 reads)
# (f): the build's rows, a few dozen texts (pool entities, relations and
# questions) of the WebQSP preset; the sweep's trials.
DEBUG_BUILD_ROWS = dict(counts={"train": 0, "validation": 3, "test": 0}, pool=40, relations=8, edge_cap=24)
DEBUG_SWEEP_TRIALS = 2
FOUR_TASKS = ("build", "eval_retriever", "eval_gflownet", "sweep")
# (f) runs in two waves of fresh processes: twelve at once (three sweeps at
# ~11.5 GiB each among them) can fill the card's 80 GB.
FOUR_TASK_WAVES = (("build", "eval_retriever", "eval_gflownet"), ("sweep",))
DEBUG_CHILD = "import sys, chip_smoke; sys.exit(chip_smoke.debug_child(sys.argv[1]))"


def debug_child(spec: str) -> int:
    """One run of the debug phase, in a fresh process.  ``spec`` is JSON:
    ``{"argv": [...]}`` runs the CLI on the realistic splits
    (``realistic_loader``), with the task and each train step timed (wall
    clock between CUDA synchronisations) and the ids and scores that
    ``serve_split`` returns hashed; ``{"kernels": true}`` runs ``debug_kernels``.  Prints
    ``DEBUG_CHILD <json>`` as its last stdout line, also when the run raises
    (the exception then ends the process with a non-zero code)."""
    import contextlib
    import hashlib
    from unittest import mock

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from evi_rag_tpu_torch import cli, serving
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.train import gflownet_trainer as gt
    from evi_rag_tpu_torch.train import retriever_trainer as rt

    spec = json.loads(spec)
    if spec.get("kernels"):
        print("DEBUG_CHILD " + json.dumps(debug_kernels()), flush=True)
        return 0
    out: dict = {"steps_ms": [], "serve_sha256": None}
    patches = debug_build_patches(**spec["build_rows"]) if spec.get("build_rows") else []

    def timed(make):
        def made(*a, **kw):
            step = make(*a, **kw)

            def run(*sa, **skw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = step(*sa, **skw)
                torch.cuda.synchronize()
                out["steps_ms"].append((time.perf_counter() - t) * 1e3)
                return res
            return run
        return made

    split_fn = serving.serve_split

    def hashed(*a, **kw):
        results, stats = split_fn(*a, **kw)
        h = hashlib.sha256()
        for r in results:
            h.update(r.sample_id.encode())
            h.update(np.asarray(r.edge_ids, np.int64).tobytes())
            h.update(np.asarray(r.scores, np.float32).tobytes())
        out.update(serve_sha256=h.hexdigest(), serve_qps=stats.queries_per_s)
        return results, stats

    task = cli.TASKS[spec["argv"][0]]

    def task_timed(*a, **kw):
        t = time.perf_counter()
        try:
            return task(*a, **kw)
        finally:
            out["task_s"] = time.perf_counter() - t

    reset_launches()
    with mock.patch.object(cli, "_load_split", realistic_loader()), \
            mock.patch.object(rt, "make_train_step", timed(rt.make_train_step)), \
            mock.patch.object(gt, "make_gfn_train_step", timed(gt.make_gfn_train_step)), \
            mock.patch.object(serving, "serve_split", hashed), \
            mock.patch.dict(cli.TASKS, {spec["argv"][0]: task_timed}), contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        try:
            return cli.main(spec["argv"])
        finally:
            out["pqt_launches"] = sk.per_question_topk.launches
            print("DEBUG_CHILD " + json.dumps(out), flush=True)


def debug_build_patches(gte: dict, rows: dict) -> list:
    """(f)'s ``build`` through the CLI: its encoder is gte at ``gte``'s
    geometry with random weights (seed 23, as 9b) and the stand-in
    tokenizer, made inside the task (so under the profile's modes: the model
    is made on the meta device, then loaded), and its raw rows come from
    memory (``testing.synthetic_rows``' WebQSP preset at ``rows``' sizes);
    the parquet tables are written where pyarrow imports."""
    import importlib.util
    from unittest import mock

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data import pipeline
    from evi_rag_tpu_torch.data.gte import GTEConfig, GTEModel, GTETextEncoder
    from evi_rag_tpu_torch.testing import HashTokenizer, random_gte_state, synthetic_rows

    def text_encoder(enc_cfg, device):
        cfg = GTEConfig(**gte)
        model = GTEModel.from_state_dict(random_gte_state(cfg, seed=23), cfg, device=device)
        return GTETextEncoder.from_model(model, HashTokenizer(cfg.vocab_size), max_length=GTE_LEN)

    def build_pipeline(cfg, encoder, *, column_map=None):
        res, tables = pipeline.build_from_samples(cfg, encoder, pipeline.read_raw_rows(
            list(synthetic_rows("webqsp", seed=0, **rows)), cfg.dataset, column_map=column_map,
            entity_normalization=cfg.entity_normalization))
        if importlib.util.find_spec("pyarrow") is not None:
            pipeline.write_tables(res.out_dir, tables)
        return res

    return [mock.patch.object(cli, "_text_encoder", text_encoder),
            mock.patch.object(pipeline, "build_pipeline", build_pipeline)]


def debug_kernels() -> dict:
    """(d): under both modes (``utils.extras``), each pooled kernel launched
    twice on phase 6's inputs (``DEBUG_B`` queries), kernel 3 on its pinned
    input (``PQT_DIGEST``); a NaN made in a backward op."""
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.testing import PQT_DIGEST, pqt_digest
    from evi_rag_tpu_torch.utils import extras

    cfg = {"extras": {"deterministic": True, "debug_nans": True}}
    extras.prepare_process(cfg)
    dev = torch.device("cuda", torch.cuda.current_device())
    bundle, idx, q, w, _ = pooled_inputs(make_bundle(D, H, S, seed=11), dev)
    q = q[:DEBUG_B].contiguous()
    rows = (idx.head_repr, idx.rel_repr, idx.tail_repr, idx.struct_raw)
    calls = {"score_bidirectional": lambda: (sk.score_bidirectional(bundle, q, *rows, weights=w),),
             "query_topk_per_query": lambda: sk.query_topk_per_query(bundle, q, idx, k=K, weights=w),
             "query_topk_fused": lambda: sk.query_topk_fused(bundle, q, idx, k=K, weights=w)}
    out: dict = {}
    reset_launches()
    with extras.apply_extras(cfg):
        for name, fn in calls.items():
            first = [x.clone() for x in fn()]
            again = fn()
            torch.cuda.synchronize()
            out[name] = all(torch.equal(a, b) for a, b in zip(first, again))
        out["pqt_digest_equal"] = pqt_digest(dev) == PQT_DIGEST
        out["launches"] = {n: getattr(sk, n).launches
                           for n in ("score_bidirectional", "query_topk_fused", "per_question_topk")}
        a = torch.zeros(3, device=dev, requires_grad=True)
        try:
            (a * 0).sqrt().sum().backward()
            out["backward_nan"] = None
        except FloatingPointError as e:
            out["backward_nan"] = str(e)
    return out


def run_debug_children(runs: dict) -> dict:
    """Each ``label: (spec, fail)`` of ``runs`` as ``debug_child`` in a fresh
    process, all started at once (stdout to DEBUG_DIR/<label>.log, stderr to
    <label>.err); returns each child's record with its exit code, wall
    seconds and last stderr line.  A run that exits 0 where it should fail,
    or the other way round, fails the phase; every child is ended first."""
    procs = {}
    try:
        for label, (spec, _) in runs.items():
            with open(DEBUG_DIR / f"{label}.log", "w") as fo, open(DEBUG_DIR / f"{label}.err", "w") as fe:
                procs[label] = (subprocess.Popen([sys.executable, "-c", DEBUG_CHILD, json.dumps(spec)], cwd=ROOT,
                                                 stdout=fo, stderr=fe, text=True), time.perf_counter())
        recs = {}
        for label, (p, t) in procs.items():
            rc = p.wait(timeout=900)
            wall = time.perf_counter() - t
            stdout = (DEBUG_DIR / f"{label}.log").read_text()
            stderr = (DEBUG_DIR / f"{label}.err").read_text()
            rec = next((json.loads(ln.split(" ", 1)[1]) for ln in reversed(stdout.splitlines())
                        if ln.startswith("DEBUG_CHILD ")), {})
            err = [ln for ln in stderr.splitlines() if ln.strip()]
            rec.update(rc=rc, wall_s=wall, error=err[-1] if err else "")
            if (rc == 0) == runs[label][1]:
                raise AssertionError(f"debug {label}: exit code {rc} (expected {'non-zero' if runs[label][1] else 0});"
                                     f" stderr tail: {stderr[-2000:]}")
            recs[label] = rec
        return recs
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def run_debug_child(label: str, spec: dict, *, fail: bool = False) -> dict:
    """One ``debug_child`` run alone (see ``run_debug_children``)."""
    return run_debug_children({label: (spec, fail)})[label]


def median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def phase_debug(smi: str, retriever_ckpt: str) -> dict:
    """The debug phase (see the module docstring): (a) ``train_retriever``
    at phase 7a's width, 1 epoch, without extras, with each mode alone and
    twice under ``experiment=debug``; (b) ``train_gflownet`` at 8b's width on
    8a's stores, 1 epoch, without extras and twice under the profile; (c)
    ``serve`` of (a)'s checkpoint under the profile and without it; (d)
    ``debug_kernels``; (e) a NaN learning rate and a NaN row of W1; (f)
    ``build``, ``eval_retriever``, ``eval_gflownet`` and ``sweep`` twice under
    the profile and once without extras (``debug_four_tasks``)."""
    DEBUG_DIR.mkdir(parents=True, exist_ok=True)
    try:
        return debug_runs(smi, retriever_ckpt)
    finally:
        shutil.rmtree(DEBUG_WORK, ignore_errors=True)  # the runs' checkpoints


def debug_runs(smi: str, retriever_ckpt: str) -> dict:
    """(a)-(e) of ``phase_debug``."""
    import numpy as np

    from evi_rag_tpu_torch.train.checkpoint import flatten_tree, load_checkpoint, save_checkpoint, unflatten_tree

    common = ["--configs-dir", str(ROOT / "configs"), "device=cuda", "extras.print_config=false"]
    modes = {"off": [], "deterministic": ["extras.deterministic=true"], "debug_nans": ["extras.debug_nans=true"],
             "debug1": ["experiment=debug"], "debug2": ["experiment=debug"]}
    out: dict = {"nvidia_smi": smi}

    def argv(task: str, name: str, extra: list) -> list:
        return [task, *common, *extra, f"paths.log_dir={DEBUG_DIR / 'logs' / name}"]

    def walls(runs: dict) -> str:
        return ", ".join(f"{n} {r['wall_s']:.1f} (task {r['task_s']:.1f})" for n, r in runs.items())

    # (a) train_retriever, 1 epoch at production width.
    train = ["retriever=production", "retriever.train.max_epochs=1", "retriever.train.optimizer.schedule=constant"]
    a = {}
    for name, extra in modes.items():
        a[name] = run_debug_child(f"a_{name}", {"argv": argv("train_retriever", f"a_{name}", [
            *train, *extra, f"retriever.train.ckpt_dir={DEBUG_WORK / f'a_{name}'}"])})
        a[name]["digest"] = latest_metrics(DEBUG_DIR / "logs" / f"a_{name}")["best_ckpt_sha256"]
    if a["debug1"]["digest"] != a["debug2"]["digest"]:
        raise AssertionError(f"debug a: two deterministic runs give digests {a['debug1']['digest']} and "
                             f"{a['debug2']['digest']}")
    ms = {n: median(r["steps_ms"]) for n, r in a.items()}
    log(f"[debug a] train_retriever retriever=production (D = H = {D}, bf16, batch {TRAIN_BATCH}), 1 epoch of "
        f"{TRAIN_QUESTIONS} questions ({len(a['off']['steps_ms'])} steps), a fresh process each: step ms median "
        f"(wall clock between syncs) off {ms['off']:.2f}, deterministic {ms['deterministic']:.2f}, debug_nans "
        f"{ms['debug_nans']:.2f}, both {ms['debug1']:.2f} / {ms['debug2']:.2f} ({ms['debug1'] / ms['off']:.2f}x); "
        f"experiment=debug twice: digest {a['debug1']['digest'][:16]}... both runs; the run without extras "
        f"{'has the same digest' if a['off']['digest'] == a['debug1']['digest'] else 'has another digest'}; "
        f"process wall s {walls(a)}")
    out["a"] = dict(step_ms=ms, digests={n: r["digest"] for n, r in a.items()}, steps=len(a["off"]["steps_ms"]),
                    wall_s={n: r["wall_s"] for n, r in a.items()}, task_s={n: r["task_s"] for n, r in a.items()})

    # (b) train_gflownet, 1 epoch at hidden 1024 on phase 8a's stores.
    gfn = [f"gflownet.hidden_dim={H}", f"retriever.ckpt={retriever_ckpt}",
           f"gflownet.g_agent_dir={GFN_WORK / 'art' / 'g_agent'}", "gflownet.max_epochs=1"]
    b = {}
    for name in ("off", "debug1", "debug2"):
        ck = DEBUG_WORK / f"b_{name}"
        b[name] = run_debug_child(f"b_{name}", {"argv": argv("train_gflownet", f"b_{name}", [
            *gfn, *modes[name], f"gflownet.ckpt_dir={ck}"])})
        b[name]["digest"] = json.loads((ck / "best" / "meta.json").read_text())["params_sha256"]
    if b["debug1"]["digest"] != b["debug2"]["digest"]:
        raise AssertionError(f"debug b: two deterministic runs give digests {b['debug1']['digest']} and "
                             f"{b['debug2']['digest']}")
    gms = {n: median(r["steps_ms"]) for n, r in b.items()}
    log(f"[debug b] train_gflownet (hidden {H}, batch {GFN_BATCH}, {GFN_ROLLOUTS} rollouts), 1 epoch on 8a's train "
        f"store ({len(b['off']['steps_ms'])} steps): step ms median off {gms['off']:.2f}, experiment=debug "
        f"{gms['debug1']:.2f} / {gms['debug2']:.2f} ({gms['debug1'] / gms['off']:.2f}x); experiment=debug twice: "
        f"digest {b['debug1']['digest'][:16]}... both runs; the run without extras "
        f"{'has the same digest' if b['off']['digest'] == b['debug1']['digest'] else 'has another digest'}; "
        f"process wall s {walls(b)}")
    out["b"] = dict(step_ms=gms, digests={n: r["digest"] for n, r in b.items()}, steps=len(b["off"]["steps_ms"]),
                    wall_s={n: r["wall_s"] for n, r in b.items()}, task_s={n: r["task_s"] for n, r in b.items()})

    # (c) serve (a)'s checkpoint under the profile and without it.
    ckpt = DEBUG_WORK / "a_debug1" / "best"
    serve = ["serve.splits=[validation]", f"serve.k={K}", f"retriever.ckpt={ckpt}"]
    c = {name: run_debug_child(f"c_{name}", {"argv": argv("serve", f"c_{name}", [*serve, *modes[name]])})
         for name in ("off", "debug1")}
    if c["off"]["serve_sha256"] != c["debug1"]["serve_sha256"] or min(r["pqt_launches"] for r in c.values()) <= 0:
        raise AssertionError(f"debug c: serve under experiment=debug {c['debug1']} vs without {c['off']}")
    log(f"[debug c] serve of (a)'s checkpoint on phase 4's split ({QUESTIONS} questions, k = {K}): ids and scores "
        f"bit for bit the run without extras (sha256 {c['off']['serve_sha256'][:16]}...), kernel 3 launches "
        f"{c['debug1']['pqt_launches']} (without extras {c['off']['pqt_launches']}); q/s off "
        f"{c['off']['serve_qps']}, experiment=debug {c['debug1']['serve_qps']}; task s off {c['off']['task_s']:.1f}, "
        f"experiment=debug {c['debug1']['task_s']:.1f}")
    out["c"] = dict(sha256=c["off"]["serve_sha256"], pqt_launches=c["debug1"]["pqt_launches"],
                    qps={n: r["serve_qps"] for n, r in c.items()}, task_s={n: r["task_s"] for n, r in c.items()})

    # (d) the kernels under both modes, beside (e) planted NaNs: a NaN
    # learning rate, and a NaN row of W1 (no time of these three is a result).
    tree, meta = load_checkpoint(ckpt)
    flat = flatten_tree(tree["params"])
    (key,) = [k for k in flat if k.endswith("state_net_0/kernel")]
    w1 = np.array(flat[key])
    w1[NAN_ROW] = np.nan
    nan_ckpt = DEBUG_WORK / "e_nan_w1"
    save_checkpoint(nan_ckpt, unflatten_tree({**flat, key: w1}), meta={"parity_meta": meta["parity_meta"]})
    ck = DEBUG_WORK / "e_nan_lr"
    de = run_debug_children({
        "d_kernels": ({"kernels": True}, False),
        "e_nan_lr": ({"argv": argv("train_retriever", "e_nan_lr", [
            *train, "experiment=debug", "retriever.train.optimizer.learning_rate=.nan",
            f"retriever.train.ckpt_dir={ck}"])}, True),
        "e_nan_w1": ({"argv": argv("serve", "e_nan_w1", [
            "serve.splits=[validation]", f"serve.k={K}", f"retriever.ckpt={nan_ckpt}", "experiment=debug"])}, True),
    })
    d, e1, e2 = de["d_kernels"], de["e_nan_lr"], de["e_nan_w1"]
    if not (d["score_bidirectional"] and d["query_topk_per_query"] and d["query_topk_fused"]
            and d["pqt_digest_equal"] and d["backward_nan"]):
        raise AssertionError(f"debug d: {d}")
    log(f"[debug d] under both modes, on phase 6's inputs ({DEBUG_B} queries, M = {POOLED_M}): kernel 1 scores and "
        f"top-k, kernel 2 top-k each bit for bit equal over two launches; kernel 3 on its pinned input: PQT_DIGEST "
        f"{d['pqt_digest_equal']}; launches {d['launches']}; a NaN made in backward: \"{d['backward_nan']}\"")
    out["d"] = d
    if "FloatingPointError" not in e1["error"] or e1["steps_ms"] or (ck / "best").exists():
        raise AssertionError(f"debug e: the NaN learning rate gave {e1}")
    if not e2["error"].startswith("FloatingPointError") or "kernel per_question_topk" not in e2["error"]:
        raise AssertionError(f"debug e: the NaN row of W1 gave {e2}")
    log(f"[debug e] NaN learning rate: exit code {e1['rc']} after {len(e1['steps_ms'])} completed steps, no "
        f"ckpt/best, \"{e1['error']}\"; NaN in row {NAN_ROW} of W1 ({key}), serve experiment=debug: exit code "
        f"{e2['rc']}, \"{e2['error']}\"; (d) and (e) ran at once in {max(r['wall_s'] for r in de.values()):.1f} s")
    out["e"] = dict(nan_lr=e1["error"], nan_w1=e2["error"])
    out["f"] = debug_four_tasks(common, modes, retriever_ckpt)
    return out


def debug_four_tasks(common: list, modes: dict, retriever_ckpt: str) -> dict:
    """(f): ``build``, ``eval_retriever``, ``eval_gflownet`` and ``sweep``
    twice under ``experiment=debug`` and once without extras, each run a
    fresh process writing under ``DEBUG_WORK``, in ``FOUR_TASK_WAVES`` (the
    runs of a wave at once): the digests of each task's outputs
    (``testing.output_digest``) equal."""
    from evi_rag_tpu_torch.testing import output_digest

    data = [f"retriever.model.emb_dim={D}", f"retriever.model.hidden_dim={H}", "retriever.model.compute_dtype=bfloat16"]
    per_task = {
        "build": ["build.dataset=webqsp_synth", "build.raw_root=unused"],
        "eval_retriever": [*data, f"retriever.ckpt={retriever_ckpt}", "eval.splits=[validation]"],
        "eval_gflownet": [*data, f"gflownet.hidden_dim={H}", f"gflownet.ckpt={GFN_WORK / 'gfn' / 'best'}",
                          f"gflownet.g_agent_dir={GFN_WORK / 'art' / 'g_agent'}",
                          f"gflownet.eval_rollouts={GFN_EVAL_ROLLOUTS}", "eval.splits=[validation]"],
        "sweep": ["sweep=retriever_lr", "retriever=production", f"sweep.num_trials={DEBUG_SWEEP_TRIALS}",
                  "retriever.train.max_epochs=1", "retriever.train.optimizer.schedule=constant"],
    }
    runs, where = {task: {} for task in FOUR_TASKS}, {}
    for task in FOUR_TASKS:
        for name in ("off", "debug1", "debug2"):
            label, w = f"f_{task}_{name}", DEBUG_WORK / f"f_{task}_{name}"
            out_key = {"build": "build.out_dir", "sweep": None}.get(task, "eval.artifacts_dir")
            argv = [task, *common, *per_task[task], *modes[name], f"paths.log_dir={w / 'logs'}"]
            if out_key:
                argv.append(f"{out_key}={w / 'out'}")
            spec = {"argv": argv}
            if task == "build":
                spec["build_rows"] = {"gte": GTE, "rows": DEBUG_BUILD_ROWS}
            runs[task][label], where[label] = (spec, False), w
    recs, t0 = {}, time.perf_counter()
    for wave in FOUR_TASK_WAVES:
        recs.update(run_debug_children({k: v for task in wave for k, v in runs[task].items()}))
    out: dict = {}
    for task in FOUR_TASKS:
        digests = {}
        for name in ("off", "debug1", "debug2"):
            w = where[f"f_{task}_{name}"]
            if task == "sweep":
                (doc,) = (w / "logs").glob("**/sweep.json")
                roots = (doc.parent,)
                statuses = [tr["status"] for tr in json.loads(doc.read_text())["trials"]]
                if statuses != ["ok"] * DEBUG_SWEEP_TRIALS:
                    raise AssertionError(f"debug f: sweep {name} trials {statuses}")
            else:
                roots = (w / "out", sorted((w / "logs").glob("**/metrics.json"))[-1])
            digests[name] = output_digest(*roots)
        if len(set(digests.values())) != 1:
            raise AssertionError(f"debug f: {task} outputs differ: {digests}")
        task_s = {n: round(recs[f"f_{task}_{n}"]["task_s"], 1) for n in digests}
        out[task] = dict(digest=digests["off"], task_s=task_s)
        log(f"[debug f] {task} under experiment=debug twice and without extras: one output digest "
            f"{digests['off'][:16]}... in all three runs; task s {task_s}")
    out["wall_s"] = time.perf_counter() - t0
    log(f"[debug f] the twelve runs in {len(FOUR_TASK_WAVES)} waves in {out['wall_s']:.1f} s")
    return out


CROSSOVER_WIDTHS = tuple(2 ** i for i in range(3, 13))  # m_pad 8 .. 4096
CROSSOVER_ITERS = 8


def phase_crossover(smi: str) -> list:
    """``--crossover``: the card's counterpart of
    ``scripts/measure_fused_crossover.py``.  ``serve_window`` on the same
    device-resident feeds (two buckets of 16 questions, D = 1024, lengths in
    (m_pad / 2, m_pad], k = min(100, m_pad)) through kernel 3 and through the
    plain bf16 scorer, at each m_pad: wall ms per call (CUDA synchronised,
    median of 4 repetitions of CROSSOVER_ITERS calls, the two paths
    alternated plain, kernel, kernel, plain)."""
    import numpy as np
    import torch

    from evi_rag_tpu_torch.ops.score_kernels import prep_weights
    from evi_rag_tpu_torch.serving import serve_window
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = {"features": bundle_from_numpy(make_bundle(D, H, S)["features"], device=dev)}
    w = prep_weights(bundle["features"])
    rng = np.random.default_rng(0)
    vocab, rels, n_q, b_n, g_n = 4096, 512, 64, 2, 16
    ent = torch.as_tensor(rng.normal(size=(vocab, D)).astype(np.float32), device=dev)
    rel = torch.as_tensor(rng.normal(size=(rels, D)).astype(np.float32), device=dev)
    q_table = torch.as_tensor(rng.normal(size=(n_q, D)).astype(np.float32), device=dev)
    tables = {False: (ent, rel), True: (ent.to(torch.bfloat16), rel.to(torch.bfloat16))}
    rows = []
    for m_pad in CROSSOVER_WIDTHS:
        n_pad = min(max(64, m_pad // 2), 4096)
        feed = [torch.as_tensor(x, device=dev) for x in (
            rng.integers(0, n_pad - 1, size=(b_n, g_n, 2, m_pad)).astype(np.int32),
            rng.integers(0, vocab, size=(b_n, g_n, n_pad)).astype(np.int32),
            rng.integers(0, rels, size=(b_n, g_n, m_pad)).astype(np.int32),
            rng.integers(m_pad // 2 + 1, m_pad + 1, size=(b_n, g_n)).astype(np.int32),
            (rng.random(size=(b_n, g_n, n_pad)) < 0.05).astype(np.uint8),
            np.full((b_n, g_n), n_pad, np.int32),
            rng.integers(0, n_q, size=(b_n, g_n)).astype(np.int32))]
        k = min(K, m_pad)

        def call(fused: bool):
            return serve_window(bundle, q_table, *tables[fused], *feed, k=k, num_rounds=2, num_reverse_rounds=2,
                                dtype=torch.bfloat16, use_fused=fused, weights=w if fused else None)

        times: dict = {False: [], True: []}
        for fused in (False, True):
            call(fused)
        for fused in (False, True, True, False) * 2:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(CROSSOVER_ITERS):
                call(fused)
            torch.cuda.synchronize()
            times[fused].append((time.perf_counter() - t) * 1e3 / CROSSOVER_ITERS)
        row = dict(m_pad=m_pad, k=k, plain_ms=median(times[False]), kernel_ms=median(times[True]))
        row["kernel_speedup"] = row["plain_ms"] / row["kernel_ms"]
        rows.append(row)
        log(f"[crossover] m_pad {m_pad:5d} (k {k:3d}): plain bf16 scorer {row['plain_ms']:8.3f} ms, kernel 3 "
            f"{row['kernel_ms']:8.3f} ms per serve_window call ({b_n} x {g_n} questions), kernel speedup "
            f"{row['kernel_speedup']:.3f}x")
    first = next((r["m_pad"] for r in rows if all(x["kernel_speedup"] > 1.0 for x in rows if x["m_pad"] >= r["m_pad"])),
                 None)
    log(json.dumps({"crossover": rows, "kernel_faster_from_m_pad": first, "fused_threshold_default": 256,
                    "nvidia_smi": smi}))
    return rows


def wgmma_ptxas(sources) -> list[str]:
    """The ptxas report (registers, spills) of each wgmma kernel of
    ``sources``, with its dynamic shared memory (the same for every mode)."""
    from evi_rag_tpu_torch.ops import _build, score_kernels as sk

    smem = sk._lib(sk.SCORE_SOURCE).sb_wg_smem_bytes()
    out = []
    for source in sources:
        lines = _build.BUILD_LOG.get(source, "").splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry" in ln and "wg_kernel" in ln:
                mode = ln.split("wg_kernelILi")[1][0]
                report = " ".join(x.strip() for x in lines[i + 1:i + 4]
                                  if "spill" in x or "registers" in x)
                out.append(f"{source} wg_kernel<{mode}>: {report}; dynamic smem {smem} B")
    return out


ABLATIONS = {"full": [], "no_epilogue": ["-DWG_NO_EPI"], "no_wgmma": ["-DWG_NO_MMA"],
             "no_row_build": ["-DWG_NO_BUILD"]}
# Built for the per-question kernel only: its GELU priced, and the clock64 trace.
PQT_VARIANTS = {"gelu_identity": ["-DWG_GELU_ID"], "trace": ["-DWG_TRACE"]}


def phase_ablation(m: int) -> None:
    """Each wgmma kernel built with each ablation switch, timed in turns: the
    pooled ones at B = POOLED_B over m random candidates, the per-question
    one at G = 16, M = REPORT_M (phase 3's input)."""
    import ctypes

    import numpy as np
    import torch

    from evi_rag_tpu_torch.ops import _build, score_kernels as sk
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    variants = [(source, name, flags) for source in sk.KERNEL_SOURCES for name, flags in ABLATIONS.items()]
    variants += [(sk.KERNEL_SOURCE, name, flags) for name, flags in PQT_VARIANTS.items()]
    for source, name, flags in variants:
        lib = out / f"{source}.{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", str(lib), str(_build.CSRC / source)]
        procs[source, name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                     text=True))
    for (source, name), (lib, proc) in procs.items():
        log_text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc {source} {name}:\n{log_text}")
    dev = torch.device("cuda")
    bundle = {"features": bundle_from_numpy(make_bundle(D, H, S, seed=11)["features"], device=dev)}
    w = sk.prep_weights(bundle["features"])
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = [torch.tanh(torch.randn(m, D, device=dev, generator=gen)).to(torch.bfloat16) for _ in range(3)]
    rows.append(torch.randn(m, S, device=dev, generator=gen).to(torch.bfloat16))
    q = torch.randn(POOLED_B, D, device=dev, generator=gen)
    for source, entry, fused in ((sk.SCORE_SOURCE, "sb_forward", False), (sk.POOLED_SOURCE, "pq_forward", True)):
        for name in ABLATIONS:
            sk._LIBS[source] = sk.type_entries(ctypes.CDLL(str(procs[source, name][0])), source)
            ms = cuda_ms(lambda: sk._pooled_scores(source, entry, "ablation", bundle, q, rows, w, fused=fused), 2)
            log(f"[ablation] {source} {name}: {ms:.3f} ms at B = {POOLED_B}, M = {m}; "
                f"{ms * POOLED_M / m:.1f} ms scaled to M = {POOLED_M}")
        sk._LIBS.pop(source)
    del rows, q

    # The per-question kernel at phase 3's shape and lengths (same seeds).
    rng = np.random.default_rng(5)
    for shape_m in SHAPES_M:  # phase 3 draws each shape's lengths in turn
        lens = rng.integers(K // 2, shape_m + 1, size=G)
        if shape_m == REPORT_M:
            break
    lens[0], lens[1], lens[2] = REPORT_M, 37, 0
    lengths = torch.as_tensor(lens.astype(np.int32), device=dev)
    rand = lambda *shape: torch.tanh(torch.randn(*shape, device=dev, generator=gen))
    args = (bundle, torch.randn(G, D, device=dev, generator=gen),
            *(rand(G, REPORT_M, D).to(torch.bfloat16) for _ in range(3)),
            torch.rand(G, REPORT_M, S, device=dev, generator=gen).to(torch.bfloat16), lengths)
    live_tiles = int(sum(-(-min(int(n), REPORT_M) // 128) for n in lens))
    pqt = lambda: sk.per_question_topk(*args, k=K, weights=w)
    for name in [*ABLATIONS, *(v for v in PQT_VARIANTS if v != "trace")]:
        sk._LIBS[sk.KERNEL_SOURCE] = sk.type_entries(ctypes.CDLL(str(procs[sk.KERNEL_SOURCE, name][0])),
                                                     sk.KERNEL_SOURCE)
        ms = cuda_ms(pqt, 20)
        log(f"[ablation] {sk.KERNEL_SOURCE} {name}: {ms:.4f} ms at G = {G}, M = {REPORT_M} "
            f"({live_tiles} live tiles of 128 edges)")
        if name != "full":
            continue
        want = pqt()
        sk.PQT_CLUSTERS = G * (-(-REPORT_M // 128))  # one cluster per (question, tile), dead ones return at once
        try:
            per_tile_ms = cuda_ms(pqt, 20)
            got = pqt()
        finally:
            sk.PQT_CLUSTERS = 0
        if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])):
            raise AssertionError("the two schedules of the per-question kernel gave other bits")
        log(f"[ablation] {sk.KERNEL_SOURCE} full, one cluster per (question, tile): {per_tile_ms:.4f} ms "
            f"(persistent clusters {ms:.4f} ms); bitwise the same output")
        for kname, kms in launch_device_ms(pqt, 10).items():
            log(f"[ablation] {sk.KERNEL_SOURCE} full, device ms per call: {kms:.4f}  {kname[:80]}")
    lib = sk.type_entries(ctypes.CDLL(str(procs[sk.KERNEL_SOURCE, "trace"][0])), sk.KERNEL_SOURCE)
    sk._LIBS[sk.KERNEL_SOURCE] = lib
    pqt()
    pqt()
    torch.cuda.synchronize()
    marks = np.zeros(512 * 8 + 16 * 4, np.int64)
    lib.wg_trace_read.argtypes = [ctypes.c_void_p]
    if lib.wg_trace_read(marks.ctypes.data):
        raise RuntimeError("reading the trace failed")
    report_trace(marks, D // 64)
    sk._LIBS.pop(sk.KERNEL_SOURCE)


def report_trace(marks, kc: int) -> None:
    """Where the first CTA's clock64 marks (WG_TRACE) say its steps and
    epilogues spend their cycles: per step kind (inter, struct, err) the
    median of each wait, and per work item the epilogue's exchanges."""
    import numpy as np

    steps = marks[: 512 * 8].reshape(512, 8)
    n = int((steps[:, 4] > 0).sum())
    steps = steps[:n].astype(np.float64)
    epi = marks[512 * 8:].reshape(16, 4).astype(np.float64)
    epi = epi[epi[:, 3] > 0]
    names = {"consumer W1 wait": (0, 1), "consumer A wait": (1, 2), "consumer wgmma": (2, 3),
             "consumer release+refill": (3, 4), "builder empty wait": (5, 6), "builder build+push": (6, 7)}
    kind = (np.arange(n) % (3 * kc)) // kc
    out = {"steps": n, "items": len(epi), "cycles": float(steps[-1, 4] - steps[0, 0])}
    for k, label in enumerate(("inter", "struct", "err")):
        sel = steps[kind == k]
        step_len = np.diff(steps[:, 0])[kind[:-1] == k]
        row = {name: float(np.median(sel[:, b] - sel[:, a])) for name, (a, b) in names.items()}
        row["step"] = float(np.median(step_len))
        out[label] = row
        log(f"[trace] {label} steps: median cycles " + ", ".join(f"{k2} {v:.0f}" for k2, v in row.items()))
    if len(epi):
        parts = {"z + exchange 1": np.median(epi[:, 1] - epi[:, 0]), "LN var + exchange 2": np.median(epi[:, 2] - epi[:, 1]),
                 "GELU, head + exchange 3": np.median(epi[:, 3] - epi[:, 2])}
        out["epilogue"] = {k2: float(v) for k2, v in parts.items()}
        log("[trace] epilogue per item: median cycles " + ", ".join(f"{k2} {v:.0f}" for k2, v in parts.items()))
    log(f"[trace] first CTA: {n} steps, {len(epi)} items, {out['cycles']:.0f} cycles in the mainloop and epilogues")
    (OUT_DIR / "pqt_trace.json").write_text(json.dumps({"summary": out, "marks": marks.tolist()}))


def launch_device_ms(fn, calls: int) -> dict[str, float]:
    """Device ms per call of each kernel ``fn`` launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev_us and ev.key and not ev.key.startswith(("aten::", "cuda")):
            out[ev.key] = dev_us / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


# Phase 12: the kernel route's shape limits (12a) and the quality lane on the
# card (12b); ``--quality`` runs the WebQSP-scale chain at D = 1024.
ROUTE_DIR = OUT_DIR / "chip_smoke_route"   # 12a: the CLI runs' logs stay
ROUTE_QUESTIONS = 64        # 12a: the realistic split (seed 7) cut to 4 groups of 16
# (label, emb_dim, hidden, DDE rounds each way, k, the limit the router names)
ROUTE_CASES = (
    ("emb_dim 96", 96, H, 2, K, "D=96: kernel needs D % 64 == 0"),
    ("S = 36", D, H, 4, K, "S=36: kernel needs S <= 32"),
    ("k = 1500", D, H, 2, 1500, "k=1500: kernel needs 1 <= k <= 1024"),
)
ROUTE_B, ROUTE_M = 70_000, 1024   # 12a: pooled queries past one launch's 65,535
ROUTE_ROWS = (0, 1, 2, 3, 65531, 65532, 65533, 65534, 65535, 65536, 65537, 65538, 69996, 69997, 69998, 69999)
QUALITY_DIR = OUT_DIR / "chip_smoke_quality"  # 12b and --quality: logs stay
QUALITY_WORK = QUALITY_DIR / "work"           # checkpoints, stores and artifacts, removed when a phase ends
# 12b: the port's quality baseline at seed 0 must lie inside the bar that
# JAX's seed spread (seeds 0-2, the CPU, ``tests/test_torch_quality_baseline.py``)
# sets: [min - (max - min) - 0.03, max + (max - min) + 0.03].
QUALITY_BAR = {
    "edge/recall@10": (0.7256818183511495, 0.846030849236995),
    "answer/reachability@10": (0.5325, 0.78),
    "oracle/answer_hit@10": (0.68875, 0.93625),
    "gflownet/answer_hit@4": (0.50125, 0.74875),
}
EVAL_ATOL = 1e-4            # 12b / 12c: eval metrics, the card vs the CPU at f32
EVAL_GFN_SAMPLES = 32       # 12c: the first agent samples of 8a's validation store (4 batches of 8)
# --quality: round 4 of docs/RESULTS_synthetic.md (JAX, TPU v5e): quality
# values to set the card's beside, never times.
ROUND4 = {
    "train_retriever answer/reachability@100 (validation)": 0.894,
    "eval edge/recall@10 train / validation / test": (0.553, 0.537, 0.539),
    "eval edge/recall@100": (0.803, 0.804, 0.810),
    "eval answer/reachability@100": (0.919, 0.894, 0.920),
    "eval answer_recall@100": (0.877, 0.855, 0.881),
    "eval edge/score_margin": (-8.72, -9.00, -8.41),
    "eval edge/margin_positive_rate": (0.231, 0.187, 0.205),
    "eval ranking/mrr": (0.745, 0.688, 0.671),
    "eval ranking/ndcg@10": (0.645, 0.599, 0.592),
    "eval_gflownet answer_hit@25 validation / test": (0.65, 0.67),
    "eval_gflownet test answer_hit@1 / @10 / @25": (0.24, 0.53, 0.67),
    "reasoner oracle hit@100 validation / test": (0.83, 0.81),
    "serve recall@100 (validation + test)": 0.81,
}
# --quality: the JAX package's values on the reduced CPU chain
# (``tests/test_torch_quality_baseline.py --chain``: the same preset cut to
# 512 / 64 / 64 questions, D = H = 64, 8 epochs, JAX's own init at bf16),
# validation only, the mean over seeds 0-2 at each seed's best epoch (the
# checkpoint the card's rows report).  Reduced scale: a neighbour of the
# card's run, not its reference.
CPU_CHAIN_JAX = {
    "train_retriever answer/reachability@100 (validation)": 0.406,
    "eval edge/recall@10 train / validation / test": (None, 0.060, None),
    "eval edge/recall@100": (None, 0.447, None),
}


def phase_route(smi: str, bundle_np, serve_ctx) -> dict:
    """12a: ``serve`` (the CLI, then ``serve_split``) of a realistic split at
    each shape the kernels refuse, held to the plain serve; phase 4's serve
    again (17 kernel-3 launches, bit for bit) and ``PQT_DIGEST``; kernels 1
    and 2 over more queries than one launch takes."""
    import torch

    from evi_rag_tpu_torch.testing import PQT_DIGEST, pqt_digest

    out = {"nvidia_smi": smi, "serve": {case[0]: route_serve(*case) for case in ROUTE_CASES}}
    out["phase4"] = route_phase4(serve_ctx)
    digest = pqt_digest(torch.device("cuda"))
    if digest != PQT_DIGEST:
        raise AssertionError(f"12a: per_question_topk output changed: digest {digest} != {PQT_DIGEST}")
    log(f"[12a route] kernel 3 on its fixed input: PQT_DIGEST held (sha256 {digest[:16]}...)")
    out["pooled"] = route_pooled(bundle_np)
    return out


def route_serve(label: str, emb: int, hidden: int, rounds: int, k: int, limit: str) -> dict:
    """One shape the kernels refuse: ``serve`` through the CLI (exit 0, its
    metrics, jsonl and manifest, one routing line naming ``limit``, no kernel
    launch), then ``serve_split`` on the same split bit for bit the plain
    serve (every bucket on the plain bf16 scorer) and held to the plain full
    ranking by phase 4's rule."""
    import logging
    from unittest import mock

    import numpy as np

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.serving import project_tables, serve_recall_at_k, serve_split
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy, save_checkpoint

    s = 4 * (1 + 2 * rounds)
    work = ROUTE_DIR / label.replace(" ", "").replace("=", "")
    ds = make_synthetic_dataset(num_samples=ROUTE_QUESTIONS, seed=7, **{**REALISTIC, "emb_dim": emb})
    np_bundle = make_bundle(emb, hidden, s, seed=17)
    ckpt = work / "ckpt"
    save_checkpoint(ckpt, {"params": np_bundle["features"]},
                    meta={"parity_meta": {"dde_rounds": rounds, "dde_reverse_rounds": rounds}})
    routed: list[str] = []

    class Lines(logging.Handler):
        def emit(self, record):
            routed.append(record.getMessage())

    handler = Lines(level=logging.WARNING)
    serving_log = logging.getLogger("evi_rag_tpu_torch.serving")
    serving_log.addHandler(handler)
    load_split = lambda cfg, split: (ds.samples, ds.entity_emb, ds.relation_emb, ds.question_emb)  # noqa: E731
    try:
        reset_launches()
        with mock.patch.object(cli, "_load_split", load_split):
            rc = cli.main(["serve", "--configs-dir", str(ROOT / "configs"), f"retriever.ckpt={ckpt}",
                           "serve.splits=[validation]", f"serve.k={k}", f"retriever.model.dde_rounds={rounds}",
                           f"retriever.model.dde_reverse_rounds={rounds}", "extras.print_config=false",
                           f"paths.log_dir={work / 'logs'}"])
        cli_launches = sk.per_question_topk.launches
    finally:
        serving_log.removeHandler(handler)
    files = sorted((work / "logs").glob("**/metrics.json"))
    if rc != 0 or not files:
        raise AssertionError(f"12a {label}: serve exit {rc}, metrics {files}")
    run = files[-1].parent
    metrics = json.loads(files[-1].read_text())
    for name in ("validation_serve.jsonl", "validation.manifest.json"):
        if not (run / name).exists():
            raise AssertionError(f"12a {label}: serve wrote no {name}")
    lines = [ln for ln in routed if "kernel needs" in ln]
    if cli_launches or len(lines) != 1 or limit not in lines[0]:
        raise AssertionError(f"12a {label}: kernel-3 launches {cli_launches}, routing lines {lines}")

    bundle = {"features": bundle_from_numpy(np_bundle["features"], device="cuda")}
    projected = project_tables(bundle, ds.entity_emb, ds.relation_emb, device="cuda")
    kw = dict(entity_emb=ds.entity_emb, relation_emb=ds.relation_emb, question_emb=ds.question_emb,
              num_rounds=rounds, num_reverse_rounds=rounds, projected=projected, device="cuda")
    serve_split(bundle, ds.samples, k=k, **kw)  # warm
    reset_launches()
    results, st = serve_split(bundle, ds.samples, k=k, **kw)
    if sk.per_question_topk.launches:
        raise AssertionError(f"12a {label}: serve_split launched kernel 3")
    plain, plain_st = serve_split(bundle, ds.samples, k=k, fused_threshold=1 << 30, **kw)
    for a, b in zip(results, plain):
        if not (np.array_equal(a.edge_ids, b.edge_ids) and np.array_equal(a.scores, b.scores)):
            raise AssertionError(f"12a {label}: {a.sample_id} differs from the plain serve")
    full, _ = serve_split(bundle, ds.samples, k=FULL_RANK, fused_threshold=1 << 30, **kw)  # every edge ranked
    _, swapped, max_err = check_against_plain(ds.samples, results, full)
    k_grid = [10, 100]
    rec = serve_recall_at_k(ds.samples, results, k_grid)
    cli_rec = {key: metrics[f"validation/{key}"] for key in rec}
    if any(abs(rec[key] - cli_rec[key]) > 1e-9 for key in rec):
        raise AssertionError(f"12a {label}: the CLI's recall {cli_rec} vs serve_split's {rec}")
    if any(r.edge_ids.size != min(k, smp.edge_index.shape[1]) for r, smp in zip(results, ds.samples)):
        raise AssertionError(f"12a {label}: a question got a short answer")
    log(f"[12a route] {label} (D = {emb}, H = {hidden}, S = {s}, k = {k}): serve exit 0 with metrics, jsonl and "
        f"manifest, 0 kernel-3 launches, routing line \"{lines[0]}\"; serve_split bit for bit the plain serve "
        f"({ROUTE_QUESTIONS} questions); vs the plain full ranking max score error {max_err:.3e}, near-tie swaps "
        f"{swapped}/{ROUTE_QUESTIONS}; recall {rec} (CLI {cli_rec}); q/s {st.queries_per_s} (plain serve "
        f"{plain_st.queries_per_s})")
    return dict(shape=dict(d=emb, h=hidden, s=s, k=k), routing_line=lines[0], cli_launches=cli_launches,
                max_abs_err=max_err, swapped=swapped, recall=rec, qps=st.queries_per_s)


def route_phase4(ctx) -> dict:
    """Phase 4's serve again: 17 kernel-3 launches, bit for bit its ids and
    scores."""
    import numpy as np

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.serving import serve_split

    bundle, ds, kw, results, _ = ctx
    reset_launches()
    again, st = serve_split(bundle, ds.samples, **kw)
    launches = sk.per_question_topk.launches
    if launches != st.num_groups + 1 or launches != QUESTIONS // G + 1:
        raise AssertionError(f"12a: phase 4's serve made {launches} kernel-3 launches")
    if not all(np.array_equal(a.edge_ids, b.edge_ids) and np.array_equal(a.scores, b.scores)
               for a, b in zip(results, again)):
        raise AssertionError("12a: phase 4's serve changed")
    log(f"[12a route] phase 4's serve (D = {D}, S = {S}, k = {K}): {launches} kernel-3 launches, ids and scores "
        f"bit for bit phase 4's; {st.queries_per_s} q/s")
    return dict(launches=launches, qps=st.queries_per_s)


def route_pooled(bundle_np) -> dict:
    """Kernels 1 and 2 at ROUTE_B queries over ROUTE_M candidates: two
    launches each (65,535 + 4,465 queries), the joined rows at the chunks'
    edges and ends held to the plain versions."""
    import torch

    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.ops.query import build_triple_index
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy

    dev = torch.device("cuda", torch.cuda.current_device())
    bundle = {"features": bundle_from_numpy(bundle_np["features"], device=dev)}
    gen = torch.Generator(device=dev).manual_seed(19)
    index = build_triple_index(
        bundle, entity_emb=torch.randn(ENTITIES, D, device=dev, generator=gen),
        relation_emb=torch.randn(RELATIONS, D, device=dev, generator=gen),
        nontext_mask=torch.rand(ENTITIES, device=dev, generator=gen) < 0.01,
        heads=torch.randint(0, ENTITIES, (ROUTE_M,), device=dev, generator=gen),
        rels=torch.randint(0, RELATIONS, (ROUTE_M,), device=dev, generator=gen),
        tails=torch.randint(0, ENTITIES, (ROUTE_M,), device=dev, generator=gen),
        struct_raw=torch.randn(ROUTE_M, S, device=dev, generator=gen), device=dev).to(dtype=torch.bfloat16)
    q = torch.randn(ROUTE_B, D, device=dev, generator=gen)
    w = sk.prep_weights(bundle["features"])
    plan = sk.query_chunks(ROUTE_B)
    ms, out = {}, {}
    reset_launches()
    for name, fn in (("per_query", sk.query_topk_per_query), ("fused", sk.query_topk_fused)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out[name] = fn(bundle, q, index, k=K, weights=w)
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end)
    launches = {"score_bidirectional": sk.score_bidirectional.launches,
                "query_topk_fused": sk.query_topk_fused.launches}
    if launches != {"score_bidirectional": len(plan), "query_topk_fused": len(plan)} or len(plan) != 2:
        raise AssertionError(f"12a: pooled launches {launches} for the chunk plan {plan}")
    rows = torch.tensor(ROUTE_ROWS, device=dev)
    cand = (index.head_repr, index.rel_repr, index.tail_repr, index.struct_raw)
    plain1 = sk.score_bidirectional_reference(bundle, q[rows], *cand, weights=w)
    plain2 = sk.fused_scores_reference(bundle, q[rows], *cand, weights=w)
    err1, diff1 = hold_to_plain(out["per_query"][0][rows], out["per_query"][1][rows], plain1, K)
    err2, diff2 = hold_to_plain(out["fused"][0][rows], out["fused"][1][rows], plain2, K)
    for name, (v, i) in out.items():
        if v.shape != (ROUTE_B, K) or i.shape != (ROUTE_B, K) or not torch.isfinite(v).all():
            raise AssertionError(f"12a {name}: output {tuple(v.shape)} / {tuple(i.shape)} or not finite")
    log(f"[12a route] B = {ROUTE_B} queries over M = {ROUTE_M} (D = {D}, k = {K}), query chunks {plan}: launches "
        f"{launches}; rows {list(ROUTE_ROWS)} vs plain: kernel 1 max_abs_err {err1:.3e} differing ids {diff1}, "
        f"kernel 2 max_abs_err {err2:.3e} differing ids {diff2} (tol {ATOL}, near-tie {TIE_TOL}); ms per call "
        f"query_topk_per_query {ms['per_query']:.3f}, query_topk_fused {ms['fused']:.3f}")
    return dict(plan=plan, launches=launches, max_abs_err={"score_bidirectional": err1, "query_topk_fused": err2},
                differing_ids={"per_query": diff1, "fused": diff2}, ms=ms)


def phase_quality(smi: str) -> dict:
    """12b: the quality gate on the card (its floors must hold), the quality
    baseline at seed 0 against the seed-spread bar, and ``eval_retriever``
    of the baseline's retriever on the card against the CPU at f32."""
    from evi_rag_tpu_torch.scripts import benchmark_quality, quality_gate

    QUALITY_DIR.mkdir(parents=True, exist_ok=True)
    out = {"nvidia_smi": smi}
    t0 = time.perf_counter()
    gate, _ = quality_gate.quality_gate("cuda")
    gate_s = time.perf_counter() - t0
    failed = quality_gate.failed_floors(gate)
    if failed or gate["bridge/pos_graph_frac"] != 1.0:
        raise AssertionError(f"12b gate: below the floors {failed}: {gate}")
    log(f"[12b gate] the quality gate trained on the card from the port's init in {gate_s:.1f} s: " + ", ".join(
        f"{m} {gate[m]:.4f} (floor {f})" for m, f in quality_gate.FLOORS.items())
        + f", bridge/pos_graph_frac {gate['bridge/pos_graph_frac']}; {smi}")
    out["gate"] = dict(metrics={m: gate[m] for m in (*quality_gate.FLOORS, "bridge/pos_graph_frac")}, s=gate_s)

    t0 = time.perf_counter()
    result = benchmark_quality.run(seed=0, device="cuda")
    grid = benchmark_quality.metric_grid(result)
    base_s = time.perf_counter() - t0
    outside = [m for m, (lo, hi) in QUALITY_BAR.items() if not lo <= grid[m] <= hi]
    log(f"[12b baseline] benchmark_quality at seed 0 on the card (128 train / {result['test_samples']} test, emb 64, "
        f"10 + 5 epochs) in {base_s:.1f} s: " + ", ".join(
            f"{m} {grid[m]:.4f} (bar [{lo:.4f}, {hi:.4f}])" for m, (lo, hi) in QUALITY_BAR.items()))
    log(f"[12b baseline] grid {json.dumps(grid)}")
    if outside:
        raise AssertionError(f"12b baseline: {outside} outside the seed-spread bar")
    out["baseline"] = dict(grid=grid, s=base_s)
    try:
        out["eval"] = eval_card_vs_cpu(result)
    finally:
        shutil.rmtree(QUALITY_WORK, ignore_errors=True)
    return out


def eval_card_vs_cpu(result) -> dict:
    """``eval_retriever`` of the baseline's retriever over its test split,
    on the card and on the CPU (f32; TF32 is off, phase 1): every metric
    within EVAL_ATOL, and each question's ranked edges equal by the
    near-tie rule (a pair in one order on the card and the other on the CPU
    only where the CPU scores are within EVAL_ATOL)."""
    from unittest import mock

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.synthetic import make_synthetic_dataset
    from evi_rag_tpu_torch.scripts.benchmark_quality import KS
    from evi_rag_tpu_torch.train.checkpoint import save_checkpoint

    ckpt = QUALITY_WORK / "retriever"
    save_checkpoint(ckpt, result["retriever_params"], meta={"parity_meta": result["parity_meta"]})
    test = make_synthetic_dataset(num_samples=result["test_samples"], seed=100, emb_dim=64, max_nodes=32,
                                  distractor_relation_overlap=0.15)
    load_split = lambda cfg, split: (test.samples, test.entity_emb, test.relation_emb, test.question_emb)  # noqa: E731
    metrics, ranked, wall = {}, {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        with mock.patch.object(cli, "_load_split", load_split):
            rc = cli.main(["eval_retriever", "--configs-dir", str(ROOT / "configs"), f"device={dev}",
                           f"retriever.ckpt={ckpt}", "retriever.model.emb_dim=64", "retriever.model.hidden_dim=64",
                           "retriever.model.hide_seek.enabled=false", "eval.splits=[test]",
                           f"retriever.train.k_values=[{', '.join(map(str, KS))}]",
                           f"eval.artifacts_dir={QUALITY_WORK / dev}", "extras.print_config=false",
                           f"paths.log_dir={QUALITY_DIR / 'logs' / f'eval_{dev}'}"])
        wall[dev] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"12b eval_retriever on {dev}: exit {rc}")
        metrics[dev] = latest_metrics(QUALITY_DIR / "logs" / f"eval_{dev}")
        with (QUALITY_WORK / dev / "eval_retriever" / "test.jsonl").open() as f:
            ranked[dev] = [json.loads(ln) for ln in f]
    keys = sorted(k for k in metrics["cpu"] if "/phase/" not in k and isinstance(metrics["cpu"][k], (int, float)))
    if sorted(k for k in metrics["cuda"] if k in set(keys)) != keys:
        raise AssertionError("12b eval: the card and the CPU report other metrics")
    max_diff = max(abs(metrics["cuda"][k] - metrics["cpu"][k]) for k in keys)
    if max_diff > EVAL_ATOL:
        worst = max(keys, key=lambda k: abs(metrics["cuda"][k] - metrics["cpu"][k]))
        raise AssertionError(f"12b eval: {worst} card {metrics['cuda'][worst]} vs CPU {metrics['cpu'][worst]}")
    top = str(max(KS))
    swaps = max_score_diff = 0
    for rc_, rp in zip(ranked["cuda"], ranked["cpu"]):
        card = rc_["triplets_by_k"][top]
        cpu = {e["edge_idx"]: e["score"] for e in rp["triplets_by_k"][top]}
        if rc_["sample_id"] != rp["sample_id"] or {e["edge_idx"] for e in card} != set(cpu):
            raise AssertionError(f"12b eval {rc_['sample_id']}: other edges ranked on the card")
        for e in card:
            max_score_diff = max(max_score_diff, abs(e["score"] - cpu[e["edge_idx"]]))
        for a, b in zip(card, card[1:]):
            if cpu[a["edge_idx"]] < cpu[b["edge_idx"]]:
                if cpu[b["edge_idx"]] - cpu[a["edge_idx"]] > EVAL_ATOL:
                    raise AssertionError(f"12b eval {rc_['sample_id']}: edges {a['edge_idx']}, {b['edge_idx']} "
                                         "ranked apart from the CPU beyond the near-tie rule")
                swaps += 1
    if max_score_diff > EVAL_ATOL:
        raise AssertionError(f"12b eval: edge scores differ by {max_score_diff:.3e} > {EVAL_ATOL}")
    log(f"[12b eval] eval_retriever of the baseline's retriever over its {len(ranked['cpu'])}-question test split, "
        f"card vs CPU (f32): {len(keys)} metrics within {max_diff:.3e} (tol {EVAL_ATOL}); ranked edges equal by the "
        f"near-tie rule ({swaps} adjacent near-tie swaps; edge scores within {max_score_diff:.3e}); task wall s card "
        f"{wall['cuda']:.1f}, CPU {wall['cpu']:.1f}")
    return dict(metrics=len(keys), max_metric_diff=max_diff, swaps=swaps, max_score_diff=max_score_diff, wall_s=wall)


def phase_eval_gflownet_card_vs_cpu(smi: str, load_split, *, devices: tuple[str, str] = ("cuda", "cpu")) -> dict:
    """12c: ``eval_gflownet`` of 8b's checkpoint over the first
    ``EVAL_GFN_SAMPLES`` samples of 8a's validation store, through the CLI on
    the card and on the CPU (f32, TF32 off), with one set of rollout draws:
    each rollout's Gumbel uniforms are made by ``actor.make_rollout_draws``
    on a CPU generator seeded 7 (one per run, so both runs draw the same
    numbers in the same order) and moved to the rollout's device.  The
    rollouts, hits and records must be equal and every metric within
    ``EVAL_ATOL``; an action may differ only at a near tie (8f's rule:
    Gumbel margin <= ``STS_MARGIN`` x max(1, |score|) at the first differing
    step, replayed on the CPU), and then only that graph's record and the
    metrics by its share.  ``load_split`` gives the tables of 8a's splits
    (``realistic_loader``); ``devices`` names the two runs (a dry run on a
    machine without a card passes ``("cpu", "cpu")``)."""
    import itertools
    import types
    from unittest import mock

    import numpy as np
    import torch

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.models.gflownet import actor
    from evi_rag_tpu_torch.testing import STS_MARGIN, gumbel_margin
    from evi_rag_tpu_torch.train import gflownet_trainer as gt

    configs, art = str(ROOT / "configs"), GFN_WORK / "art"
    make_draws, agent_batches, rollout = actor.make_rollout_draws, cli._agent_batches_fn, gt.rollout
    actions: dict[str, list] = {}
    near_ties: list[dict] = []
    made: dict = {}
    metrics, records, wall = {}, {}, {}

    def first_samples(cfg, split, batch_size, **kw):
        if EVAL_GFN_SAMPLES % batch_size:
            raise ValueError(f"12c: {EVAL_GFN_SAMPLES} samples are no whole number of batches of {batch_size}")
        samples, batches, emb = agent_batches(cfg, split, batch_size, **kw)
        return samples[:EVAL_GFN_SAMPLES], lambda epoch=0: itertools.islice(
            batches(epoch), EVAL_GFN_SAMPLES // batch_size), emb

    for run, dev in zip(("card", "cpu"), devices):
        gen = torch.Generator().manual_seed(7)
        seen = actions.setdefault(run, [])

        def cpu_draws(config, batch, **kw):
            gb = batch.graph
            stand_in = types.SimpleNamespace(graph=types.SimpleNamespace(
                edge_batch=torch.empty(0), num_edges=gb.num_edges, num_graphs=gb.num_graphs))
            kw["generator"] = gen
            made["draws"] = {k: v.to(gb.edge_batch.device) for k, v in make_draws(config, stand_in, **kw).items()}
            return made["draws"]

        def recorded(**kw):
            ro = rollout(**kw)
            kw["draws"] = made["draws"]  # the eval rollout draws its own (through cpu_draws)
            acts = ro["actions_seq"].cpu()
            if run == "cpu":  # the card's run came first: compare this call's actions with its
                card = actions["card"][len(seen)]
                for gi in torch.nonzero((acts != card).any(dim=1)).flatten().tolist():
                    step = int(torch.nonzero(acts[gi] != card[gi])[0])
                    margin, score = gumbel_margin(kw, acts, gi, step)
                    near_ties.append(dict(call=len(seen), graph=gi, step=step, margin=margin, score=score,
                                          near_tie=margin <= STS_MARGIN * max(1.0, abs(score))))
            seen.append(acts)
            return ro

        logs = GFN_DIR / "logs" / f"eval_gflownet_12c_{run}"
        t0 = time.perf_counter()
        with mock.patch.object(actor, "make_rollout_draws", cpu_draws), mock.patch.object(gt, "rollout", recorded), \
                mock.patch.object(cli, "_agent_batches_fn", first_samples), \
                mock.patch.object(cli, "_load_split", load_split):
            rc = cli.main(["eval_gflownet", "--configs-dir", configs, f"device={dev}", f"retriever.model.emb_dim={D}",
                           f"retriever.model.hidden_dim={H}", f"gflownet.hidden_dim={H}",
                           f"gflownet.ckpt={GFN_WORK / 'gfn' / 'best'}", f"gflownet.g_agent_dir={art / 'g_agent'}",
                           f"gflownet.eval_rollouts={GFN_EVAL_ROLLOUTS}", "eval.splits=[validation]",
                           f"eval.artifacts_dir={GFN_WORK / f'eval_12c_{run}'}", "extras.print_config=false",
                           f"paths.log_dir={logs}"])
        wall[run] = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"12c eval_gflownet on {dev}: exit {rc}")
        metrics[run] = latest_metrics(logs)
        path = GFN_WORK / f"eval_12c_{run}" / "eval_gflownet" / "validation.jsonl"
        records[run] = [json.loads(ln) for ln in path.read_text().splitlines()]
    far = [t for t in near_ties if not t["near_tie"]]
    if far:
        raise AssertionError(f"12c: actions differ away from a near tie: {far}")
    if len(records["card"]) != len(records["cpu"]) or len(records["cpu"]) != EVAL_GFN_SAMPLES:
        raise AssertionError(f"12c: {len(records['card'])} / {len(records['cpu'])} records")
    differing = [i for i, (a, b) in enumerate(zip(records["card"], records["cpu"])) if a != b]
    allowed = len({(t["call"], t["graph"]) for t in near_ties})
    if len(differing) > allowed:
        raise AssertionError(f"12c: records {differing} differ, {allowed} near ties")
    keys = sorted(k for k in metrics["cpu"] if isinstance(metrics["cpu"][k], (int, float)))
    if sorted(k for k in metrics["card"] if k in set(keys)) != keys:
        raise AssertionError("12c: the card and the CPU report other metrics")
    # Within EVAL_ATOL of O(1) values (relative above 1), plus each near-tie
    # graph's share of a rate.
    diff = {k: abs(metrics["card"][k] - metrics["cpu"][k]) / max(1.0, abs(metrics["cpu"][k])) for k in keys}
    worst = max(diff, key=diff.get)
    slack = EVAL_ATOL + allowed / EVAL_GFN_SAMPLES
    if diff[worst] > slack:
        raise AssertionError(f"12c: {worst} card {metrics['card'][worst]} vs CPU {metrics['cpu'][worst]}")
    hits = sum(r["answer_hit_rate"] > 0 for r in records["cpu"])
    log(f"[12c eval_gflownet] 8b's checkpoint on the first {EVAL_GFN_SAMPLES} samples of 8a's validation store, "
        f"{GFN_EVAL_ROLLOUTS} rollouts, card vs CPU (f32, TF32 off, one set of draws made on a CPU generator): "
        f"{len(records['cpu'])} records, {len(differing)} differing; actions differing at "
        f"{len(near_ties)} graph(s), all at near ties ({[round(t['margin'], 9) for t in near_ties]}); {len(keys)} "
        f"metrics within {diff[worst]:.3e} (worst {worst}; tol {slack:.3e}, relative above 1); samples with a hit "
        f"{hits}; task wall s card {wall['card']:.1f}, CPU {wall['cpu']:.1f}; {smi}")
    return dict(records=len(records["cpu"]), differing_records=differing, near_ties=near_ties,
                metrics=len(keys), max_metric_diff=diff[worst], worst=worst, wall_s=wall)


def phase_quality_chain(smi: str, *, counts: dict | None = None, dim: int = D, device: str = "cuda",
                        extra: tuple = ()) -> dict:
    """``--quality``: the WebQSP-scale chain of ``scripts/run_webqsp_synth_hw.sh``
    through the port's CLI on the card, from ``testing.synthetic_rows``'
    WebQSP preset (all three splits; ``counts`` cuts them for a dry run)
    built with the hash encoder at ``dim`` through ``read_raw_rows`` +
    ``build_from_samples`` (no parquet), then ``experiment=webqsp_synth_hw``
    at the config's own epochs (14 retriever, 20 GFlowNet, patience 4):
    every stage exit 0 with its manifest, serve through kernel 3; stage
    seconds, each training stage's monitor by epoch (``epoch_monitor``) and
    the round-4 metrics beside the TPU run's quality values."""
    QUALITY_DIR.mkdir(parents=True, exist_ok=True)
    try:
        return quality_chain(smi, counts, dim, device, list(extra))
    finally:
        shutil.rmtree(QUALITY_WORK, ignore_errors=True)


def quality_chain(smi: str, counts, dim: int, device: str, extra: list) -> dict:
    import contextlib
    import importlib.util
    from unittest import mock

    import numpy as np

    from evi_rag_tpu_torch import cli
    from evi_rag_tpu_torch.data.pipeline import build_from_samples, read_raw_rows, write_tables
    from evi_rag_tpu_torch.ops import score_kernels as sk
    from evi_rag_tpu_torch.testing import synthetic_rows
    from evi_rag_tpu_torch.utils.config import load_config
    from evi_rag_tpu_torch.utils.device import resolve_device

    configs = str(ROOT / "configs")
    root, art = QUALITY_WORK / "normalized", QUALITY_WORK / "artifacts"
    stage_s: dict[str, float] = {}
    t0 = time.perf_counter()
    rows = list(synthetic_rows("webqsp", seed=0, counts=counts))
    stage_s["rows"] = time.perf_counter() - t0
    sizes = {split: len(r) for split, r in rows}
    b = load_config(configs, "build", ["build.dataset=webqsp_synth", "build.raw_root=unused",
                                       f"build.out_dir={root}", f"build.encoder.dim={dim}"])["build"]
    t0 = time.perf_counter()
    res, tables = build_from_samples(cli._pipeline_config(b), cli._text_encoder(b["encoder"], resolve_device(device)),
                                     read_raw_rows(rows, b["dataset"], column_map=b.get("column_map"),
                                                   entity_normalization=str(b.get("entity_normalization", "none"))))
    stage_s["build"] = time.perf_counter() - t0
    del rows
    log(f"[quality build] WebQSP preset (seed 0) {sizes} questions, hash encoder D = {dim}: {res.num_entities} "
        f"entities, {res.num_relations} relations, kept {res.counts['kept']}, sub {res.counts['sub']}; built in "
        f"{stage_s['build']:.1f} s (rows made in {stage_s['rows']:.1f} s)")
    patches = []
    if importlib.util.find_spec("pyarrow") is not None:
        write_tables(root, tables)
    else:  # the parquet tables' rows, as the CLI would read them
        ents = {int(e["entity_id"]): str(e["label"]) for e in tables["entity_vocab.parquet"]}
        rels = {int(r["relation_id"]): str(r["label"]) for r in tables["relation_vocab.parquet"]}
        qs = {r["graph_id"]: (r["question"], list(r.get("a_entity") or []) or None)
              for r in tables["questions.parquet"]}
        normalized = lambda cfg: (cfg.get("dataset", {}).get("source") == "normalized")  # noqa: E731
        patches = [mock.patch.object(cli, "_vocab_maps", lambda cfg: (ents, rels) if normalized(cfg) else ({}, {})),
                   mock.patch.object(cli, "_question_lookup", lambda cfg: qs if normalized(cfg) else {})]
    del tables

    common = ["--configs-dir", configs, f"device={device}", "experiment=webqsp_synth_hw", "extras.print_config=false",
              f"dataset.normalized_dir={root}"]
    ckpt = QUALITY_WORK / "ckpt"
    sub = "dataset=webqsp_synth-sub"
    stages = [
        ("train_retriever", ["train_retriever", sub, f"retriever.train.ckpt_dir={ckpt / 'retriever'}"]),
        *((f"eval_retriever:{v}", ["eval_retriever", f"dataset={v}", f"retriever.ckpt={ckpt / 'retriever' / 'best'}",
                                   "eval.splits=[train, validation, test]", f"eval.artifacts_dir={art / v}"])
          for v in ("webqsp_synth", "webqsp_synth-sub")),
        ("train_gflownet", ["train_gflownet", sub, f"retriever.ckpt={ckpt / 'retriever' / 'best'}",
                            f"gflownet.g_agent_dir={art / 'webqsp_synth-sub' / 'g_agent'}",
                            f"gflownet.ckpt_dir={ckpt / 'gflownet'}"]),
        ("eval_gflownet", ["eval_gflownet", sub, f"gflownet.ckpt={ckpt / 'gflownet' / 'best'}",
                           f"gflownet.g_agent_dir={art / 'webqsp_synth-sub' / 'g_agent'}",
                           "eval.splits=[validation, test]", f"eval.artifacts_dir={art / 'webqsp_synth-sub'}"]),
        ("reasoner", ["reasoner", sub, f"gflownet.g_agent_dir={art / 'webqsp_synth-sub' / 'g_agent'}",
                      f"eval.artifacts_dir={art / 'webqsp_synth-sub'}"]),
        ("serve", ["serve", "dataset=webqsp_synth", f"retriever.ckpt={ckpt / 'retriever' / 'best'}",
                   "serve.splits=[validation, test]", f"serve.k={K}", "serve.k_values=[1, 10, 100]"]),
    ]
    metrics: dict[str, dict] = {}
    epochs: dict[str, dict] = {}
    launches = 0
    with contextlib.ExitStack() as stack:
        for patch in patches:
            stack.enter_context(patch)
        for name, argv in stages:
            logs = QUALITY_DIR / "logs" / name.replace(":", "_")
            reset_launches()
            t0 = time.perf_counter()
            rc = cli.main([argv[0], *common, *argv[1:], *extra, f"paths.log_dir={logs}"])
            stage_s[name] = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"quality {name}: exit {rc}")
            metrics[name] = latest_metrics(logs)
            if name == "serve":
                launches = sk.per_question_topk.launches
            log(f"[quality {name}] exit 0 in {stage_s[name]:.1f} s")
            if name.startswith("train_"):
                epochs[name] = epoch_monitor(logs, name, extra)
    manifests = {
        "train_retriever": ckpt / "retriever" / "best" / "meta.json",
        "eval_retriever:webqsp_synth": art / "webqsp_synth" / "g_agent" / "test" / "manifest.json",
        "eval_retriever:webqsp_synth-sub": art / "webqsp_synth-sub" / "g_agent" / "train" / "manifest.json",
        "train_gflownet": ckpt / "gflownet" / "best" / "meta.json",
        "eval_gflownet": art / "webqsp_synth-sub" / "eval_gflownet" / "test.manifest.json",
    }
    missing = [n for n, p in manifests.items() if not p.exists()]
    serve_runs = sorted((QUALITY_DIR / "logs" / "serve").glob("**/test.manifest.json"))
    if missing or not serve_runs or (device != "cpu" and launches <= 0):
        raise AssertionError(f"quality: manifests missing {missing}, serve manifests {serve_runs}, kernel-3 "
                             f"launches {launches}")
    table = chain_table(metrics)
    for row, (got, tpu, cpu) in table.items():
        log(f"[quality table] {row}: card {got} | TPU v5e round 4 {tpu} | reduced CPU chain, JAX "
            f"{'-' if cpu is None else cpu} (reduced scale)")
    sv = metrics["serve"]
    log(f"[quality] stage wall s {json.dumps({k: round(v, 1) for k, v in stage_s.items()})}; serve kernel-3 "
        f"launches {launches}, q/s validation {sv.get('validation/queries_per_s')} test "
        f"{sv.get('test/queries_per_s')}; {smi}")
    finite = [v for m in metrics.values() for v in m.values() if isinstance(v, float)]
    if not np.isfinite(finite).all():
        raise AssertionError("quality: a stage reported a non-finite metric")
    return dict(stage_s=stage_s, serve_launches=launches, table=table, metrics=metrics, sizes=sizes, epochs=epochs)


def epoch_monitor(logs: pathlib.Path, stage: str, extra: list) -> dict:
    """The validation monitor of every epoch of a training stage (its
    ``metrics.jsonl``), the best epoch, and whether patience ended the run
    before the config's epochs (``experiment=webqsp_synth_hw``, or an
    ``extra`` override)."""
    from evi_rag_tpu_torch.utils.config import load_config

    retriever = stage == "train_retriever"
    cfg = load_config(str(ROOT / "configs"), stage, ["experiment=webqsp_synth_hw", *extra])
    section = cfg["retriever"]["train"] if retriever else cfg["gflownet"]
    key = section.get("monitor", "answer/reachability@100" if retriever else "answer_hit")
    (history,) = logs.glob("**/metrics.jsonl")
    rows = [json.loads(ln) for ln in history.read_text().splitlines()]
    values = [r.get(key) for r in rows]
    best = max(range(len(values)), key=lambda i: values[i])
    out = dict(monitor=key, values=values, best_epoch=best, epochs=len(values),
               max_epochs=int(section["max_epochs"]), patience=int(section["patience"]),
               stopped_early=len(values) < int(section["max_epochs"]))
    log(f"[quality {stage}] validation {key} by epoch: {', '.join(f'{v:.4f}' for v in values)}; best epoch {best} "
        f"({values[best]:.4f}); {len(values)} of {out['max_epochs']} epochs"
        + (f" (patience {out['patience']} stopped the run after epoch {len(values) - 1})" if out["stopped_early"]
           else ""))
    return out


def chain_table(metrics: dict) -> dict:
    """Round 4's rows (``ROUND4``): the card's values beside the TPU run's
    and the reduced CPU chain's JAX values (``CPU_CHAIN_JAX``) where it has
    the row."""
    def r(v):
        return None if v is None else round(float(v), 3)

    tr = metrics["train_retriever"]
    ev = metrics["eval_retriever:webqsp_synth"]
    gf, rs, sv = metrics["eval_gflownet"], metrics["reasoner"], metrics["serve"]
    splits = ("train", "validation", "test")
    ev_row = lambda key: tuple(r(ev.get(f"{s}/{key}")) for s in splits)  # noqa: E731
    got = {
        "train_retriever answer/reachability@100 (validation)": r(tr.get("answer/reachability@100")),
        "eval edge/recall@10 train / validation / test": ev_row("edge/recall@10"),
        "eval edge/recall@100": ev_row("edge/recall@100"),
        "eval answer/reachability@100": ev_row("answer/reachability@100"),
        "eval answer_recall@100": ev_row("answer_recall@100"),
        "eval edge/score_margin": ev_row("edge/score_margin"),
        "eval edge/margin_positive_rate": ev_row("edge/margin_positive_rate"),
        "eval ranking/mrr": ev_row("ranking/mrr"),
        "eval ranking/ndcg@10": ev_row("ranking/ndcg@10"),
        "eval_gflownet answer_hit@25 validation / test": (r(gf.get("validation/answer_hit@25")),
                                                          r(gf.get("test/answer_hit@25"))),
        "eval_gflownet test answer_hit@1 / @10 / @25": tuple(r(gf.get(f"test/answer_hit@{k}")) for k in (1, 10, 25)),
        "reasoner oracle hit@100 validation / test": (r(rs.get("validation/answer_hit@100")),
                                                      r(rs.get("test/answer_hit@100"))),
        "serve recall@100 (validation + test)": (r(sv.get("validation/serve/recall@100")),
                                                 r(sv.get("test/serve/recall@100"))),
    }
    return {row: (got[row], tpu, CPU_CHAIN_JAX.get(row)) for row, tpu in ROUND4.items()}


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

    if sys.argv[1:2] == ["--ablation"]:
        phase_device()
        phase_ablation(int(sys.argv[2]) if len(sys.argv) > 2 else 32768)
        return 0
    if sys.argv[1:2] == ["--crossover"]:
        phase_crossover(phase_device())
        return 0
    if sys.argv[1:2] == ["--quality"]:
        t_all = time.perf_counter()
        smi = phase_device()
        phase_build()
        chain = phase_quality_chain(smi)
        chain["wall_s"] = time.perf_counter() - t_all
        (OUT_DIR / "chip_smoke_quality.json").write_text(json.dumps(chain, indent=2, default=str))
        log(f"[done] wall {chain['wall_s']:.1f} s; details in chiprun_out/chip_smoke_quality.json")
        log(json.dumps({"quality": {k: chain[k] for k in ("stage_s", "serve_launches", "table", "sizes", "epochs")}}))
        log(smi)
        log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return 0
    t_all = time.perf_counter()
    smi = phase_device()
    build_s = phase_build()
    bundle_np = make_bundle(D, H, S, seed=11)
    rows = phase_kernel(bundle_np)
    serve = phase_serve(bundle_np, QUESTIONS)
    cli_metrics = phase_cli()
    pooled = phase_pooled(bundle_np)
    train = phase_train(smi)
    load_split = realistic_loader()
    gflownet = phase_gflownet(smi, train["retriever_ckpt"], load_split)
    try:
        debug = phase_debug(smi, train["retriever_ckpt"])
        eval_gfn = phase_eval_gflownet_card_vs_cpu(smi, load_split)
    finally:
        shutil.rmtree(GFN_WORK)  # phase 8's ~100 MB of stores, records and checkpoints
    native_bfs = phase_native()
    build = phase_build_data(smi, train["retriever_ckpt"])
    sweep = phase_sweep(smi, load_split)
    serve_ctx = serve.pop("_ctx")
    multi = phase_multidevice(smi, bundle_np, serve_ctx)
    route = phase_route(smi, bundle_np, serve_ctx)
    del serve_ctx
    quality = phase_quality(smi)

    rep = next(r for r in rows if r["M"] == REPORT_M)
    kernels = [{
        "name": "per_question_topk",
        "route": "cuda",
        "source": "evi_rag_tpu_torch/csrc/per_question_topk.cu",
        "replaces": "evi_rag_tpu/ops/pallas_score.py:507",
        "launches": serve["launches"],
        "group_launches": serve["group_launches"],
        "warmup_launches": serve["warmup_launches"],
        "launches_serving_trained_ckpt": train["serve"]["launches"],
        "launches_serving_built_split": build["serve"]["launches"],
        "launches_serving_sweep_best": sweep["serve"]["launches"],
        "launches_dp_serve": multi["11d"]["launches"],
        "launches_debug_serve": debug["c"]["pqt_launches"],
        "launches_route_phase4_serve": route["phase4"]["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": rep["ms"],
        "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"],
        "bound_by": rep["bound_by"],
        "library_ms": None,
        "tflops_as_done": rep["tflops_as_done"],
        "tflops_bound_count": rep["tflops_bound_count"],
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
            **({"launches_sharded_pooled": multi["11b"]["launches"]} if name == "query_topk_fused" else {}),
            f"launches_b{ROUTE_B}": route["pooled"]["launches"][name],
            "max_abs_err": pooled["max_abs_err"][name],
            "ms": pooled["ms"][name],
            "plain_ms": pooled["plain_ms"][name],
            "bound_ms": pooled["bounds"][name][0],
            "bound_by": pooled["bounds"][name][1],
            "library_ms": None,
            "scores_ms": pooled["score_ms"][name],
            "select_ms": pooled["select_ms"],
            "tflops_as_done": pooled["tflops"][name][0],
            "tflops_bound_count": pooled["tflops"][name][1],
            "shape": f"B={POOLED_B} M={POOLED_M} D={D} H={H} S={S} k={K}",
        })
    details = dict(nvidia_smi=smi, build_s=build_s, kernel=rows, serve=serve, cli=cli_metrics,
                   pooled=pooled, train=train, gflownet=gflownet, debug=debug, native_bfs=native_bfs, build=build, sweep=sweep,
                   multi=multi, route=route, quality=quality, eval_gflownet_card_vs_cpu=eval_gfn, kernels=kernels,
                   wall_s=time.perf_counter() - t_all)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(details, indent=2, default=str))
    log(f"[done] wall {details['wall_s']:.1f} s; details in chiprun_out/chip_smoke.json")
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
