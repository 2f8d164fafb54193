"""Measure where kernel 3 starts to pay inside ``serve_window``.

Counterpart of the JAX package's ``scripts/measure_fused_crossover.py``:
``serve_split`` sends a bucket of padded edge width ``m_pad`` at or above
``serve.fused_threshold`` (256) through ``per_question_topk`` (kernel 3,
``csrc/per_question_topk.cu``) and narrower ones through the plain bf16
scorer.  This sweep times both paths on the same device-resident bucket
feeds (the JAX script's: two buckets of 16 questions, 4,096 entity rows,
512 relations, 64 questions, lengths in (m_pad / 2, m_pad], ~5% topic
nodes; numpy seed 0) at the production width, and prints one JSON line per
width, then the crossover: the first width at which the kernel is faster.

Each path: one warm call, then the best of 3 windows of ``iters`` calls
(synchronised), ms per call.  The kernel path gets its weights prepared
once, as ``serve_split`` prepares them once per split.  ``k`` is cut to
``m_pad`` below 100 (the kernel needs k <= m_pad); JAX's widths start at 256.

Run on the card::

    python -m evi_rag_tpu_torch.scripts.measure_fused_crossover [--widths 256 512 ...] [--iters 8] \\
        [--dim 1024] [--k 100] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

WIDTHS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768)
GROUP_SIZE, N_BUCKETS, STRUCT = 16, 2, 20


def main(k: int = 100, dim: int = 1024, iters: int = 8, widths=WIDTHS,
         device: str | torch.device | None = None) -> list[dict]:
    """The rows (``m_pad``, ``k``, ``plain_ms``, ``fused_ms``, their q/s and
    ``fused_speedup``), each printed; then the crossover line."""
    from evi_rag_tpu_torch.bench import make_bundle
    from evi_rag_tpu_torch.ops.score_kernels import prep_weights
    from evi_rag_tpu_torch.serving import serve_window
    from evi_rag_tpu_torch.train.checkpoint import bundle_from_numpy
    from evi_rag_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    bundle = {"features": bundle_from_numpy(make_bundle(dim, dim, STRUCT)["features"], device=dev)}
    weights = prep_weights(bundle["features"])
    rng = np.random.default_rng(0)

    vocab, rels, n_questions = 4096, 512, 64
    ent_table = torch.as_tensor(rng.normal(size=(vocab, dim)).astype(np.float32), device=dev)
    rel_table = torch.as_tensor(rng.normal(size=(rels, dim)).astype(np.float32), device=dev)
    q_table = torch.as_tensor(rng.normal(size=(n_questions, dim)).astype(np.float32), device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    for m_pad in widths:
        n_pad = min(max(64, m_pad // 2), 4096)
        b_n, g_n = N_BUCKETS, GROUP_SIZE
        eidx = rng.integers(0, n_pad - 1, size=(b_n, g_n, 2, m_pad)).astype(np.int16)
        node_rows = rng.integers(0, vocab, size=(b_n, g_n, n_pad)).astype(np.int32)
        rel_ids = rng.integers(0, rels, size=(b_n, g_n, m_pad)).astype(np.int16)
        # Realistic fill: buckets hold questions whose true edge count landed
        # in (m_pad/2, m_pad]; ~75% average fill.
        lengths = rng.integers(m_pad // 2 + 1, m_pad + 1, size=(b_n, g_n)).astype(np.int32)
        topic = (rng.random(size=(b_n, g_n, n_pad)) < 0.05).astype(np.uint8)
        ncnt = np.full((b_n, g_n), n_pad, np.int32)
        qids = rng.integers(0, n_questions, size=(b_n, g_n)).astype(np.int32)
        feed = [torch.as_tensor(x, device=dev) for x in (eidx, node_rows, rel_ids, lengths, topic, ncnt, qids)]
        k_w = min(k, m_pad)

        def run(use_fused: bool) -> float:
            kw = dict(k=k_w, num_rounds=2, num_reverse_rounds=2, dtype=torch.bfloat16, use_fused=use_fused,
                      weights=weights if use_fused else None)
            serve_window(bundle, q_table, ent_table, rel_table, *feed, **kw)
            sync()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                for _ in range(iters):
                    serve_window(bundle, q_table, ent_table, rel_table, *feed, **kw)
                sync()
                best = min(best, (time.perf_counter() - t0) / iters)
            return best

        t_plain = run(False)
        t_fused = run(True)
        q = b_n * g_n
        row = {"m_pad": m_pad, "k": k_w, "plain_ms": round(t_plain * 1e3, 2), "fused_ms": round(t_fused * 1e3, 2),
               "plain_qps": round(q / t_plain, 1), "fused_qps": round(q / t_fused, 1),
               "fused_speedup": round(t_plain / t_fused, 3)}
        rows.append(row)
        print(json.dumps(row), flush=True)

    crossover = next((r["m_pad"] for r in rows if r["fused_speedup"] > 1.0), None)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps({"backend": dev.type, "device": name, "crossover_m_pad": crossover}))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS))
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--dim", type=int, default=1024)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--device", default=None, help="cpu to run off the card (default: the card)")
    a = ap.parse_args()
    main(iters=a.iters, dim=a.dim, k=a.k, widths=tuple(a.widths), device=a.device)
