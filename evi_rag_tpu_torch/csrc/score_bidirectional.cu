// Twin-view scores of B queries over one shared candidate set, for Hopper
// (sm_90a), and the exact top-k of those scores.
//
// Replaces the Pallas TPU kernel `_score_kernel`
// (evi_rag_tpu/ops/pallas_score.py, wrappers `pallas_score_bidirectional` and
// `pallas_query_topk`).  Python wrappers and plain PyTorch versions:
// evi_rag_tpu_torch/ops/score_kernels.py (`score_bidirectional`,
// `query_topk_per_query`).
//
// The per-edge score is the per-question kernel's (twin_score.cuh), in its
// unfactorised form: per (edge, query) and direction the A row
// [inter | sc | err] of width 3D meets W1[:3D].  Two launches per chunk of
// candidates, then the select:
//   (a) struct_rows_kernel: sc_{f,b} (bf16 [M, 2, D]) and nav_{f,b} (f32
//       [M, 2]) once per edge (they do not depend on the query);
//   (b) wg_kernel<kScore> (twin_wgmma.cuh): a cluster of ceil(H/128) CTAs
//       (8 at H = 1024) per tile of 128 edges and 8 queries; each CTA holds
//       128 columns of z for the 256 rows (128 edges x 2 directions) in
//       wgmma accumulators.  Per query the A chunks [inter|sc|err] (the sc
//       columns copied from (a)'s scratch) are built once per cluster, each
//       CTA's builder warpgroup taking 1/8 of the edges and pushing them to
//       every CTA (st.async); W1 tiles are bulk-copied into a 4-stage ring.
//       LayerNorm over H runs across the cluster; rank 0 writes [B, M] f32
//       scores.
//   (c) select_kernel (twin_score.cuh), launched by `sb_select`.
//
// Rows per W1 byte fetched from L2: 256 (each 16 KB tile meets the fwd and
// bwd rows of 128 edges), against 32 in the mma.sync kernel before it.
// Shared memory 222,928 bytes per CTA (W1 ring 64 KB, A ring 96 KB,
// exchange 48 KB; one CTA per SM, 384 threads).  Scratch: 4 KB + 8 B per
// edge at D = 1024 (sc and nav; the wrapper chunks M to keep it within its
// limit).
//
// Bound at D = H = 1024, B = 128, M = 131,072: 8.4 MFLOP per (edge, query)
// (inter and err products, two directions) plus 4.2 MFLOP per edge, 1.41e14
// FLOP, 142.9 ms at 989 TFLOP/s: the tensor cores bound it.  This kernel
// keeps sc @ W1s per query (as the per-question kernel), so it does 2.1e14 FLOP and
// can reach at most 67% of that bound.  Measured on the H100 it is bound by
// neither: the mainloop runs at the same speed with its wgmma switched off
// (chip_smoke.py --ablation, PERF.md), so the per-step pipeline of A rows
// between the cluster's CTAs sets the pace.

#include "twin_wgmma.cuh"

extern "C" const char* sb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scores[b * ld_scores + m] for B queries over the M candidates given
// (rows h, r, t, st), with sc [M, 2, D] bf16 and nav [M, 2] f32 scratch;
// returns the first CUDA error.
extern "C" int sb_forward(
    const void* h, const void* r, const void* t, const void* st,
    const void* gate, const void* bias, const void* w1_tiles, const float* w1d, const float* b1,
    const float* ln1s, const float* ln1b, const float* w2s, const float* b2s,
    const float* ws, const float* bs, const float* lnss, const float* lnsb, const float* wg,
    const float* wgb, void* sc, float* nav, float* scores, long long ld_scores,
    int B, int M, int D, int H, int S, void* stream) {
  if (!twin_dims_ok(D, H, S) || B < 1 || B > 65535 || M < 1 || ld_scores < M) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  WgArgs a = {};
  a.w = twin_weights(w1d, b1, ln1s, ln1b, w2s, b2s, ws, bs, lnss, lnsb, wg, wgb, D, H, S);
  a.w1_tiles = static_cast<const __nv_bfloat16*>(w1_tiles);
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.t = static_cast<const __nv_bfloat16*>(t);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.sc = static_cast<const __nv_bfloat16*>(sc);
  a.nav = nav;
  a.scores = scores;
  a.ld_scores = ld_scores;
  a.M = M;
  a.B = B;
  cudaError_t err = launch_struct_rows(a.w, static_cast<const __nv_bfloat16*>(st),
                                       static_cast<__nv_bfloat16*>(sc), nav, M, nullptr, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wg<kScore>(a, s));
}

// Dynamic shared memory of one CTA of the wgmma kernels.
extern "C" int sb_wg_smem_bytes() { return static_cast<int>(kWgSmemBytes); }

// Exact top-k of each row of scores [B, M] (score desc, index asc).
extern "C" int sb_select(const float* scores, float* vals, int* ids, int B, int M, int k,
                         void* stream) {
  if (k < 1 || k > kMaxK || k > M || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  select_kernel<<<B, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, nullptr, vals, ids, M, k);
  return static_cast<int>(cudaGetLastError());
}
