// Per-question twin-view triple scoring + exact top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_per_question_topk_kernel`
// (evi_rag_tpu/ops/pallas_score.py, wrapper `pallas_per_question_topk`), the
// kernel that carries the `serve` task's buckets of 256 edges and more.
// Python wrapper and plain PyTorch version: evi_rag_tpu_torch/ops/score_kernels.py.
//
// Per question g over its first len[g] candidates: the twin-view score of
// every candidate (twin_score.cuh's header note), then the exact top-k of
// the [M] scores under (score desc, index asc), with candidates past len[g]
// scored -inf (so unfilled slots come back as -inf, like jax.lax.top_k over
// masked scores).  Ids are int32 with no 2^24 limit.
//
// Three launches (twin_wgmma.cuh, twin_score.cuh):
//   (a) struct_rows_kernel: sc_{f,b} (bf16 [G*M, 2, D]) and nav_{f,b} (f32
//       [G*M, 2]) of every edge inside its question's prefix;
//   (b) wg_kernel<kQuestion>: the pooled kScore mainloop on per-question
//       rows.  A cluster of ceil(H/128) CTAs (8 at H = 1024) takes tiles of
//       128 edges of one question; each CTA holds 128 columns of z for the
//       256 rows (128 edges x 2 directions) in wgmma accumulators.  The A
//       chunks [inter|sc|err] are built once per cluster (each CTA's builder
//       warpgroup builds 1/8 of the edges and pushes them to every CTA with
//       st.async); pre-swizzled W1 tiles are bulk-copied into a 4-stage ring;
//       LayerNorm over H runs across the cluster and rank 0 writes the
//       [G, M] f32 scores.  Only live tiles (128 j < len[g]) are walked:
//       persistent clusters, as many as the card holds at once, each take a
//       contiguous range of the live (g, j) list that every CTA derives from
//       the lengths on the card (no host sync), so the W1 and A rings run on
//       from one tile to the next as kScore's run on from query to query.
//   (c) select_kernel: one block per question, radix select over 64-bit keys.
//
// Bound at D = H = 1024: 2 directions x 3 x 2*D*H = 12.6 MFLOP per valid
// edge against ~6.2 KB read per edge (h, r, t rows, struct row) -> ~2000
// FLOP/B, far above the card's ~295 FLOP/B ridge: the tensor cores bound it.
// The kernel does the work of whole tiles (a partial tile's rows past the
// prefix are zero) and keeps sc @ W1s per edge as the bound counts it.
// Scratch: 4 KB + 8 B per edge at D = 1024 (sc and nav; the wrapper cuts G
// into question chunks to keep it within its limit).

#include "twin_wgmma.cuh"

extern "C" const char* pqt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches (a), (b) and (c) on `stream` for G questions of M candidates
// (rows g*M + m of h, r, t, st), with sc [G*M, 2, D] bf16 and nav [G*M, 2]
// f32 scratch and scores [G, M] f32; `clusters` as launch_wg<kQuestion>
// (0: persistent).  Returns the first CUDA error.
extern "C" int pqt_forward(
    const int* lengths, const void* h, const void* r, const void* t, const void* st,
    const void* gate, const void* bias, const void* w1_tiles, const float* w1d, const float* b1,
    const float* ln1s, const float* ln1b, const float* w2s, const float* b2s,
    const float* ws, const float* bs, const float* lnss, const float* lnsb, const float* wg,
    const float* wgb, void* sc, float* nav, float* scores, float* vals, int* ids,
    int G, int M, int D, int H, int S, int k, int clusters, void* stream) {
  if (!twin_dims_ok(D, H, S) || k < 1 || k > kMaxK || k > M || G < 1 || G > 65535 || clusters < 0) {
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
  a.lengths = lengths;
  a.ld_scores = M;
  a.M = M;
  a.G = G;
  cudaError_t err = launch_struct_rows(a.w, static_cast<const __nv_bfloat16*>(st),
                                       static_cast<__nv_bfloat16*>(sc), nav, (long long)G * M, lengths, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_wg<kQuestion>(a, s, clusters);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<G, kSelectThreads, 0, s>>>(scores, lengths, vals, ids, M, k);
  return static_cast<int>(cudaGetLastError());
}

#ifdef WG_TRACE
// The clock64 marks of the last traced launch (twin_wgmma.cuh), into host memory `out`.
extern "C" int wg_trace_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_wg_trace, sizeof(g_wg_trace)));
}
#endif
