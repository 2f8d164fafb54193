// Twin-view scores of B queries over one shared candidate set, for Hopper
// (sm_90a), and the exact top-k of those scores.
//
// Replaces the Pallas TPU kernel `_score_kernel`
// (evi_rag_tpu/ops/pallas_score.py, wrappers `pallas_score_bidirectional` and
// `pallas_query_topk`).  Python wrappers and plain PyTorch versions:
// evi_rag_tpu_torch/ops/score_kernels.py (`score_bidirectional`,
// `query_topk_per_query`).
//
// The per-edge score is exactly the per-question kernel's, so this file
// holds no device code of its own: it launches twin_score.cuh's score_kernel
// with a candidate row stride of 0 (every query reads the same rows) and no
// lengths (all M candidates valid), grid (M/16, B), into [B, M] f32 scores
// (64 MB at B = 128, M = 131,072), and select_kernel over those rows.
//
// Bound at D = H = 1024: 2 directions x 3 x 2*D*H = 12.6 MFLOP per
// (edge, query), 2.1e14 FLOP at B = 128, M = 131,072: 213 ms at 989 TFLOP/s,
// against 31 ms to read the 810 MB of candidate rows once per query.  The
// tensor cores bound it.  The design re-streams W1 from L2 once per 16
// (edge, query) pairs and uses mma.sync; the factorised kernel
// (pooled_query.cu) shares the query-independent work instead.

#include "twin_score.cuh"

extern "C" const char* sb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scores[b, m] for B queries over M shared candidates; returns cudaGetLastError().
extern "C" int sb_forward(
    const void* h, const void* r, const void* t, const void* st,
    const void* gate, const void* bias, const void* w1t, const float* w1d, const float* b1,
    const float* ln1s, const float* ln1b, const float* w2s, const float* b2s,
    const float* ws, const float* bs, const float* lnss, const float* lnsb, const float* wg,
    const float* wgb, float* scores, int B, int M, int D, int H, int S, void* stream) {
  if (!twin_dims_ok(D, H, S) || B < 1 || B > 65535 || M < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScoreArgs a;
  a.w = twin_weights(w1t, w1d, b1, ln1s, ln1b, w2s, b2s, ws, bs, lnss, lnsb, wg, wgb, D, H, S);
  a.lengths = nullptr;
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.t = static_cast<const __nv_bfloat16*>(t);
  a.st = static_cast<const __nv_bfloat16*>(st);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.scores = scores;
  a.cand_stride = 0;
  a.M = M;
  const size_t smem = score_kernel_smem(D);
  cudaError_t err = cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((M + kTile - 1) / kTile, B);
  score_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Exact top-k of each row of scores [B, M] (score desc, index asc).
extern "C" int sb_select(const float* scores, float* vals, int* ids, int B, int M, int k,
                         void* stream) {
  if (k < 1 || k > kMaxK || k > M || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  select_kernel<<<B, kSelectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      scores, nullptr, vals, ids, M, k);
  return static_cast<int>(cudaGetLastError());
}
