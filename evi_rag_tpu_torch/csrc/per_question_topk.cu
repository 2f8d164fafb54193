// Per-question twin-view triple scoring + exact top-k, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_per_question_topk_kernel`
// (evi_rag_tpu/ops/pallas_score.py, wrapper `pallas_per_question_topk`), the
// kernel that carries the `serve` task's buckets of 256 edges and more.
// Python wrapper and plain PyTorch version: evi_rag_tpu_torch/ops/score_kernels.py.
// The score itself and both launches are in twin_score.cuh.
//
// Per question g over its first len[g] candidates: the twin-view score of
// every candidate, then the exact top-k of the [M] scores under (score desc,
// index asc), with candidates past len[g] scored -inf (so unfilled slots
// come back as -inf, like jax.lax.top_k over masked scores).  Ids are int32
// with no 2^24 limit.
//
// Two launches:
//   (a) score_kernel: grid (M/16, G).  A block takes 16 edges of one question
//       and builds 32 A-rows (16 fwd + 16 bwd) of the [32, 3D] bf16 operand in
//       shared memory (197 KB at D = 1024), then 16 warps run
//       mma.sync.m16n8k16 bf16 with f32 accumulators over W1 [3D, H], streamed
//       from device memory (6 MB at D = H = 1024, resident in the 50 MB L2
//       across blocks).  The struct projection of both directions shares one
//       pass over Ws.  LayerNorm over H, GELU, the head dot and the combine
//       run on the accumulators.  Output: [G, M] f32 scores (4 B per edge).
//   (b) select_kernel: one block per question, radix select over 64-bit keys.
//
// Bound at D = H = 1024: 2 directions x 3 x 2*D*H = 12.6 MFLOP per valid edge
// against ~6.2 KB read per edge (h, r, t rows, struct row) -> ~2000 FLOP/B,
// far above the card's ~295 FLOP/B ridge: the tensor cores bound it.
// This design keeps W1 in L2 and re-reads it once per 16 edges (~384 KB of
// L2 traffic per edge), and uses mma.sync at a fraction of the card's rate.
// Left for later work: wgmma with TMA-fed W1 tiles in shared memory, larger
// edge tiles, and fusing the table-row gather (h, r, t) into the A-operand
// build.

#include "twin_score.cuh"

extern "C" const char* pqt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches (a) then (b) on `stream`; returns cudaGetLastError().
extern "C" int pqt_forward(
    const int* lengths, const void* h, const void* r, const void* t, const void* st,
    const void* gate, const void* bias, const void* w1t, const float* w1d, const float* b1,
    const float* ln1s, const float* ln1b, const float* w2s, const float* b2s,
    const float* ws, const float* bs, const float* lnss, const float* lnsb, const float* wg,
    const float* wgb, float* scores, float* vals, int* ids,
    int G, int M, int D, int H, int S, int k, void* stream) {
  if (!twin_dims_ok(D, H, S) || k < 1 || k > kMaxK || k > M || G < 1 || G > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScoreArgs a;
  a.w = twin_weights(w1t, w1d, b1, ln1s, ln1b, w2s, b2s, ws, bs, lnss, lnsb, wg, wgb, D, H, S);
  a.lengths = lengths;
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.t = static_cast<const __nv_bfloat16*>(t);
  a.st = static_cast<const __nv_bfloat16*>(st);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.scores = scores;
  a.cand_stride = (size_t)M;
  a.M = M;
  const size_t smem = score_kernel_smem(D);
  cudaError_t err = cudaFuncSetAttribute(score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((M + kTile - 1) / kTile, G);
  score_kernel<<<grid, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<G, kSelectThreads, 0, s>>>(scores, lengths, vals, ids, M, k);
  return static_cast<int>(cudaGetLastError());
}
