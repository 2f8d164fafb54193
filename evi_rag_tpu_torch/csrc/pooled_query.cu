// Factorised twin-view scores of B queries over one shared candidate set,
// for Hopper (sm_90a).  The exact top-k that follows is score_bidirectional's
// select launch (`sb_select`).
//
// Replaces the Pallas TPU kernel `_fused_topk_kernel`
// (evi_rag_tpu/ops/pallas_score.py:290, wrappers `_topk_fused_chunk` and
// `pallas_query_topk_fused`).  Python wrapper and plain PyTorch version:
// evi_rag_tpu_torch/ops/score_kernels.py (`query_topk_fused`,
// `fused_scores_reference`).
//
// The factorised form (the TPU kernel's): per-edge row scalars commute with
// the matmul and the two directions share their interaction product, so
// with u = (h*t*r)*gate + (h*t)*bias = h*t*r_ctx,
//   inter_{f,b} @ W1i = nav_{f,b} * (u @ W1i)
//   err_{f,b}  @ W1e = r_ctx @ W1e +- (h - t) @ W1e
// and per candidate only zh = (h-t) @ W1e, zs_{f,b} = sc_{f,b} @ W1s and
// nav_{f,b} are query-independent.  Rounding points (bf16 operands, f32
// sums; the plain version rounds at the same points):
//   prod = bf16(h*t*r), u = bf16(prod*gate + (h*t)*bias), r_ctx = bf16(r*gate + bias),
//   hmt = bf16(h - t), err_{f,b} = bf16(r_ctx +- hmt), sc_{f,b} as bf16 operands;
//   z_f = nav_f*zi + zr + c_f + dist_f*w1d,   c_f = zs_f + zh + b1   (f32)
//   z_b = nav_b*zi + zr + c_b + dist_b*w1d,   c_b = zs_b - zh + b1   (f32)
// then LayerNorm over H, exact GELU, the folded head and the combine.
//
// Design: three launches per chunk of candidates (twin_wgmma.cuh).
//   (a) struct_rows_kernel: sc_{f,b} bf16 [M, 2, D] and nav_{f,b} [M, 2].
//   (b) wg_kernel<kEdge>: one GEMM over the edges on the wgmma mainloop,
//       A rows [sc_f | hmt] and [sc_b | -hmt] against [W1s; W1e]:
//       c_{f,b} = acc + b1 into scratch [M, 2, H] f32.
//   (c) wg_kernel<kPooled>: a cluster of ceil(H/128) CTAs per tile of 128
//       edges and 8 queries; per query the u and r_ctx rows of the tile are
//       built once per cluster (each CTA's builders take 1/8 of the edges and
//       push them to every CTA), zi and zr accumulate side by side, and the
//       epilogue reads c_{f,b} back (128 KB per CTA and query, 1/4 of its
//       512 KB W1i + W1e slice), runs LayerNorm over H across the cluster
//       and writes [B, M] scores.
//
// Rows per W1 byte fetched from L2: 128 in (c) (each W1i tile meets the u
// rows, each W1e tile the r_ctx rows, of 128 edges), against 16 in the
// mma.sync kernel before it; 256 in (b).  Shared memory 222,928 bytes per
// CTA.  Scratch: 4 KB (sc) + 8 KB (c) + 8 B (nav) per edge at D = H = 1024.
//
// Bound at D = H = 1024: 2 x 2*D*H = 4.19 MFLOP per (edge, query), plus
// 3 x 2*D*H per edge: 7.1e13 FLOP at B = 128, M = 131,072, 72 ms at
// 989 TFLOP/s; the tensor cores bound it.  Measured on the H100, the
// epilogue (c read back from L2, three cluster exchanges) takes nearly half
// of (c) and the A-row pipeline most of the rest (chip_smoke.py
// --ablation, PERF.md).

#include "twin_wgmma.cuh"

extern "C" const char* pq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// scores[b * ld_scores + m] for B queries over the M candidates given, with
// sc [M, 2, D] bf16, nav [M, 2] f32 and c [M, 2, H] f32 scratch; returns the
// first CUDA error.
extern "C" int pq_forward(
    const void* h, const void* r, const void* t, const void* st,
    const void* gate, const void* bias, const void* w1_tiles, const float* w1d, const float* b1,
    const float* ln1s, const float* ln1b, const float* w2s, const float* b2s,
    const float* ws, const float* bs, const float* lnss, const float* lnsb, const float* wg,
    const float* wgb, void* sc, float* nav, float* c, float* scores, long long ld_scores,
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
  a.c = c;
  a.scores = scores;
  a.ld_scores = ld_scores;
  a.M = M;
  a.B = B;
  cudaError_t err = launch_struct_rows(a.w, static_cast<const __nv_bfloat16*>(st),
                                       static_cast<__nv_bfloat16*>(sc), nav, M, nullptr, M, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_wg<kEdge>(a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wg<kPooled>(a, s));
}
