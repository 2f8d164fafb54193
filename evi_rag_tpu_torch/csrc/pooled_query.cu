// Factorised twin-view scores of B queries over one shared candidate set,
// plus the exact top-k, for Hopper (sm_90a).
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
// then LayerNorm over H, exact GELU, the folded head and the combine
// (twin_score.cuh).
//
// Design.  The TPU kernel runs its grid in order and keeps a top-K2 buffer
// across the sweep; Hopper blocks run in parallel, so this is two launches:
//   (a) pooled_kernel: grid (M/16).  A block takes 16 edges and, once per
//       pass over the queries, computes [sc_f; sc_b] (32 A rows) @ W1s and
//       hmt @ W1e on the tensor cores, keeping c_f and c_b [16, H] f32 in
//       shared memory (132 KB at H = 1024) and nav in shared memory.  Then,
//       for each query, it builds the A rows [u; r_ctx] ([32, D] bf16,
//       66 KB) from the candidate rows (L2-resident across the query loop)
//       and runs zi = u @ W1i (rows 0..15) and zr = r_ctx @ W1e (rows
//       16..31) with mma.sync, so the 32 accumulator rows become z_f and z_b
//       of the 16 edges, and the per-question kernel's epilogue follows.
//       Output: [B, M] f32 scores (4 B per (edge, query) against 4.2 MFLOP).
//   (b) select_kernel: one block per query, radix select over 64-bit keys.
//   Ids are int32 with no 2^24 limit.
//
// Bound at D = H = 1024: 2 x 2*D*H = 4.19 MFLOP per (edge, query), plus
// 3 x 2*D*H per edge per pass: 7.1e13 FLOP at B = 128, M = 131,072, 72 ms at
// 989 TFLOP/s; the candidate rows are read once per pass (~0.8 GB, 0.25 ms).
// The tensor cores bound it.  W1i and W1e stream from L2 once per 16
// (edge, query) pairs (each B fragment meets 16 rows, half of the
// per-question kernel's 32), so L2 bandwidth, not the tensor cores, is the
// likely limit of this mma.sync design; wgmma with W1 tiles shared by more
// edges (TMA, clusters) is later work.

#include "twin_score.cuh"

namespace {

constexpr int kCPad = 8;  // f32 padding per c row: rows e and e+1 start 8 banks apart

struct PooledArgs {
  TwinWeights w;
  const __nv_bfloat16 *h, *r, *t;   // [M, D]
  const __nv_bfloat16* st;          // [M, S]
  const __nv_bfloat16 *gate, *bias; // [B, D]
  float* scores;                    // [B, M]
  int M, B;
};

__global__ void __launch_bounds__(kThreads, 1) pooled_kernel(PooledArgs p) {
  const int m0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = p.w.D, H = p.w.H, S = p.w.S, np = D / 64;
  const int lda = D + kPad, ldc = H + kCPad, ldw = 3 * D;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);   // [kRows][lda]
  float* cf = reinterpret_cast<float*>(A + kRows * lda);        // [kTile][ldc]
  float* cb = cf + kTile * ldc;                                 // [kTile][ldc]
  float* red = cb + kTile * ldc;                                // [kWarps][kRows]
  float* dist = red + kWarps * kRows;                           // [kRows]
  float* mean = dist + kRows;
  float* rstd = mean + kRows;
  float* head = rstd + kRows;
  float* nav = head + kRows;                                    // [kRows]: f rows, then b

  // Warp e owns edge e of the tile: A rows e and 16 + e.
  const int e = warp;
  const int m = m0 + e;
  const bool live = m < p.M;  // ragged last tile: zero rows, score never written
  __nv_bfloat16* row0 = A + e * lda;
  __nv_bfloat16* row1 = A + (kTile + e) * lda;
  const __nv_bfloat16* hp = p.h + (size_t)m * D;
  const __nv_bfloat16* rp = p.r + (size_t)m * D;
  const __nv_bfloat16* tp = p.t + (size_t)m * D;
  auto zero_rows = [&](bool both) {
    for (int c = lane; c < D; c += 32) {
      row0[c] = __float2bfloat16(0.f);
      if (both) row1[c] = __float2bfloat16(0.f);
    }
  };

  const int ntiles = H / 8;
  float acc[2][kMaxNT][4];
  auto zero_acc = [&]() {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;
  };

  // ---- (1) zs_f, zs_b = [sc_f; sc_b] @ W1s -> c_f, c_b.
  if (!live) {
    zero_rows(true);
    if (lane == 0) { nav[e] = 0.f; nav[kTile + e] = 0.f; }
  } else {
    float nv[2];
    build_struct_rows(p.w, p.st + (size_t)m * S, row0, row1, nv, lane);
    if (lane == 0) { nav[e] = nv[0]; nav[kTile + e] = nv[1]; }
  }
  __syncthreads();
  zero_acc();
  mma_rows<kShared>(acc, A, lda, p.w.w1t, ldw, D, D, D, ntiles, warp, lane);
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    if (warp + kWarps * i < ntiles) {
      const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int idx = ((lane >> 2) + 8 * (c >> 1)) * ldc + col + (c & 1);
        cf[idx] = acc[0][i][c];
        cb[idx] = acc[1][i][c];
      }
    }
  }
  __syncthreads();  // every warp is done reading A

  // ---- (2) zh = hmt @ W1e; c_f = zs_f + zh + b1, c_b = zs_b - zh + b1.
  if (!live) {
    zero_rows(false);
  } else {
    for (int q = 0; q < np; ++q) {
      const int c = 64 * q + 2 * lane;
      const float2 h2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp + c));
      const float2 t2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tp + c));
      *reinterpret_cast<__nv_bfloat162*>(row0 + c) =
          __floats2bfloat162_rn(__fsub_rn(h2.x, t2.x), __fsub_rn(h2.y, t2.y));
    }
  }
  __syncthreads();
  zero_acc();
  mma_rows<kFirst>(acc, A, lda, p.w.w1t, ldw, 2 * D, 2 * D, D, ntiles, warp, lane);
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    if (warp + kWarps * i < ntiles) {
      const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
      const float2 bb = *reinterpret_cast<const float2*>(p.w.b1 + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int idx = ((lane >> 2) + 8 * (c >> 1)) * ldc + col + (c & 1);
        const float zh = acc[0][i][c], b = (c & 1) ? bb.y : bb.x;
        cf[idx] = __fadd_rn(__fadd_rn(cf[idx], zh), b);
        cb[idx] = __fadd_rn(__fsub_rn(cb[idx], zh), b);
      }
    }
  }
  __syncthreads();

  // ---- (3) per query: rows [u; r_ctx], zi and zr, then the twin epilogue.
  for (int qi = 0; qi < p.B; ++qi) {
    if (!live) {
      zero_rows(true);
      if (lane == 0) { dist[e] = 0.f; dist[kTile + e] = 0.f; }
    } else {
      const __nv_bfloat16* gp = p.gate + (size_t)qi * D;
      const __nv_bfloat16* bp = p.bias + (size_t)qi * D;
      float df = 0.f, db = 0.f;
      for (int q = 0; q < np; ++q) {
        const int c = 64 * q + 2 * lane;
        const float2 h2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp + c));
        const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rp + c));
        const float2 t2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tp + c));
        const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp + c));
        const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp + c));
        const float hv[2] = {h2.x, h2.y}, rv[2] = {r2.x, r2.y}, tv[2] = {t2.x, t2.y};
        const float gv[2] = {g2.x, g2.y}, bv[2] = {b2.x, b2.y};
        float u[2], rc[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // h*t and (h*t)*r are exact in f32 (8-bit significands); one
          // rounding each, with no FMA contraction, as the plain version.
          const float ht = __fmul_rn(hv[j], tv[j]);
          const float prod = round_bf16(__fmul_rn(ht, rv[j]));
          u[j] = __fadd_rn(__fmul_rn(prod, gv[j]), __fmul_rn(ht, bv[j]));
          rc[j] = round_bf16(__fadd_rn(__fmul_rn(rv[j], gv[j]), bv[j]));
          const float hmt = round_bf16(__fsub_rn(hv[j], tv[j]));
          const float ef = round_bf16(__fadd_rn(rc[j], hmt));
          const float eb = round_bf16(__fsub_rn(rc[j], hmt));
          df += ef * ef;
          db += eb * eb;
        }
        *reinterpret_cast<__nv_bfloat162*>(row0 + c) = __floats2bfloat162_rn(u[0], u[1]);
        *reinterpret_cast<__nv_bfloat162*>(row1 + c) = __floats2bfloat162_rn(rc[0], rc[1]);
      }
      df = warp_sum(df);
      db = warp_sum(db);
      if (lane == 0) {
        dist[e] = -sqrtf(df + 1e-12f);
        dist[kTile + e] = -sqrtf(db + 1e-12f);
      }
    }
    __syncthreads();
    zero_acc();
    mma_rows<kSplit>(acc, A, lda, p.w.w1t, ldw, 0, 2 * D, D, ntiles, warp, lane);

    // acc[0] = zi, acc[1] = zr of the same (edge, column) -> z_f, z_b.
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      if (warp + kWarps * i < ntiles) {
        const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
        const float2 wd = *reinterpret_cast<const float2*>(p.w.w1d + col);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int er = (lane >> 2) + 8 * (c >> 1);
          const int idx = er * ldc + col + (c & 1);
          const float w = (c & 1) ? wd.y : wd.x;
          const float zi = acc[0][i][c], zr = acc[1][i][c];
          const float zf = nav[er] * zi + zr + cf[idx] + dist[er] * w;
          const float zb = nav[kTile + er] * zi + zr + cb[idx] + dist[kTile + er] * w;
          acc[0][i][c] = zf;
          acc[1][i][c] = zb;
          part[0][c >> 1] += zf;
          part[1][c >> 1] += zb;
        }
      }
    }
    ln_gelu_head(acc, part, p.w, ntiles, red, mean, rstd, head, warp, lane);
    if (tid < kTile && m0 + tid < p.M) {
      p.scores[(size_t)qi * p.M + m0 + tid] =
          combine(head[tid] + p.w.b2s[0], head[kTile + tid] + p.w.b2s[0]);
    }
  }
}

}  // namespace

extern "C" const char* pq_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Launches (a) then (b) on `stream`; returns cudaGetLastError().
extern "C" int pq_forward(
    const void* h, const void* r, const void* t, const void* st,
    const void* gate, const void* bias, const void* w1t, const float* w1d, const float* b1,
    const float* ln1s, const float* ln1b, const float* w2s, const float* b2s,
    const float* ws, const float* bs, const float* lnss, const float* lnsb, const float* wg,
    const float* wgb, float* scores, float* vals, int* ids,
    int B, int M, int D, int H, int S, int k, void* stream) {
  if (!twin_dims_ok(D, H, S) || k < 1 || k > kMaxK || k > M || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PooledArgs a;
  a.w = twin_weights(w1t, w1d, b1, ln1s, ln1b, w2s, b2s, ws, bs, lnss, lnsb, wg, wgb, D, H, S);
  a.h = static_cast<const __nv_bfloat16*>(h);
  a.r = static_cast<const __nv_bfloat16*>(r);
  a.t = static_cast<const __nv_bfloat16*>(t);
  a.st = static_cast<const __nv_bfloat16*>(st);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.scores = scores;
  a.M = M;
  a.B = B;
  const size_t smem = (size_t)kRows * (D + kPad) * sizeof(__nv_bfloat16) +
                      (size_t)2 * kTile * (H + kCPad) * sizeof(float) +
                      (size_t)(kWarps * kRows + 5 * kRows) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(pooled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pooled_kernel<<<(M + kTile - 1) / kTile, kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<B, kSelectThreads, 0, s>>>(scores, nullptr, vals, ids, M, k);
  return static_cast<int>(cudaGetLastError());
}
