// Device code shared by the port's twin-view scoring kernels (sm_90a):
// per_question_topk.cu, score_bidirectional.cu and pooled_query.cu.
//
// What every kernel here scores, per (query, candidate (h, r, t rows [D]
// bf16, struct row [S] bf16)), for both directions (fwd: head=h, tail=t,
// struct as is; bwd: head=t, tail=h, struct halves swapped):
//
//   r_ctx = r * gate + bias
//   sc    = gelu(LN_D(struct @ Ws + bs))            (exact erf GELU, eps 1e-5)
//   nav   = sigmoid(sc . wg + wgb)
//   inter = head * r_ctx * tail * nav,  err = head + r_ctx - tail
//   dist  = -sqrt(|err|^2 + 1e-12)
//   z     = [inter | sc | err] @ W1[:3D] + dist * w1d + b1     (bf16 operands, f32 sums)
//   s_dir = gelu(LN_H(z)) . w2s + b2s                  (w2s = W2 @ w_score, exact fold)
//   score = softmax-weighted combine of (s_fwd, s_bwd)
//
// Contents:
//   * build_struct_rows: the struct projection of both directions from one
//     pass over Ws, LayerNorm, GELU and the nav gate, written as two bf16
//     A-operand rows;
//   * mma_rows: A [32 rows] x W1 blocks with mma.sync.m16n8k16 (bf16, f32
//     sums); W1 is streamed from device memory (resident in L2);
//   * ln_gelu_head: LayerNorm over H, GELU and the folded head on the
//     accumulators; combine: the twin-view softmax combine;
//   * score_kernel: the whole score of 16 edges of one query per block
//     (per-question candidates, or one candidate set shared by all queries);
//   * select_kernel: exact top-k by radix select over 64-bit keys.
//
// W1 arrives as w1t [H, 3D]: W1[:3D] transposed, each 16-k block permuted
// (ops/score_kernels.py::kernel_w1_layout) so a lane's B fragment for one
// k16 step is one 8-byte load.  Block columns [0, D) are W1's inter rows,
// [D, 2D) its struct rows, [2D, 3D) its err rows.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kTile = 16;               // edges per block
constexpr int kRows = 2 * kTile;        // rows [0, 16) and [16, 32) of the A operand
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 1024;             // D % 64 == 0, D <= 1024
constexpr int kMaxH = 1024;             // H % 8 == 0, H <= 1024
constexpr int kMaxS = 32;               // struct width, even
constexpr int kMaxPairs = kMaxD / 64;   // bf16 pairs per lane in the row build
constexpr int kMaxNT = kMaxH / 8 / kWarps;  // 8-column MMA tiles per warp
constexpr int kPad = 8;                 // bf16 padding per A row (bank spread)
constexpr int kSelectThreads = 512;
constexpr int kMaxK = 1024;

struct TwinWeights {
  const __nv_bfloat16* w1t;                            // [H, 3D] W1[:3D]^T, k16-permuted
  const float *w1d, *b1, *ln1s, *ln1b, *w2s;           // [H]
  const float* b2s;                                    // [1]
  const float* ws;                                     // [S, D]
  const float *bs, *lnss, *lnsb, *wg;                  // [D]
  const float* wgb;                                    // [1]
  int D, H, S;
};

// Fills TwinWeights from the C entries' common argument order.
inline TwinWeights twin_weights(const void* w1t, const float* w1d, const float* b1,
                                const float* ln1s, const float* ln1b, const float* w2s,
                                const float* b2s, const float* ws, const float* bs,
                                const float* lnss, const float* lnsb, const float* wg,
                                const float* wgb, int D, int H, int S) {
  TwinWeights w;
  w.w1t = static_cast<const __nv_bfloat16*>(w1t);
  w.w1d = w1d; w.b1 = b1; w.ln1s = ln1s; w.ln1b = ln1b; w.w2s = w2s; w.b2s = b2s;
  w.ws = ws; w.bs = bs; w.lnss = lnss; w.lnsb = lnsb; w.wg = wg; w.wgb = wgb;
  w.D = D; w.H = H; w.S = S;
  return w;
}

inline bool twin_dims_ok(int D, int H, int S) {
  return D % 64 == 0 && D > 0 && D <= kMaxD && H % 8 == 0 && H > 0 && H <= kMaxH &&
         S % 2 == 0 && S > 0 && S <= kMaxS;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sum a per-row partial held by this thread over the block: lanes that
// share (lane / 4) hold the same row, warps hold disjoint columns.
// part[mt][hi] is the partial for row mt*16 + lane/4 + 8*hi.
__device__ __forceinline__ void block_row_sum(float (&part)[2][2], float* red,
                                              float* out, int warp, int lane) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v = part[mt][hi];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if ((lane & 3) == 0) red[warp * kRows + mt * 16 + (lane >> 2) + 8 * hi] = v;
    }
  __syncthreads();
  if (threadIdx.x < kRows) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kRows + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// One warp: the struct contexts of one edge in both directions, from one
// pass over Ws (fwd multiplies row j of Ws by struct[j], bwd by the
// half-swapped struct), then LayerNorm over D, GELU and the nav gate.
// Writes sc_fwd to rowf[0, D) and sc_bwd to rowb[0, D) as bf16.
__device__ __forceinline__ void build_struct_rows(const TwinWeights& w, const __nv_bfloat16* st,
                                                  __nv_bfloat16* rowf, __nv_bfloat16* rowb,
                                                  float (&nav)[2], int lane) {
  const int D = w.D, S = w.S, hs = S / 2, np = D / 64;
  const float sv = lane < S ? __bfloat162float(st[lane]) : 0.f;
  float v[2][2 * kMaxPairs];
#pragma unroll
  for (int q = 0; q < kMaxPairs; ++q)
    if (q < np) {
      const float2 b = *reinterpret_cast<const float2*>(w.bs + 64 * q + 2 * lane);
      v[0][2 * q] = v[1][2 * q] = b.x;
      v[0][2 * q + 1] = v[1][2 * q + 1] = b.y;
    }
  for (int j = 0; j < S; ++j) {
    const float xf = __shfl_sync(0xffffffffu, sv, j);
    const float xb = __shfl_sync(0xffffffffu, sv, j < hs ? j + hs : j - hs);
    const float* wrow = w.ws + (size_t)j * D + 2 * lane;
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q)
      if (q < np) {
        const float2 ww = *reinterpret_cast<const float2*>(wrow + 64 * q);
        v[0][2 * q] = fmaf(xf, ww.x, v[0][2 * q]);
        v[0][2 * q + 1] = fmaf(xf, ww.y, v[0][2 * q + 1]);
        v[1][2 * q] = fmaf(xb, ww.x, v[1][2 * q]);
        v[1][2 * q + 1] = fmaf(xb, ww.y, v[1][2 * q + 1]);
      }
  }
#pragma unroll
  for (int dir = 0; dir < 2; ++dir) {
    float s1 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q)
      if (q < np) s1 += v[dir][2 * q] + v[dir][2 * q + 1];
    const float mu = warp_sum(s1) / D;
    float s2 = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q)
      if (q < np) {
        const float a = v[dir][2 * q] - mu, b = v[dir][2 * q + 1] - mu;
        s2 += a * a + b * b;
      }
    const float rs = rsqrtf(warp_sum(s2) / D + 1e-5f);
    __nv_bfloat16* row = dir == 0 ? rowf : rowb;
    float sn = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxPairs; ++q)
      if (q < np) {
        const int c = 64 * q + 2 * lane;
        const float2 sc_s = *reinterpret_cast<const float2*>(w.lnss + c);
        const float2 sc_b = *reinterpret_cast<const float2*>(w.lnsb + c);
        const float2 wg = *reinterpret_cast<const float2*>(w.wg + c);
        const float y0 = gelu_erf((v[dir][2 * q] - mu) * rs * sc_s.x + sc_b.x);
        const float y1 = gelu_erf((v[dir][2 * q + 1] - mu) * rs * sc_s.y + sc_b.y);
        sn += y0 * wg.x + y1 * wg.y;
        *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(y0, y1);
      }
    nav[dir] = sigmoid(warp_sum(sn) + w.wgb[0]);
  }
}

// How the two 16-row halves of A meet W1 in mma_rows.
enum MmaMode {
  kShared = 0,  // both halves x the same W1 block (one B load feeds both)
  kSplit = 1,   // rows [0, 16) x the block at koff0, rows [16, 32) x the block at koff1
  kFirst = 2,   // rows [0, 16) only, x the block at koff0
};

// acc[mt] += A[mt*16 .. mt*16+16, 0 .. kext) @ W1 rows (koff_mt .. koff_mt + kext),
// for this warp's 8-column tiles w, w + 16, w + 32, ... of H.  In each 16-k
// block of a w1t row, lane t's B values k = 2t, 2t+1, 8+2t, 9+2t sit together
// at 4t.  acc[mt][i][c] is row mt*16 + lane/4 + 8*(c/2), column
// (warp+16i)*8 + 2*(lane%4) + c%2.  kext is a multiple of 32.
template <int kMode>
__device__ __forceinline__ void mma_rows(float (&acc)[2][kMaxNT][4], const __nv_bfloat16* A,
                                         int lda, const __nv_bfloat16* w1t, int ldw, int koff0,
                                         int koff1, int kext, int ntiles, int warp, int lane) {
  const __nv_bfloat16* a_ptr = A + (lane & 15) * lda + (lane >> 4) * 8;
  const __nv_bfloat16* b_ptr = w1t + (size_t)(warp * 8 + (lane >> 2)) * ldw + (lane & 3) * 4;
  const size_t b_step = (size_t)kWarps * 8 * ldw;  // next n-tile of this warp

  auto load_b = [&](uint32_t (&b)[kMaxNT][2], int k0) {
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      if (warp + kWarps * i < ntiles) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(b_ptr + i * b_step + k0));
        b[i][0] = v.x;
        b[i][1] = v.y;
      }
    }
  };
  auto mma_half = [&](int mt, const uint32_t (&b)[kMaxNT][2], int k0) {
    uint32_t a[4];
    ldmatrix_x4(a, a_ptr + mt * 16 * lda + k0);
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i)
      if (warp + kWarps * i < ntiles) mma_bf16(acc[mt][i], a, b[i][0], b[i][1]);
  };
  auto mma_both = [&](const uint32_t (&b)[kMaxNT][2], int k0) {
    uint32_t a0[4], a1[4];
    ldmatrix_x4(a0, a_ptr + k0);
    ldmatrix_x4(a1, a_ptr + 16 * lda + k0);
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i) {
      if (warp + kWarps * i < ntiles) {
        mma_bf16(acc[0][i], a0, b[i][0], b[i][1]);
        mma_bf16(acc[1][i], a1, b[i][0], b[i][1]);
      }
    }
  };

  uint32_t bx[kMaxNT][2], by[kMaxNT][2];
  if (kMode == kSplit) {
    // bx: the koff0 block at k0, by: the koff1 block at k0; each load
    // overlaps the other half's MMAs.
    load_b(bx, koff0);
    for (int k0 = 0; k0 < kext; k0 += 16) {
      load_b(by, koff1 + k0);
      mma_half(0, bx, k0);
      if (k0 + 16 < kext) load_b(bx, koff0 + k0 + 16);
      mma_half(1, by, k0);
    }
  } else {
    load_b(bx, koff0);
    for (int k0 = 0; k0 < kext; k0 += 32) {
      load_b(by, koff0 + k0 + 16);
      if (kMode == kShared) mma_both(bx, k0); else mma_half(0, bx, k0);
      if (k0 + 32 < kext) load_b(bx, koff0 + k0 + 32);
      if (kMode == kShared) mma_both(by, k0 + 16); else mma_half(0, by, k0 + 16);
    }
  }
}

// LayerNorm over H, GELU and the folded head dot of the 32 rows held in
// acc (pre-LayerNorm z); part holds this thread's row partial sums of z.
// Leaves head[row] = gelu(LN_H(z_row)) . w2s (without b2s).
__device__ __forceinline__ void ln_gelu_head(float (&acc)[2][kMaxNT][4], float (&part)[2][2],
                                             const TwinWeights& w, int ntiles, float* red,
                                             float* mean, float* rstd, float* head, int warp,
                                             int lane) {
  const int tid = threadIdx.x, H = w.H;
  block_row_sum(part, red, mean, warp, lane);
  if (tid < kRows) mean[tid] /= H;
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) part[mt][hi] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    if (warp + kWarps * i < ntiles) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dv = acc[mt][i][c] - mean[mt * 16 + (lane >> 2) + 8 * (c >> 1)];
          part[mt][c >> 1] += dv * dv;
        }
    }
  }
  block_row_sum(part, red, rstd, warp, lane);
  if (tid < kRows) rstd[tid] = rsqrtf(rstd[tid] / H + 1e-5f);
  __syncthreads();

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) part[mt][hi] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    if (warp + kWarps * i < ntiles) {
      const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
      const float2 ls = *reinterpret_cast<const float2*>(w.ln1s + col);
      const float2 lb = *reinterpret_cast<const float2*>(w.ln1b + col);
      const float2 w2 = *reinterpret_cast<const float2*>(w.w2s + col);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = mt * 16 + (lane >> 2) + 8 * (c >> 1);
          const bool odd = c & 1;
          const float y = gelu_erf((acc[mt][i][c] - mean[row]) * rstd[row] * (odd ? ls.y : ls.x) +
                                   (odd ? lb.y : lb.x));
          part[mt][c >> 1] += y * (odd ? w2.y : w2.x);
        }
    }
  }
  block_row_sum(part, red, head, warp, lane);
}

// Twin-view softmax combine of the two direction scores.
__device__ __forceinline__ float combine(float f, float b) {
  const float mx = fmaxf(f, b);
  const float ef = expf(f - mx), eb = expf(b - mx);
  return (ef * f + eb * b) / (ef + eb);
}

struct ScoreArgs {
  TwinWeights w;
  const int* lengths;                                  // [G] valid prefix, or null (all M)
  const __nv_bfloat16 *h, *r, *t;                      // candidate (g, m) at row g*cand_stride + m
  const __nv_bfloat16* st;                             // [.., S] rows, same indexing
  const __nv_bfloat16 *gate, *bias;                    // [G, D]
  float* scores;                                       // [G, M]
  size_t cand_stride;                                  // M: per-question rows; 0: shared rows
  int M;
};

// Grid (ceil(M/16), G).  A block takes 16 edges of query g and builds 32
// A-rows (16 fwd + 16 bwd) of the [32, 3D] bf16 operand in shared memory,
// then 16 warps run the MMA over all of W1[:3D]; LayerNorm, GELU, the head
// and the combine run on the accumulators.  A tile wholly past the valid
// prefix writes -inf and returns.
__global__ void __launch_bounds__(kThreads, 1) score_kernel(ScoreArgs p) {
  const int g = blockIdx.y;
  const int m0 = blockIdx.x * kTile;
  const int len = p.lengths ? p.lengths[g] : p.M;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* out = p.scores + (size_t)g * p.M;
  if (m0 >= len) {  // the whole tile lies past the valid prefix
    if (tid < kTile && m0 + tid < p.M) out[m0 + tid] = -INFINITY;
    return;
  }
  const int D = p.w.D, H = p.w.H, S = p.w.S, K = 3 * D;
  const int lda = K + kPad;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem);   // [kRows][lda]
  float* red = reinterpret_cast<float*>(A + kRows * lda);       // [kWarps][kRows]
  float* dist = red + kWarps * kRows;                           // [kRows]
  float* mean = dist + kRows;
  float* rstd = mean + kRows;
  float* head = rstd + kRows;

  // ---- (1) A-operand rows: warp w builds edge w's fwd row w and bwd row 16+w.
  {
    const int e = warp;
    const int m = m0 + e;
    __nv_bfloat16* rowf = A + e * lda;
    __nv_bfloat16* rowb = A + (kTile + e) * lda;
    const int np = D / 64;
    if (m >= p.M) {  // ragged last tile: zero rows, score never written
      for (int c = lane; c < K; c += 32) {
        rowf[c] = __float2bfloat16(0.f);
        rowb[c] = __float2bfloat16(0.f);
      }
      if (lane == 0) { dist[e] = 0.f; dist[kTile + e] = 0.f; }
    } else {
      const size_t erow = (size_t)g * p.cand_stride + m;
      float nav[2];
      build_struct_rows(p.w, p.st + erow * S, rowf + D, rowb + D, nav, lane);
      // inter / err for both directions from one read of h, r, t.
      const __nv_bfloat16* hp = p.h + erow * D;
      const __nv_bfloat16* rp = p.r + erow * D;
      const __nv_bfloat16* tp = p.t + erow * D;
      const __nv_bfloat16* gp = p.gate + (size_t)g * D;
      const __nv_bfloat16* bp = p.bias + (size_t)g * D;
      float df = 0.f, db = 0.f;
      for (int q = 0; q < np; ++q) {
        const int c = 64 * q + 2 * lane;
        const float2 h2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(hp + c));
        const float2 r2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rp + c));
        const float2 t2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tp + c));
        const float2 g2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gp + c));
        const float2 b2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bp + c));
        // Separate roundings (no FMA contraction), in the plain version's order.
        const float rc0 = __fadd_rn(__fmul_rn(r2.x, g2.x), b2.x);
        const float rc1 = __fadd_rn(__fmul_rn(r2.y, g2.y), b2.y);
        const float if0 = __fmul_rn(__fmul_rn(__fmul_rn(h2.x, rc0), t2.x), nav[0]);
        const float if1 = __fmul_rn(__fmul_rn(__fmul_rn(h2.y, rc1), t2.y), nav[0]);
        const float ib0 = __fmul_rn(__fmul_rn(__fmul_rn(t2.x, rc0), h2.x), nav[1]);
        const float ib1 = __fmul_rn(__fmul_rn(__fmul_rn(t2.y, rc1), h2.y), nav[1]);
        const float ef0 = __fsub_rn(__fadd_rn(h2.x, rc0), t2.x);
        const float ef1 = __fsub_rn(__fadd_rn(h2.y, rc1), t2.y);
        const float eb0 = __fsub_rn(__fadd_rn(t2.x, rc0), h2.x);
        const float eb1 = __fsub_rn(__fadd_rn(t2.y, rc1), h2.y);
        df += ef0 * ef0 + ef1 * ef1;
        db += eb0 * eb0 + eb1 * eb1;
        *reinterpret_cast<__nv_bfloat162*>(rowf + c) = __floats2bfloat162_rn(if0, if1);
        *reinterpret_cast<__nv_bfloat162*>(rowb + c) = __floats2bfloat162_rn(ib0, ib1);
        *reinterpret_cast<__nv_bfloat162*>(rowf + 2 * D + c) = __floats2bfloat162_rn(ef0, ef1);
        *reinterpret_cast<__nv_bfloat162*>(rowb + 2 * D + c) = __floats2bfloat162_rn(eb0, eb1);
      }
      df = warp_sum(df);
      db = warp_sum(db);
      if (lane == 0) {
        dist[e] = -sqrtf(df + 1e-12f);
        dist[kTile + e] = -sqrtf(db + 1e-12f);
      }
    }
  }
  __syncthreads();

  // ---- (2) z[32, H] = A[32, 3D] @ W1[3D, H].
  const int ntiles = H / 8;
  float acc[2][kMaxNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int i = 0; i < kMaxNT; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][i][c] = 0.f;
  mma_rows<kShared>(acc, A, lda, p.w.w1t, K, 0, 0, K, ntiles, warp, lane);

  // ---- (3) epilogue: + dist * w1d + b1, LayerNorm over H, GELU, head dot.
  float part[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) part[mt][hi] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNT; ++i) {
    if (warp + kWarps * i < ntiles) {
      const int col = (warp + kWarps * i) * 8 + 2 * (lane & 3);
      const float2 wd = *reinterpret_cast<const float2*>(p.w.w1d + col);
      const float2 bb = *reinterpret_cast<const float2*>(p.w.b1 + col);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = mt * 16 + (lane >> 2) + 8 * (c >> 1);
          const float z = acc[mt][i][c] + dist[row] * ((c & 1) ? wd.y : wd.x) + ((c & 1) ? bb.y : bb.x);
          acc[mt][i][c] = z;
          part[mt][c >> 1] += z;
        }
    }
  }
  ln_gelu_head(acc, part, p.w, ntiles, red, mean, rstd, head, warp, lane);

  // ---- (4) twin-view softmax combine, prefix mask.
  if (tid < kTile) {
    const int m = m0 + tid;
    if (m < p.M) out[m] = m < len ? combine(head[tid] + p.w.b2s[0], head[kTile + tid] + p.w.b2s[0])
                                  : -INFINITY;
  }
}

inline size_t score_kernel_smem(int D) {
  return (size_t)kRows * (3 * D + kPad) * sizeof(__nv_bfloat16) +
         (size_t)(kWarps * kRows + 4 * kRows) * sizeof(float);
}

// Key order == (score desc, index asc): larger key is better.  -0.0 maps
// to +0.0 so that equal scores tie on the index as in torch / JAX.
__device__ __forceinline__ unsigned long long make_key(float f, int i) {
  unsigned int u = __float_as_uint(f + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned int)i);
}

__device__ __forceinline__ float key_score(unsigned long long key) {
  const unsigned int u = (unsigned int)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// One block per row g of scores [G, M]: radix select (8 passes of 8 bits)
// over distinct 64-bit keys (orderable score bits << 32 | ~index) finds the
// k-th key; the k keys at or above it are ranked by counting.  Entries past
// lengths[g] (all valid when lengths is null) count as -inf.
__global__ void __launch_bounds__(kSelectThreads) select_kernel(
    const float* __restrict__ scores, const int* __restrict__ lengths,
    float* __restrict__ vals, int* __restrict__ ids, int M, int k) {
  __shared__ unsigned int hist[256];
  __shared__ unsigned long long prefix_s;
  __shared__ unsigned int remaining_s;
  __shared__ unsigned int count_s;
  __shared__ unsigned long long keys[kMaxK];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int len = lengths ? lengths[g] : M;
  const float* s = scores + (size_t)g * M;
  if (tid == 0) { prefix_s = 0ull; remaining_s = (unsigned int)k; count_s = 0u; }
  unsigned long long mask = 0ull;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += blockDim.x) hist[b] = 0u;
    __syncthreads();
    const unsigned long long prefix = prefix_s;
    for (int i = tid; i < M; i += blockDim.x) {
      const unsigned long long key = make_key(i < len ? s[i] : -INFINITY, i);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255ull], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // Lane L holds bins 255-8L .. 248-8L, i.e. the bins in descending order.
      unsigned int c[8], tot = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) { c[j] = hist[255 - 8 * tid - j]; tot += c[j]; }
      unsigned int incl = tot;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const unsigned int excl = incl - tot;
      const unsigned int rem = remaining_s;
      if (excl < rem && rem <= incl) {
        unsigned int run = excl;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (run + c[j] >= rem) {
            prefix_s = prefix | ((unsigned long long)(255 - 8 * tid - j) << shift);
            remaining_s = rem - run;
            break;
          }
          run += c[j];
        }
      }
    }
    mask |= 0xFFull << shift;
    __syncthreads();
  }
  // prefix_s is now the k-th largest key; keys are distinct, so exactly k
  // keys are >= it.
  const unsigned long long kth = prefix_s;
  for (int i = tid; i < M; i += blockDim.x) {
    const unsigned long long key = make_key(i < len ? s[i] : -INFINITY, i);
    if (key >= kth) keys[atomicAdd(&count_s, 1u)] = key;
  }
  __syncthreads();
  for (int a = tid; a < k; a += blockDim.x) {
    const unsigned long long key = keys[a];
    int rank = 0;
    for (int b = 0; b < k; ++b) rank += keys[b] > key;
    vals[(size_t)g * k + rank] = key_score(key);
    ids[(size_t)g * k + rank] = (int)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
  }
}

}  // namespace
