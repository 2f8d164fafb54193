// Device code shared by the port's twin-view scoring kernels (sm_90a):
// per_question_topk.cu, score_bidirectional.cu and pooled_query.cu (whose
// wgmma mainloop is twin_wgmma.cuh).
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
//   * TwinWeights: the f32 weights every kernel reads (W1 itself arrives as
//     twin_wgmma.cuh's pre-swizzled tiles);
//   * build_struct_rows: the struct projection of both directions from one
//     pass over Ws, LayerNorm, GELU and the nav gate, written as two bf16
//     A-operand rows;
//   * combine: the twin-view softmax combine;
//   * select_kernel: exact top-k by radix select over 64-bit keys.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <math.h>

namespace {

constexpr int kWarps = 16;              // struct_rows_kernel: one edge per warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 1024;             // D % 64 == 0, D <= 1024
constexpr int kMaxH = 1024;             // H % 8 == 0, H <= 1024
constexpr int kMaxS = 32;               // struct width, even
constexpr int kMaxPairs = kMaxD / 64;   // bf16 pairs per lane in the row build
constexpr int kSelectThreads = 512;
constexpr int kMaxK = 1024;

struct TwinWeights {
  const float *w1d, *b1, *ln1s, *ln1b, *w2s;           // [H]
  const float* b2s;                                    // [1]
  const float* ws;                                     // [S, D]
  const float *bs, *lnss, *lnsb, *wg;                  // [D]
  const float* wgb;                                    // [1]
  int D, H, S;
};

// Fills TwinWeights from the C entries' common argument order.
inline TwinWeights twin_weights(const float* w1d, const float* b1, const float* ln1s,
                                const float* ln1b, const float* w2s, const float* b2s,
                                const float* ws, const float* bs, const float* lnss,
                                const float* lnsb, const float* wg, const float* wgb, int D,
                                int H, int S) {
  TwinWeights w;
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

// One warp: the struct contexts of one edge in both directions, from one
// pass over Ws (fwd multiplies row j of Ws by struct[j], bwd by the
// half-swapped struct), then LayerNorm over D, GELU and the nav gate.
// Writes sc_fwd to rowf and sc_bwd to rowb as bf16, column c at
// (c / 64) * chunk_stride + 8 * (((c % 64) / 8) ^ swz) + c % 8: a plain row
// with the defaults, or (twin_wgmma.cuh) the row's 64-column chunks in
// 128-byte-swizzle A-chunk images chunk_stride apart, swz = row % 8.
__device__ __forceinline__ void build_struct_rows(const TwinWeights& w, const __nv_bfloat16* st,
                                                  __nv_bfloat16* rowf, __nv_bfloat16* rowb,
                                                  float (&nav)[2], int lane, int chunk_stride = 64,
                                                  int swz = 0) {
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
        const int off = q * chunk_stride + 8 * ((lane / 4) ^ swz) + 2 * (lane % 4);
        const float2 sc_s = *reinterpret_cast<const float2*>(w.lnss + c);
        const float2 sc_b = *reinterpret_cast<const float2*>(w.lnsb + c);
        const float2 wg = *reinterpret_cast<const float2*>(w.wg + c);
        const float y0 = gelu_erf((v[dir][2 * q] - mu) * rs * sc_s.x + sc_b.x);
        const float y1 = gelu_erf((v[dir][2 * q + 1] - mu) * rs * sc_s.y + sc_b.y);
        sn += y0 * wg.x + y1 * wg.y;
        *reinterpret_cast<__nv_bfloat162*>(row + off) = __floats2bfloat162_rn(y0, y1);
      }
    nav[dir] = sigmoid(warp_sum(sn) + w.wgb[0]);
  }
}

// Twin-view softmax combine of the two direction scores.
__device__ __forceinline__ float combine(float f, float b) {
  const float mx = fmaxf(f, b);
  const float ef = expf(f - mx), eb = expf(b - mx);
  return (ef * f + eb * b) / (ef + eb);
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
