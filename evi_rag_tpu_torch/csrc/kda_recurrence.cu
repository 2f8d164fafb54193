// The KDA (Kimi Delta Attention) recurrence over runs of tokens, one launch
// for a prefill chunk's sequences or for a decode step (runs of length 1),
// with the short convolutions and the gates' activations that feed it.
//
// For each sequence s of the launch and head h, over its tokens t in order,
// from the states of cache row slots[s]:
//
//   q, k, v = SiLU(conv(q_raw)), SiLU(conv(k_raw)), SiLU(conv(v_raw))
//             (4 causal taps a channel over the conv state's last 3 raw
//              projections and the token's; f32 sums, the result in bf16)
//   decay   = exp(-exp(A_log[h]) softplus(f + dt_bias)),  beta = sigmoid(b)
//   q^ = q / sqrt(|q|^2 + 1e-6),  k^ = k / sqrt(|k|^2 + 1e-6)
//   S  <- diag(decay) S
//   S  <- S + beta k^ (v - S^T k^)^T
//   o  = S^T q^ * scale
//
// The recurrent state S [d_k, d_v] (f32) and the conv state are each read
// once and written once a launch; every sum is in f32.  One block of 512
// threads takes one (sequence, head).  A column j of S evolves alone given
// q, k, the decay and beta: four threads a column, each with 32 of its 128
// rows in registers (rows 16 m + 4 r + c, m < 8, c < 4, for row group r, so
// that the four groups read four distinct float4s of shared memory).  The
// tokens come in tiles of 8: for a tile, thread (kind, e) takes element e
// of q_raw, k_raw, v_raw or f (kind 0-3) for the tile's tokens, keeps its
// channel's last 3 raw values across tiles for the convolution, and writes
// the activated values to a double buffer in shared memory; eight warps then
// take one token each for the norms and q.k; the next tile's loads are in
// flight while the tile's tokens are computed, with no barrier between
// tokens.  The output uses q^T S_new = q^T S_decayed + (q^ . k^) u,
// u = beta (v - k^T S_decayed): one pass over the rows decays and takes both
// products, a second adds k^ u.  A run of length 0 (a pad) does nothing.
//
// Layouts: q_raw, k_raw, v_raw, f, o [N, H * 128] bf16; b [N, H] bf16; the
// taps [H * 128, 4] bf16 (q, k, v apart); A_log [H], dt_bias [H * 128] f32;
// state [B, H, 128, 128] f32 (d_k rows, d_v columns); conv [B, 3, 3 H 128]
// bf16 (oldest first; q, k, v side by side); slots, starts, lens [seqs]
// int32 (cache row, first token and length of each run).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDim = 128;
constexpr int kTaps = 4;
constexpr int kTile = 8;                  // tokens a tile
constexpr int kThreads = 4 * kDim;        // a column x 4 row groups; a loader a (kind, element)
constexpr int kSteps = kDim / 16;         // float4 steps over a thread's rows
constexpr float kNormEps = 1e-6f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads) kda_scan_kernel(
    const __nv_bfloat16* __restrict__ q_raw, const __nv_bfloat16* __restrict__ k_raw,
    const __nv_bfloat16* __restrict__ v_raw, const __nv_bfloat16* __restrict__ q_taps,
    const __nv_bfloat16* __restrict__ k_taps, const __nv_bfloat16* __restrict__ v_taps,
    const __nv_bfloat16* __restrict__ f, const __nv_bfloat16* __restrict__ b, const float* __restrict__ a_log,
    const float* __restrict__ dt_bias, float* __restrict__ state, __nv_bfloat16* __restrict__ conv,
    const int* __restrict__ slots, const int* __restrict__ starts, const int* __restrict__ lens,
    __nv_bfloat16* __restrict__ o, int heads, float scale) {
  __shared__ __align__(16) float sx[2][4][kTile][kDim];  // q, k, v (activated), decay
  __shared__ float sb[2][kTile];                          // beta
  __shared__ float sn[2][kTile][3];                       // 1 / |q|, 1 / |k|, q . k

  const int h = blockIdx.x, seq = blockIdx.y;
  const int len = lens[seq];
  if (len <= 0) return;
  const long long start = starts[seq];
  const int width = heads * kDim;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = tid >> 2, r = tid & 3;           // compute: column, row group
  const int kind = tid >> 7, e = tid & 127;      // loader: q, k, v or f; element
  const int ch = h * kDim + e;
  float* S = state + ((long long)slots[seq] * heads + h) * kDim * kDim;
  __nv_bfloat16* hist_at = conv + (long long)slots[seq] * (kTaps - 1) * 3 * width + kind * width + ch;

  const __nv_bfloat16* src = kind == 0 ? q_raw : kind == 1 ? k_raw : kind == 2 ? v_raw : f;
  float w[kTaps] = {0.f, 0.f, 0.f, 0.f}, hist[kTaps - 1] = {0.f, 0.f, 0.f}, a = 0.f, dt = 0.f;
  if (kind < 3) {
    const __nv_bfloat16* taps = (kind == 0 ? q_taps : kind == 1 ? k_taps : v_taps) + ch * kTaps;
#pragma unroll
    for (int m = 0; m < kTaps; ++m) w[m] = bf(taps[m]);
#pragma unroll
    for (int m = 0; m < kTaps - 1; ++m) hist[m] = bf(hist_at[m * 3 * width]);
  } else {
    a = expf(a_log[h]);
    dt = dt_bias[ch];
  }

  float s[kSteps * 4];
#pragma unroll
  for (int m = 0; m < kSteps; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[4 * m + i] = S[(16 * m + 4 * r + i) * kDim + c];

  float raw[kTile], braw = 0.f;
  auto fetch = [&](int t0) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) raw[j] = t0 + j < len ? bf(src[(start + t0 + j) * width + ch]) : 0.f;
    if (tid < kTile && t0 + tid < len) braw = bf(b[(start + t0 + tid) * heads + h]);
  };
  auto put = [&](int buf, int cnt) {
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float val;
      if (kind < 3) {
        const float y = w[0] * hist[0] + w[1] * hist[1] + w[2] * hist[2] + w[3] * raw[j];
        if (j < cnt) {
          hist[0] = hist[1];
          hist[1] = hist[2];
          hist[2] = raw[j];
        }
        val = __bfloat162float(__float2bfloat16(y / (1.f + expf(-y))));
      } else {
        const float x = raw[j] + dt;
        val = expf(-a * (x > 20.f ? x : log1pf(expf(x))));
      }
      sx[buf][kind][j][e] = val;
    }
    if (tid < kTile) sb[buf][tid] = 1.f / (1.f + expf(-braw));
  };

  fetch(0);
  for (int t0 = 0, buf = 0; t0 < len; t0 += kTile, buf ^= 1) {
    const int cnt = min(kTile, len - t0);
    put(buf, cnt);
    __syncthreads();
    if (warp < kTile) {
      const float4 q4 = *reinterpret_cast<const float4*>(&sx[buf][0][warp][4 * lane]);
      const float4 k4 = *reinterpret_cast<const float4*>(&sx[buf][1][warp][4 * lane]);
      const float qq = warp_sum(q4.x * q4.x + q4.y * q4.y + q4.z * q4.z + q4.w * q4.w);
      const float kk = warp_sum(k4.x * k4.x + k4.y * k4.y + k4.z * k4.z + k4.w * k4.w);
      const float qk = warp_sum(q4.x * k4.x + q4.y * k4.y + q4.z * k4.z + q4.w * k4.w);
      if (lane == 0) {
        sn[buf][warp][0] = rsqrtf(qq + kNormEps);
        sn[buf][warp][1] = rsqrtf(kk + kNormEps);
        sn[buf][warp][2] = qk;
      }
    }
    __syncthreads();
    if (t0 + kTile < len) fetch(t0 + kTile);

    for (int j = 0; j < cnt; ++j) {
      const float nq = sn[buf][j][0], nk = sn[buf][j][1], qk = sn[buf][j][2], bt = sb[buf][j];
      const float* sq = sx[buf][0][j];
      const float* sk = sx[buf][1][j];
      const float* se = sx[buf][3][j];
      float a0 = 0.f, a1 = 0.f, p0 = 0.f, p1 = 0.f;  // k . S and q . S over this thread's rows
#pragma unroll
      for (int m = 0; m < kSteps; ++m) {
        const float4 e4 = *reinterpret_cast<const float4*>(se + 16 * m + 4 * r);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + 16 * m + 4 * r);
        const float4 q4 = *reinterpret_cast<const float4*>(sq + 16 * m + 4 * r);
        float* x = &s[4 * m];
        x[0] *= e4.x; x[1] *= e4.y; x[2] *= e4.z; x[3] *= e4.w;
        a0 = fmaf(k4.x, x[0], a0); a1 = fmaf(k4.y, x[1], a1);
        a0 = fmaf(k4.z, x[2], a0); a1 = fmaf(k4.w, x[3], a1);
        p0 = fmaf(q4.x, x[0], p0); p1 = fmaf(q4.y, x[1], p1);
        p0 = fmaf(q4.z, x[2], p0); p1 = fmaf(q4.w, x[3], p1);
      }
      float ka = a0 + a1, qa = p0 + p1;
      ka += __shfl_xor_sync(0xffffffffu, ka, 1);
      qa += __shfl_xor_sync(0xffffffffu, qa, 1);
      ka += __shfl_xor_sync(0xffffffffu, ka, 2);
      qa += __shfl_xor_sync(0xffffffffu, qa, 2);
      const float u = bt * (sx[buf][2][j][c] - ka * nk);
      if (r == 0) o[(start + t0 + j) * width + h * kDim + c] = __float2bfloat16((qa * nq + u * (qk * nq * nk)) * scale);
      const float ku = u * nk;
#pragma unroll
      for (int m = 0; m < kSteps; ++m) {
        const float4 k4 = *reinterpret_cast<const float4*>(sk + 16 * m + 4 * r);
        float* x = &s[4 * m];
        x[0] = fmaf(k4.x, ku, x[0]); x[1] = fmaf(k4.y, ku, x[1]);
        x[2] = fmaf(k4.z, ku, x[2]); x[3] = fmaf(k4.w, ku, x[3]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kSteps; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i) S[(16 * m + 4 * r + i) * kDim + c] = s[4 * m + i];
  if (kind < 3) {
#pragma unroll
    for (int m = 0; m < kTaps - 1; ++m) hist_at[m * 3 * width] = __float2bfloat16(hist[m]);
  }
}

extern "C" const char* kda_error_string(int code) {
  if (code == -1) return "kda_scan: heads of 128 and 4 conv taps only";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int kda_scan(const void* q_raw, const void* k_raw, const void* v_raw, const void* q_taps,
                        const void* k_taps, const void* v_taps, const void* f, const void* b, const void* a_log,
                        const void* dt_bias, void* state, void* conv, const void* slots, const void* starts,
                        const void* lens, void* o, int seqs, int heads, int dim, int taps, float scale,
                        void* stream) {
  if (dim != kDim || taps != kTaps) return -1;
  if (seqs <= 0) return 0;
  using B16 = const __nv_bfloat16*;
  kda_scan_kernel<<<dim3(heads, seqs), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<B16>(q_raw), static_cast<B16>(k_raw), static_cast<B16>(v_raw), static_cast<B16>(q_taps),
      static_cast<B16>(k_taps), static_cast<B16>(v_taps), static_cast<B16>(f), static_cast<B16>(b),
      static_cast<const float*>(a_log), static_cast<const float*>(dt_bias), static_cast<float*>(state),
      static_cast<__nv_bfloat16*>(conv), static_cast<const int*>(slots), static_cast<const int*>(starts),
      static_cast<const int*>(lens), static_cast<__nv_bfloat16*>(o), heads, scale);
  return static_cast<int>(cudaGetLastError());
}
