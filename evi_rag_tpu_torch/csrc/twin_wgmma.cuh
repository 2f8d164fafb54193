// Hopper (sm_90a) device code shared by the three scoring kernels,
// per_question_topk.cu, score_bidirectional.cu and pooled_query.cu: a wgmma
// mainloop fed with pre-swizzled W1 tiles by bulk async copies, A rows built
// once per cluster and pushed to every CTA of it, and an epilogue that runs
// LayerNorm over H across the cluster.  wg_kernel runs kScore, kEdge and
// kQuestion; kernel 2's pooled pass (kPooled) has a kernel of its own in
// pooled_query.cu (wg_kernel_pooled) built from the primitives here.
//
// The functions (what each mode computes) are those of twin_score.cuh's
// header note; only the schedule differs.
//
// Layout of the work.
//   * A cluster of cH = ceil(H / 128) CTAs shares one tile of 128 edges;
//     CTA rank c owns the H columns [128c, 128c + 128) (W1 columns past H
//     are zero in the tile image and masked in the epilogue).
//   * A CTA has 384 threads: two consumer warpgroups (warps 0-7) and one
//     A-builder warpgroup (warps 8-11).  Consumer
//     warpgroup g owns edges [64g, 64g + 64) of the tile and two
//     accumulators of wgmma.m64n128k16 (f32, 64 registers each), acc0 and
//     acc1, whose meaning depends on the mode (below).
//   * W1 arrives as w1_tiles [cH][3D/64][128 n][64 k] bf16 (laid out once
//     on the host, ops/score_kernels.py::w1_tiles): each 16 KB tile is the
//     shared-memory image of a K-major 128-byte-swizzle wgmma B operand
//     (16-byte unit j of row n stored at unit j ^ (n % 8)), so one thread
//     (consumer thread 0, as both warpgroups release a stage) moves a tile
//     with one cp.async.bulk into a 4-stage mbarrier ring.
//   * Every CTA of the cluster needs the same A chunks (both accumulators'
//     [128 edges][64 k] bf16 per step, 32 KB, same swizzle; the last step of
//     a query also carries the query's dist of the 128 edges).  The builders
//     of CTA c build the rows of edges [c*128/cH, (c+1)*128/cH) only, and
//     push each 16-byte unit to every CTA's A ring (3 slots) with st.async,
//     which completes the receiving CTA's slot barrier; consumers release a
//     slot by arriving on every CTA's "empty" barrier of that slot.  So the
//     row build (CUDA cores) is done once per cluster, not once per CTA.
//     (Storing the rows locally and sending them with one shared-to-shared
//     bulk copy per peer and accumulator was slower on the H100.)
//   * Rows per W1 byte fetched from L2: 256 in kScore (each tile meets the
//     fwd and bwd rows of 128 edges) and kEdge ([sc_f|hmt] and [sc_b|-hmt]
//     rows).
//
// Modes (one launch each):
//   kScore  (score_bidirectional.cu): acc0 = [inter_f|sc_f|err_f] @ W1[:3D],
//           acc1 = the bwd rows; epilogue z = acc + dist*w1d + b1, then
//           LayerNorm over H, GELU, folded head, combine -> scores.
//   kQuestion (per_question_topk.cu): kScore's rows and epilogue, per
//           question g over its own candidates (rows g*M + m) and its own
//           gate/bias row, on the live tiles only (below) -> scores [G, M].
//           Its struct pre-pass writes sc as the A-chunk images of each tile
//           (the bytes a slot holds on a struct step), so on the D/64 struct
//           steps rank 0 fills every CTA's slot with one 32 KB
//           cp.async.bulk ... multicast::cluster and the builders push
//           nothing.
//   kEdge   (pooled_query.cu, per candidate): acc0 = sc_f @ W1s + hmt @ W1e,
//           acc1 = sc_b @ W1s - hmt @ W1e; epilogue c_{f,b} = acc + b1 ->
//           scratch [M, 2, H] f32.
//   kPooled (pooled_query.cu's wg_kernel_pooled, per query): zi = u @ W1i,
//           zr = r_ctx @ W1e; the rows, W1 tile order and err sums below
//           (tile_chunk, load_units, build_units) are its.
//
// Work items.  kScore: a cluster walks up to kQueriesPerCta
// queries over one tile (grid (cH, query groups, tiles)).  kEdge: one tile.
// kQuestion: the live tiles (question g, tile j with 128 j < min(len[g], M))
// of all G questions, in (g, j) order, are cut into one contiguous range per
// cluster (grid (cH * clusters)); every CTA of a cluster derives the same
// list from the lengths (question_items), so their barriers stay in step,
// and a cluster with no item returns before its first cluster_sync.  The W1
// and A rings run on across a cluster's items, and the builders' prefetch of
// the next step crosses into the next item's rows.  Edges of a partial tile
// past the prefix are built as zero rows and their scores are not written
// (the select reads positions past len[g] as -inf).
//
// Epilogue across the cluster: a row's LayerNorm sums (the mean, then the
// squared deviations) and its head dot are summed over the
// CTA's 128 columns inside a lane quad, pushed to every CTA of the cluster
// (st.async), and summed there in rank order; rank 0 writes the combined
// score.
//
// Ablation switches (compile-time, for measurement only; the scores are then
// wrong), in wg_kernel and pooled_query.cu's wg_kernel_pooled: WG_NO_MMA
// issues no wgmma, WG_NO_EPI skips the epilogue,
// WG_NO_BUILD has the builders push zero rows without loading or computing
// them.
// WG_GELU_ID replaces the epilogue's GELU by the identity.
// WG_TRACE records clock64 marks of the first CTA's steps (consumer thread
// 0 and builder thread 0; in wg_kernel_pooled the thread 0 of the step's
// consumer warpgroup and of each builder half) and epilogues into
// g_wg_trace (wg_trace_read).
// `python3 chip_smoke.py --ablation` builds and times them.

#pragma once

#include <algorithm>

#include "twin_score.cuh"

namespace {

constexpr int kSliceN = 128;                          // H columns per CTA
constexpr int kChunkK = 64;                           // k per tile / A chunk (one 128-byte swizzle row)
constexpr int kEdgesWG = 64;                          // edges per consumer warpgroup
constexpr int kEdgesCTA = 2 * kEdgesWG;               // edges per tile (per cluster)
constexpr int kStages = 4;                            // W1 tile ring
constexpr int kASlots = 3;                            // A chunk ring
constexpr int kTileBytes = kSliceN * kChunkK * 2;     // 16 KB
constexpr int kAChunkBytes = kEdgesWG * kChunkK * 2;  // 8 KB: one accumulator's rows of one warpgroup
constexpr int kASlotBytes = 4 * kAChunkBytes;         // [2 wg][2 acc]
constexpr int kConsumers = 256;
constexpr int kBuilders = 128;                        // warps 8-11
constexpr int kWgThreads = kConsumers + kBuilders;
constexpr int kMaxCluster = kMaxH / kSliceN;          // 8
constexpr int kQueriesPerCta = 8;                     // queries one CTA walks (kScore)
constexpr int kMaxItems = 256;                        // work items one kQuestion cluster walks

enum WgMode { kScore = 0, kEdge = 1, kPooled = 2, kQuestion = 3 };

// Modes whose A rows are [inter | sc | err] (the unfactorised form of
// twin_score.cuh's header note).
__host__ __device__ constexpr bool twin_rows(int mode) { return mode == kScore || mode == kQuestion; }

struct WgArgs {
  TwinWeights w;
  const __nv_bfloat16* w1_tiles;       // [cH][3D/64][128][64], pre-swizzled
  const __nv_bfloat16 *h, *r, *t;      // candidate rows [M, D] (kQuestion: [G * M, D])
  const __nv_bfloat16 *gate, *bias;    // [B, D] (kQuestion: [G, D])
  const __nv_bfloat16* sc;             // struct contexts: [rows, 2, D] (kScore, kEdge); kQuestion: the
                                       // A-chunk images [G * ceil(M/128)][D/64][32 KB] (struct_rows_kernel)
  const float* nav;                    // [rows, 2] nav gates
  float* c;                            // [M, 2, H] per-edge terms (kEdge writes, kPooled reads)
  float* scores;                       // score (b, m) at scores[b * ld_scores + m]
  const int* lengths;                  // [G] valid prefix of each question (kQuestion)
  long long ld_scores;
  int M, B, G;                         // kQuestion: M candidates per question, G questions
};

// One tile of a cluster's walk: queries' gate/bias row q, the candidate row
// of the tile's edge 0, the tile's first edge m0 (scores go to
// scores[q * ld + m0 + e]), and the edges below which rows are live.
struct WgItem {
  int q;
  long long row0;
  int m0, lim;
};

// Shared memory, from a 1024-byte aligned base.
constexpr int kSmemW = 0;                                          // [kStages][16 KB]
constexpr int kSmemA = kSmemW + kStages * kTileBytes;              // [kASlots][2 wg][2 acc][8 KB]
constexpr int kSmemX = kSmemA + kASlots * kASlotBytes;             // [3][2 par][8 rank][2 dir][128] f32
constexpr int kSmemDist = kSmemX + 3 * 2 * kMaxCluster * 2 * kEdgesCTA * 4;  // [kASlots][2 dir][128] f32
constexpr int kSmemDacc = kSmemDist + kASlots * 2 * kEdgesCTA * 4;  // [2 dir][128] f32 (builders)
constexpr int kSmemWts = kSmemDacc + 2 * kEdgesCTA * 4;           // [5][128] f32: w1d, b1, ln1s, ln1b, w2s slices
constexpr int kSmemBar = kSmemWts + 5 * kSliceN * 4;
// Barriers: W full/empty [kStages], A full/empty [kASlots], exchange [3][2].
constexpr int kBarWFull = 0, kBarWEmpty = kStages, kBarAFull = 2 * kStages, kBarAEmpty = kBarAFull + kASlots;
constexpr int kBarX = kBarAEmpty + kASlots, kBars = kBarX + 6;
constexpr int kDistBytes = 2 * kEdgesCTA * 4;                      // a query's dist, sent with its last step
constexpr int kSmemItems = kSmemBar + kBars * 8;                  // [kMaxItems] int2 (kQuestion)
constexpr int kSmemWsum = kSmemItems + kMaxItems * 8;              // [kWgThreads / 32] int
constexpr int kSmemEnd = kSmemWsum + (kWgThreads / 32) * 4;
constexpr size_t kWgSmemBytes = kSmemEnd + 1024;                   // + alignment slack

#ifdef WG_TRACE
constexpr int kTraceSteps = 512, kTraceItems = 16;
// [step][8] marks, then [item][8] epilogue marks (wg_kernel: start, before
// and after each of the three exchanges, the score written; wg_kernel_pooled
// marks its own epilogue's parts, pooled_query.cu).
constexpr int kTraceEpi = kTraceSteps * 8;
__device__ long long g_wg_trace[kTraceEpi + kTraceItems * 8];
#define WG_MARK(on, idx) \
  do {                   \
    if (on) g_wg_trace[idx] = clock64(); \
  } while (0)
#else
#define WG_MARK(on, idx) \
  do {                   \
  } while (0)
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of local shared address `a` in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spins until the phase of parity `parity` has completed; traps (a launch
// error, not a hung card) if that takes more than ~10 s.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > 20000000000ll) asm volatile("trap;");
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive on the barrier at shared::cluster address `bar` (any CTA).
// (Default .release.cta semantics, as CUTLASS's cluster barrier: the
// arrivals here release shared-memory slots whose readers, wgmma, have
// completed.  A .cluster-scope release per arrival was the largest single
// cost of the mainloop on the H100.)
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// `bytes` from global `src` to local shared address `dst` in every CTA of
// `mask`, completing the barrier at the same offset in each.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar,
                                                    uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], "
      "%4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// 16 bytes to shared::cluster address `dst`, completing 16 bytes of the
// transaction count of the barrier at `bar` (in the same CTA as dst).
__device__ __forceinline__ void st_async16(uint32_t dst, const uint4& v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void st_async4(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(dst),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// Orders this thread's view of shared memory (generic proxy) before the
// wgmma reads that follow (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// K-major, 128-byte swizzle: 8-row groups 1024 bytes apart (SBO), LBO unused.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] (desc a) @ B[16 x 128] (desc b), bf16 in, f32 sums.
// d[4j + c] is row 16*warp + lane/4 + 8*(c/2), column 8j + 2*(lane%4) + c%2.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 x = __bfloat1622float2(p[j]);
    f[2 * j] = x.x;
    f[2 * j + 1] = x.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return v;
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// The epilogue's GELU (twin_score.cuh's gelu_erf unless a switch says otherwise).
__device__ __forceinline__ float epi_gelu(float x) {
#ifdef WG_GELU_ID
  return x;
#else
  return gelu_erf(x);
#endif
}

// Which W1 chunk (of the 3D/64 in a column slice) the i-th tile of one
// query's (or, for kEdge, one edge tile's) mainloop is.
template <int kMode>
__device__ __forceinline__ int tile_chunk(int i, int kc) {
  if (twin_rows(kMode)) return i;                       // W1[:3D] in order
  if (kMode == kEdge) return kc + i;                    // W1s, then W1e
  return (i & 1) ? 2 * kc + (i >> 1) : (i >> 1);        // W1i, W1e, W1i, W1e, ...
}

// The raw 16-byte units that step s builds one edge's unit u from (columns
// 8u .. 8u+8 of the step's chunk): h, r, t, gate, bias (v[0..4]), or sc_f,
// sc_b (v[0], v[1]) on struct steps.
template <int kMode>
__device__ __forceinline__ void load_units(const WgArgs& p, size_t me, int s, int kc, int q, int u,
                                           uint4 (&v)[5]) {
  const size_t D = p.w.D;
  const int c = (kMode == kPooled ? s : s % kc) * kChunkK + 8 * u;
  if ((twin_rows(kMode) && s / kc == 1) || (kMode == kEdge && s < kc)) {
    v[0] = ldg16(p.sc + (2 * (size_t)me) * D + c);
    v[1] = ldg16(p.sc + (2 * (size_t)me + 1) * D + c);
    return;
  }
  v[0] = ldg16(p.h + (size_t)me * D + c);
  v[2] = ldg16(p.t + (size_t)me * D + c);
  if (kMode != kEdge) {
    v[1] = ldg16(p.r + (size_t)me * D + c);
    v[3] = ldg16(p.gate + (size_t)q * D + c);
    v[4] = ldg16(p.bias + (size_t)q * D + c);
  }
}

// The two A units (acc0's, acc1's) of step s from load_units' v, and their
// err sums (kScore / kQuestion err steps, kPooled) added to df / db.  The
// rounding points are those of the plain versions
// (per_question_scores_reference for kScore and kQuestion,
// fused_scores_reference's factorised rows otherwise).
template <int kMode>
__device__ __forceinline__ void build_units(const uint4 (&v)[5], int s, int kc, uint4& o0, uint4& o1, float& df,
                                            float& db, float navf, float navb) {
  const int seg = kMode == kPooled ? 0 : s / kc;
  if ((twin_rows(kMode) && seg == 1) || (kMode == kEdge && seg == 0)) {
    o0 = v[0];
    o1 = v[1];
    return;
  }
  float h8[8], t8[8], x0[8], x1[8];
  unpack8(v[0], h8);
  unpack8(v[2], t8);
  if (kMode == kEdge) {  // hmt and -hmt
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x0[j] = round_bf16(__fsub_rn(h8[j], t8[j]));
      x1[j] = -x0[j];
    }
  } else {
    float r8[8], g8[8], b8[8];
    unpack8(v[1], r8);
    unpack8(v[3], g8);
    unpack8(v[4], b8);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (twin_rows(kMode)) {
        // Separate roundings (no FMA contraction), as the plain version.
        const float rc = __fadd_rn(__fmul_rn(r8[j], g8[j]), b8[j]);
        if (seg == 0) {
          x0[j] = __fmul_rn(__fmul_rn(__fmul_rn(h8[j], rc), t8[j]), navf);
          x1[j] = __fmul_rn(__fmul_rn(__fmul_rn(t8[j], rc), h8[j]), navb);
        } else {
          x0[j] = __fsub_rn(__fadd_rn(h8[j], rc), t8[j]);
          x1[j] = __fsub_rn(__fadd_rn(t8[j], rc), h8[j]);
          df += x0[j] * x0[j];
          db += x1[j] * x1[j];
        }
      } else {
        // The factorised rows: u = bf16(prod*gate + (h*t)*bias), r_ctx.
        const float ht = __fmul_rn(h8[j], t8[j]);
        const float prod = round_bf16(__fmul_rn(ht, r8[j]));
        x0[j] = __fadd_rn(__fmul_rn(prod, g8[j]), __fmul_rn(ht, b8[j]));
        x1[j] = round_bf16(__fadd_rn(__fmul_rn(r8[j], g8[j]), b8[j]));
        const float hmt = round_bf16(__fsub_rn(h8[j], t8[j]));
        const float ef = round_bf16(__fadd_rn(x1[j], hmt));
        const float eb = round_bf16(__fsub_rn(x1[j], hmt));
        df += ef * ef;
        db += eb * eb;
      }
    }
  }
  o0 = pack8(x0);
  o1 = pack8(x1);
}

// Live edges of question g: its prefix, within [0, M].
__device__ __forceinline__ int question_lim(const WgArgs& p, int g) {
  return min(max(__ldg(p.lengths + g), 0), p.M);
}

// kQuestion: fills items[] with this cluster's work items (g, j), the
// cid-th of nclu contiguous ranges of the live tiles of all questions in
// (g, j) order, and returns their count.  Every CTA of the cluster computes
// the same list (integer sums only).  Thread t takes a slice of questions;
// a block scan of the slices' tile counts places each slice's items.
__device__ int question_items(const WgArgs& p, int cid, int nclu, int2* items, int* wsum) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_t = (p.G + kWgThreads - 1) / kWgThreads;
  const int g0 = min(p.G, tid * per_t), g1 = min(p.G, g0 + per_t);
  auto tiles = [&](int g) { return (question_lim(p, g) + kEdgesCTA - 1) / kEdgesCTA; };
  int cnt = 0;
  for (int g = g0; g < g1; ++g) cnt += tiles(g);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int a = incl - cnt, total = 0;  // a: global index of this thread's first item
  for (int w = 0; w < kWgThreads / 32; ++w) {
    if (w < warp) a += wsum[w];
    total += wsum[w];
  }
  const int per = (total + nclu - 1) / nclu;
  const int first = min(total, cid * per), last = min(total, first + per);
  for (int g = g0; g < g1; ++g) {
    const int t = tiles(g);
    for (int j = max(0, first - a); j < min(t, last - a); ++j) items[a + j - first] = make_int2(g, j);
    a += t;
  }
  __syncthreads();
  return last - first;
}

template <int kMode>
__global__ void __launch_bounds__(kWgThreads, 1) wg_kernel(WgArgs p) {
  static_assert(kMode != kPooled, "kPooled runs in wg_kernel_pooled (pooled_query.cu)");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int D = p.w.D, H = p.w.H, kc = D / kChunkK;
  // kQuestion's grid x holds `clusters` clusters; the other modes' one.
  const int ranks = kMode == kQuestion ? (H + kSliceN - 1) / kSliceN : gridDim.x;
  const int rank = kMode == kQuestion ? blockIdx.x % ranks : blockIdx.x;
  const int col0 = rank * kSliceN;
  const int tile_m0 = blockIdx.z * kEdgesCTA;
  const int q0 = kMode == kEdge ? 0 : blockIdx.y * kQueriesPerCta;
  const int2* items = reinterpret_cast<const int2*>(smem + kSmemItems);
  const int iters = kMode == kQuestion
                        ? question_items(p, blockIdx.x / ranks, gridDim.x / ranks,
                                         reinterpret_cast<int2*>(smem + kSmemItems),
                                         reinterpret_cast<int*>(smem + kSmemWsum))
                        : (kMode == kEdge ? 1 : min(kQueriesPerCta, p.B - q0));
  if (kMode == kQuestion && iters == 0) return;  // the same in every CTA of the cluster: no barrier touched
  // Work item it of this cluster's walk.
  auto item = [&](int it) -> WgItem {
    if (kMode == kQuestion) {
      const int2 x = items[it];
      return {x.x, (long long)x.x * p.M + x.y * kEdgesCTA, x.y * kEdgesCTA, question_lim(p, x.x)};
    }
    return {q0 + it, tile_m0, tile_m0, p.M};
  };
  const int steps = twin_rows(kMode) ? 3 * kc : 2 * kc;
  const int gsteps = iters * steps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#ifdef WG_TRACE
  const bool traced = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
#endif
  const uint32_t w_base = smem_u32(smem + kSmemW), a_smem = smem_u32(smem + kSmemA);
  const uint32_t bar0 = smem_u32(smem + kSmemBar);
  auto bar = [&](int i) { return bar0 + 8 * i; };
  float* xbuf = reinterpret_cast<float*>(smem + kSmemX);
  float* dist = reinterpret_cast<float*>(smem + kSmemDist);
  float* dacc = reinterpret_cast<float*>(smem + kSmemDacc);
  const uint32_t x_smem = smem_u32(xbuf), dist_smem = smem_u32(dist);
  // Bytes that land in the A slot of global step g: its rows, and the
  // query's dist with its last step.
  auto slot_bytes = [&](int g) {
    return kASlotBytes + (kMode != kEdge && g % steps == steps - 1 ? kDistBytes : 0);
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kBarWFull + s), 1);
      mbar_init(bar(kBarWEmpty + s), 2);
    }
    for (int s = 0; s < kASlots; ++s) {
      mbar_init(bar(kBarAFull + s), 1);
      mbar_init(bar(kBarAEmpty + s), 2 * ranks);
    }
    for (int i = 0; i < 6; ++i) mbar_init(bar(kBarX + i), 1);
    // Arm the first phase of every A slot and exchange buffer in use.
    for (int g = 0; g < kASlots && g < gsteps; ++g) mbar_expect_tx(bar(kBarAFull + g), slot_bytes(g));
    if (kMode != kEdge) {
      for (int par = 0; par < 2 && par < iters; ++par)
        for (int k = 0; k < 3; ++k) mbar_expect_tx(bar(kBarX + 2 * k + par), ranks * 2 * kEdgesCTA * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < 2 * kEdgesCTA) dacc[tid] = 0.f;
  // The epilogue's per-column weights of this CTA's slice (0 past H).
  float* wts = reinterpret_cast<float*>(smem + kSmemWts);
  if (tid < kSliceN) {
    const int col = col0 + tid;
    const bool ok = col < H;
    wts[tid] = ok ? p.w.w1d[col] : 0.f;
    wts[kSliceN + tid] = ok ? p.w.b1[col] : 0.f;
    wts[2 * kSliceN + tid] = ok ? p.w.ln1s[col] : 0.f;
    wts[3 * kSliceN + tid] = ok ? p.w.ln1b[col] : 0.f;
    wts[4 * kSliceN + tid] = ok ? p.w.w2s[col] : 0.f;
  }
  cluster_sync();

  const int tpi = steps;                                  // W1 tiles per work item (one a step)
  const __nv_bfloat16* w_src = p.w1_tiles + (size_t)rank * 3 * kc * (kTileBytes / 2);
  auto issue_tile = [&](int i) {  // W1 tile i of this CTA's sequence into ring stage i % kStages
    const int st = i % kStages;
    mbar_expect_tx(bar(kBarWFull + st), kTileBytes);
    bulk_copy(w_base + st * kTileBytes, w_src + (size_t)tile_chunk<kMode>(i % tpi, kc) * (kTileBytes / 2),
              kTileBytes, bar(kBarWFull + st));
  };
  if (tid == 0)
    for (int i = 0; i < kStages && i < iters * tpi; ++i) issue_tile(i);

  if (warp >= kConsumers / 32) {
    // ---- A builders: this CTA's share of the tile's edges, 8 threads per
    // edge (one 16-byte unit each), 16 edges per round (one round at
    // H > 896); each unit goes to every CTA of the cluster.  The raw units
    // of the next step (first round) load while this step waits for its
    // slot and builds; they stay in registers (a runtime-indexed second
    // round spilled both rounds to local memory, and each prefetch then
    // waited for its loads).
    const int bt = tid - kConsumers, u = bt & 7;
    const int per = (kEdgesCTA + ranks - 1) / ranks, e0 = rank * per, e1 = min(kEdgesCTA, e0 + per);
    const int rounds = (per + kBuilders / 8 - 1) / (kBuilders / 8);
    auto edge_of = [&](int rd) { return e0 + rd * (kBuilders / 8) + (bt >> 3); };
    // kQuestion's struct steps arrive by bulk copy (rank 0), not from the builders.
    auto bulk_step = [&](int s) { return kMode == kQuestion && s / kc == 1; };
    auto fetch = [&](int g, int rd, uint4 (&v)[5]) {
      const int e = edge_of(rd);
      if (g >= gsteps || e >= e1 || bulk_step(g % steps)) return;
      const WgItem wi = item(g / steps);  // the next step may be the next item's
      if (wi.m0 + e < wi.lim) load_units<kMode>(p, wi.row0 + e, g % steps, kc, wi.q, u, v);
    };
    uint4 cur[5], nxt[5];
    float nav0[2] = {0.f, 0.f};  // nav of the first round's edge (twin rows)
    auto load_nav = [&](const WgItem& wi) {
      const int e = edge_of(0);
      if (e < e1 && wi.m0 + e < wi.lim) {
        nav0[0] = p.nav[2 * (size_t)(wi.row0 + e)];
        nav0[1] = p.nav[2 * (size_t)(wi.row0 + e) + 1];
      }
    };
    fetch(0, 0, cur);
    if (kMode == kScore) load_nav(item(0));  // the same edges for every query
    for (int g = 0; g < gsteps; ++g) {
      const int it = g / steps, s = g % steps, slot = g % kASlots;
      const WgItem wi = item(it);
      if (kMode == kQuestion && s == 0) load_nav(wi);  // each item has its own edges
      fetch(g + 1, 0, nxt);
      WG_MARK(traced && bt == 0 && g < kTraceSteps, g * 8 + 5);
      mbar_wait(bar(kBarAEmpty + slot), ((g / kASlots) & 1) ^ 1);
      WG_MARK(traced && bt == 0 && g < kTraceSteps, g * 8 + 6);
      if (bulk_step(s)) {
        // The tile's sc image of this chunk, to every CTA, once all released the slot.  (Every
        // builder still waits for the slot: a parity wait must never run a phase ahead.)
        if (rank == 0 && bt == 0) {
          const long long tile = (long long)wi.q * ((p.M + kEdgesCTA - 1) / kEdgesCTA) + wi.m0 / kEdgesCTA;
          bulk_copy_multicast(a_smem + slot * kASlotBytes, p.sc + (tile * kc + s % kc) * (kASlotBytes / 2),
                              kASlotBytes, bar(kBarAFull + slot), static_cast<uint16_t>((1u << ranks) - 1));
        }
#pragma unroll
        for (int x = 0; x < 5; ++x) cur[x] = nxt[x];  // the next step's units, if it is built
        WG_MARK(traced && bt == 0 && g < kTraceSteps, g * 8 + 7);
        continue;  // (a struct step is never a work item's last: no dist to send)
      }
      for (int rd = 0; rd < rounds; ++rd) {
        const int e = edge_of(rd);
        const bool valid = e < e1;
        const size_t me = wi.row0 + e;
        float df = 0.f, db = 0.f;
        if (valid) {
          uint4 o0 = make_uint4(0u, 0u, 0u, 0u), o1 = o0;
#ifdef WG_NO_BUILD
          if (false) {
#else
          if (wi.m0 + e < wi.lim) {
#endif
            uint4 v[5];
            float navf, navb;
            if (rd == 0) {
#pragma unroll
              for (int x = 0; x < 5; ++x) v[x] = cur[x];
              navf = nav0[0];
              navb = nav0[1];
            } else {
              load_units<kMode>(p, me, s, kc, wi.q, u, v);
              navf = twin_rows(kMode) ? p.nav[2 * me] : 0.f;
              navb = twin_rows(kMode) ? p.nav[2 * me + 1] : 0.f;
            }
            build_units<kMode>(v, s, kc, o0, o1, df, db, navf, navb);
          }
          const int wg = e / kEdgesWG, row = e % kEdgesWG;
          const uint32_t off = slot * kASlotBytes + wg * 2 * kAChunkBytes + row * 128 + ((u ^ (row & 7)) << 4);
          for (int rk = 0; rk < ranks; ++rk) {
            const uint32_t fb = mapa(bar(kBarAFull + slot), rk);
            st_async16(mapa(a_smem + off, rk), o0, fb);
            st_async16(mapa(a_smem + off + kAChunkBytes, rk), o1, fb);
          }
        }
        if (kMode != kEdge) {
          // dist sums: the 8 threads of an edge, then over steps in dacc.
          df += __shfl_xor_sync(0xffffffffu, df, 1);
          df += __shfl_xor_sync(0xffffffffu, df, 2);
          df += __shfl_xor_sync(0xffffffffu, df, 4);
          db += __shfl_xor_sync(0xffffffffu, db, 1);
          db += __shfl_xor_sync(0xffffffffu, db, 2);
          db += __shfl_xor_sync(0xffffffffu, db, 4);
          if (valid && u == 0) {
            dacc[e] += df;
            dacc[kEdgesCTA + e] += db;
          }
        }
      }
#pragma unroll
      for (int x = 0; x < 5; ++x) cur[x] = nxt[x];
      WG_MARK(traced && bt == 0 && g < kTraceSteps, g * 8 + 7);
      if (kMode != kEdge && s == steps - 1) {
        // The query's dist of this CTA's edges, to every CTA, with the
        // query's last A slot.
        __syncwarp();
        for (int rd = 0; rd < rounds; ++rd) {
          const int e = edge_of(rd);
          if (e < e1 && u == 0) {
            const float dfv = -sqrtf(dacc[e] + 1e-12f), dbv = -sqrtf(dacc[kEdgesCTA + e] + 1e-12f);
            dacc[e] = dacc[kEdgesCTA + e] = 0.f;
            const uint32_t off = (slot * 2 * kEdgesCTA + e) * 4;
            for (int rk = 0; rk < ranks; ++rk) {
              const uint32_t fb = mapa(bar(kBarAFull + slot), rk);
              st_async4(mapa(dist_smem + off, rk), dfv, fb);
              st_async4(mapa(dist_smem + off + kEdgesCTA * 4, rk), dbv, fb);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg, thread tw of 128.
    const int wg = warp >> 2, tw = tid & 127;
    // Epilogue rows: edges e[0] (row lane/4 of the warp's 16) and e[1] = e[0] + 8.
    int ecta[2];
    ecta[0] = wg * kEdgesWG + (warp & 3) * 16 + (lane >> 2);
    ecta[1] = ecta[0] + 8;
    float acc0[64], acc1[64];
    float dv[2][2];  // dist of the epilogue rows (dir, row)

    // Sum of per-(dir, edge) partials over the cluster: the lane quad (the
    // CTA's 128 columns), pushed to every CTA's exchange buffer k, then the
    // ranks' values summed in rank order.
    auto cluster_row_sum = [&](float (&part)[2][2], int k, int it) {
      WG_MARK(traced && tid == 0 && it < kTraceItems, kTraceEpi + it * 8 + 2 * k + 1);
      const int par = it & 1;
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          part[dir][i] += __shfl_xor_sync(0xffffffffu, part[dir][i], 1);
          part[dir][i] += __shfl_xor_sync(0xffffffffu, part[dir][i], 2);
        }
      const int xb = kBarX + 2 * k + par;
      const int base = ((k * 2 + par) * kMaxCluster) * 2 * kEdgesCTA;  // [k][par][rank][dir][edge]
      if ((lane & 3) == 0) {
        for (int rk = 0; rk < ranks; ++rk) {
          const uint32_t fb = mapa(bar(xb), rk);
#pragma unroll
          for (int dir = 0; dir < 2; ++dir)
#pragma unroll
            for (int i = 0; i < 2; ++i)
              st_async4(mapa(x_smem + 4 * (base + (rank * 2 + dir) * kEdgesCTA + ecta[i]), rk), part[dir][i], fb);
        }
      }
      mbar_wait(bar(xb), (it >> 1) & 1);
      if (tid == 0 && it + 2 < iters) mbar_expect_tx(bar(xb), ranks * 2 * kEdgesCTA * 4);
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float sum = 0.f;
          for (int rk = 0; rk < ranks; ++rk) sum += xbuf[base + (rk * 2 + dir) * kEdgesCTA + ecta[i]];
          part[dir][i] = sum;
        }
      WG_MARK(traced && tid == 0 && it < kTraceItems, kTraceEpi + it * 8 + 2 * k + 2);
    };

    for (int it = 0; it < iters; ++it) {
      const WgItem wi = item(it);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      for (int s = 0; s < steps; ++s) {
        const int g = it * steps + s, slot = g % kASlots;
        const int st0 = g % kStages;
        WG_MARK(traced && tid == 0 && g < kTraceSteps, g * 8 + 0);
        mbar_wait(bar(kBarWFull + st0), (g / kStages) & 1);
        WG_MARK(traced && tid == 0 && g < kTraceSteps, g * 8 + 1);
        mbar_wait(bar(kBarAFull + slot), (g / kASlots) & 1);
        WG_MARK(traced && tid == 0 && g < kTraceSteps, g * 8 + 2);
        if (tid == 0 && g + kASlots < gsteps) mbar_expect_tx(bar(kBarAFull + slot), slot_bytes(g + kASlots));
        if (kMode != kEdge && s == steps - 1) {  // the query's dist, read before the slot is released
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dv[0][i] = dist[slot * 2 * kEdgesCTA + ecta[i]];
            dv[1][i] = dist[slot * 2 * kEdgesCTA + kEdgesCTA + ecta[i]];
          }
        }
        fence_async_smem();
        __syncwarp();  // wgmma is warp-aligned: reconverge after the waits
        const uint32_t a0 = a_smem + slot * kASlotBytes + wg * 2 * kAChunkBytes;
        const uint64_t da0 = sw128_desc(a0), da1 = sw128_desc(a0 + kAChunkBytes);
        const uint64_t db0 = sw128_desc(w_base + st0 * kTileBytes);
        wgmma_fence();
        acc_fence(acc0);
        acc_fence(acc1);
#ifndef WG_NO_MMA
#pragma unroll
        for (int kk = 0; kk < kChunkK / 16; ++kk) {  // 32 bytes of k per step: +2 in the descriptor
          wgmma_m64n128k16(acc0, da0 + 2 * kk, db0 + 2 * kk);
          wgmma_m64n128k16(acc1, da1 + 2 * kk, db0 + 2 * kk);
        }
#endif
        wgmma_commit();
        wgmma_wait_all();
        acc_fence(acc0);
        acc_fence(acc1);
        WG_MARK(traced && tid == 0 && g < kTraceSteps, g * 8 + 3);
        __syncwarp();
        if (tw == 0) mbar_arrive(bar(kBarWEmpty + st0));
        if (tw < ranks) mbar_arrive_cluster(mapa(bar(kBarAEmpty + slot), tw));  // one lane per CTA
        if (tid == 0 && g + kStages < iters * tpi) {  // refill the stage both warpgroups have released
          mbar_wait(bar(kBarWEmpty + st0), (g / kStages) & 1);
          issue_tile(g + kStages);
        }
        WG_MARK(traced && tid == 0 && g < kTraceSteps, g * 8 + 4);
        __syncwarp();
      }

      if (kMode == kEdge) {
        // c_{f,b} = acc + b1 -> scratch.
#pragma unroll
        for (int jn = 0; jn < kSliceN / 8; ++jn) {
          const int col = col0 + 8 * jn + 2 * (lane & 3);
          if (col < H) {
            const float2 bb = *reinterpret_cast<const float2*>(wts + kSliceN + col - col0);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int m = wi.m0 + ecta[i];
              if (m < wi.lim) {
                float* cp = p.c + (2 * (size_t)m) * H + col;
                *reinterpret_cast<float2*>(cp) =
                    make_float2(acc0[4 * jn + 2 * i] + bb.x, acc0[4 * jn + 2 * i + 1] + bb.y);
                *reinterpret_cast<float2*>(cp + H) =
                    make_float2(acc1[4 * jn + 2 * i] + bb.x, acc1[4 * jn + 2 * i + 1] + bb.y);
              }
            }
          }
        }
        continue;
      }
#ifdef WG_NO_EPI
      if (tw < 2 && rank == 0 && wi.m0 + tw < wi.lim)
        p.scores[(long long)wi.q * p.ld_scores + wi.m0 + tw] = acc0[0] + acc1[5];
      continue;
#endif

      WG_MARK(traced && tid == 0 && it < kTraceItems, kTraceEpi + it * 8);
      // z into acc0 (fwd) and acc1 (bwd); columns past H are zero.
      float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int jn = 0; jn < kSliceN / 8; ++jn) {
        const int col = col0 + 8 * jn + 2 * (lane & 3);
        const bool ok = col < H;
        const float2 wd = *reinterpret_cast<const float2*>(wts + col - col0);
        const float2 bb = *reinterpret_cast<const float2*>(wts + kSliceN + col - col0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = c >> 1;
          const float w = (c & 1) ? wd.y : wd.x;
          const float b = (c & 1) ? bb.y : bb.x;
          float zf = acc0[4 * jn + c] + dv[0][i] * w + b;
          float zb = acc1[4 * jn + c] + dv[1][i] * w + b;
          if (!ok) zf = zb = 0.f;
          acc0[4 * jn + c] = zf;
          acc1[4 * jn + c] = zb;
          part[0][i] += zf;
          part[1][i] += zb;
        }
      }
      cluster_row_sum(part, 0, it);
      float mean[2][2], rstd[2][2];
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mean[dir][i] = part[dir][i] / H;
          part[dir][i] = 0.f;
        }
#pragma unroll
      for (int jn = 0; jn < kSliceN / 8; ++jn) {
        if (col0 + 8 * jn < H) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float a = acc0[4 * jn + c] - mean[0][c >> 1], b = acc1[4 * jn + c] - mean[1][c >> 1];
            part[0][c >> 1] += a * a;
            part[1][c >> 1] += b * b;
          }
        }
      }
      cluster_row_sum(part, 1, it);
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          rstd[dir][i] = rsqrtf(part[dir][i] / H + 1e-5f);
          part[dir][i] = 0.f;
        }
      // GELU and the folded head of column block jn (acc*[base .. base + 4)).
      auto gelu_head = [&](int jn, int base) {
        const int col = col0 + 8 * jn + 2 * (lane & 3);
        if (col < H) {
          const float2 ls = *reinterpret_cast<const float2*>(wts + 2 * kSliceN + col - col0);
          const float2 lb = *reinterpret_cast<const float2*>(wts + 3 * kSliceN + col - col0);
          const float2 w2 = *reinterpret_cast<const float2*>(wts + 4 * kSliceN + col - col0);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c >> 1;
            const bool odd = c & 1;
            const float s = odd ? ls.y : ls.x, o = odd ? lb.y : lb.x, w = odd ? w2.y : w2.x;
            part[0][i] += epi_gelu((acc0[base + c] - mean[0][i]) * rstd[0][i] * s + o) * w;
            part[1][i] += epi_gelu((acc1[base + c] - mean[1][i]) * rstd[1][i] * s + o) * w;
          }
        }
      };
      if (kMode == kQuestion) {
        // A rolled loop: block jn is always acc*[0..3] (the blocks shift down
        // one per turn; this pass is the accumulators' last use).  Fully
        // unrolled, the 128 inlined GELUs were ~80 KB of straight-line code
        // run once per item, and this pass took ~2.3x as long.  (kScore
        // keeps the unrolled loop.)
#pragma unroll 1
        for (int jn = 0; jn < kSliceN / 8; ++jn) {
          gelu_head(jn, 0);
#pragma unroll
          for (int i = 0; i < 60; ++i) {
            acc0[i] = acc0[i + 4];
            acc1[i] = acc1[i + 4];
          }
        }
      } else {
#pragma unroll
        for (int jn = 0; jn < kSliceN / 8; ++jn) gelu_head(jn, 4 * jn);
      }
      cluster_row_sum(part, 2, it);
      if (rank == 0 && (lane & 3) == 0) {
        const float b2 = p.w.b2s[0];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wi.m0 + ecta[i];
          if (m < wi.lim) p.scores[(long long)wi.q * p.ld_scores + m] = combine(part[0][i] + b2, part[1][i] + b2);
        }
      }
      WG_MARK(traced && tid == 0 && it < kTraceItems, kTraceEpi + it * 8 + 7);
    }
  }
  // No CTA leaves while a peer may still push to or arrive on its shared memory.
  cluster_sync();
}

// Launches wg_kernel<kMode> with a cluster of ceil(H / 128) CTAs; returns
// the CUDA error (a cluster that cannot be scheduled is refused).  kScore,
// kEdge: one cluster per tile of M edges (and group of B queries).
// kQuestion: `clusters` clusters walk the live tiles of G questions of M
// candidates each; 0 asks for as many as the card holds at once
// (persistent), and the count is raised so that no cluster walks more than
// kMaxItems tiles.
template <int kMode>
cudaError_t launch_wg(const WgArgs& a, cudaStream_t stream, int clusters = 0) {
  const int ranks = (a.w.H + kSliceN - 1) / kSliceN;
  const int qgroups = kMode == kEdge ? 1 : (a.B + kQueriesPerCta - 1) / kQueriesPerCta;
  const int tiles = (a.M + kEdgesCTA - 1) / kEdgesCTA;
  if (kMode != kQuestion && (tiles > 65535 || qgroups > 65535)) return cudaErrorInvalidValue;
  void (*fn)(WgArgs) = wg_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWgSmemBytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = kMode == kQuestion ? dim3(ranks, 1, 1) : dim3(ranks, qgroups, tiles);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = kWgSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorLaunchOutOfResources;  // the cluster cannot be scheduled
  if (kMode == kQuestion) {
    const long long items = (long long)a.G * tiles;
    long long n = clusters > 0 ? clusters : fit;
    n = std::max(std::min(n, items), (items + kMaxItems - 1) / kMaxItems);
    if (n * ranks > 0x7fffffffll) return cudaErrorInvalidValue;
    cfg.gridDim = dim3(static_cast<unsigned>(n * ranks), 1, 1);
  }
  return cudaLaunchKernelEx(&cfg, fn, a);
}

// One warp per edge: sc_{f,b} (bf16) and nav_{f,b} (f32) of n edges, the
// query-independent struct terms, into sc and nav [n, 2].  Without lengths
// (kScore, kEdge): sc [n, 2, D].  With lengths (kQuestion, n = G * M): edge
// g*M + m is skipped unless m < lengths[g], and sc is the A-chunk images
// that wg_kernel<kQuestion> bulk-copies: edge e of tile t = g*ceil(M/128) +
// m/128 (e = m % 128) is row e % 64 of warpgroup e / 64's fwd (acc0) and bwd
// (acc1) chunks, chunk c of the tile at sc + (t * D/64 + c) * 16384.
__global__ void __launch_bounds__(kThreads) struct_rows_kernel(TwinWeights w, const __nv_bfloat16* st,
                                                               __nv_bfloat16* sc, float* nav, long long n,
                                                               const int* lengths, int M) {
  const int lane = threadIdx.x & 31;
  const long long m = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (m >= n || (lengths && m % M >= __ldg(lengths + m / M))) return;
  float nv[2];
  if (lengths) {
    const int e = static_cast<int>(m % M) % kEdgesCTA, row = e % kEdgesWG;
    const long long tile = m / M * ((M + kEdgesCTA - 1) / kEdgesCTA) + m % M / kEdgesCTA;
    __nv_bfloat16* rowf =
        sc + tile * (kASlotBytes / 2) * (w.D / kChunkK) + (e / kEdgesWG) * kAChunkBytes + row * kChunkK;
    build_struct_rows(w, st + (size_t)m * w.S, rowf, rowf + kAChunkBytes / 2, nv, lane, kASlotBytes / 2, row & 7);
  } else {
    build_struct_rows(w, st + (size_t)m * w.S, sc + 2 * (size_t)m * w.D, sc + (2 * (size_t)m + 1) * w.D, nv, lane);
  }
  if (lane == 0) {
    nav[2 * (size_t)m] = nv[0];
    nav[2 * (size_t)m + 1] = nv[1];
  }
}

inline cudaError_t launch_struct_rows(const TwinWeights& w, const __nv_bfloat16* st, __nv_bfloat16* sc,
                                      float* nav, long long n, const int* lengths, int M, cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
  struct_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(w, st, sc, nav, n, lengths, M);
  return cudaGetLastError();
}

}  // namespace
