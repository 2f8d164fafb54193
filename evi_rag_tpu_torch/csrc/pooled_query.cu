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
// then LayerNorm over H (eps 1e-5), exact erf GELU, the folded head and the
// combine.
//
// Design: three launches per chunk of candidates (twin_wgmma.cuh).
//   (a) struct_rows_kernel: sc_{f,b} bf16 [M, 2, D] and nav_{f,b} [M, 2].
//   (b) wg_kernel<kEdge>: one GEMM over the edges on the wgmma mainloop,
//       A rows [sc_f | hmt] and [sc_b | -hmt] against [W1s; W1e]:
//       c_{f,b} = acc + b1 into scratch [M, 2, H] f32.
//   (c) wg_kernel_pooled (below): the per-query pass, zi = u @ W1i and
//       zr = r_ctx @ W1e, then the epilogue, on ping-pong consumers.
//
// What bounded (c) before this schedule (chip_smoke.py --ablation, clock64
// marks of the first CTA, PERF.md): two consumer warpgroups ran the same
// query (64 rows each of a 128-edge tile), then its epilogue on the same
// threads: ~52k cycles a query (GELU and head 24k, z with c read back from L2
// 11k, three cluster exchanges 14k) after ~71k of mainloop, no wgmma issued
// meanwhile.  A query's accumulators (128 KB a CTA) leave no registers or
// shared memory to hand z to other warps, and A from registers would have
// every CTA build all rows (slower, PERF.md), so:
//
// Schedule: ping-pong consumers.  A CTA takes a tile of 64 edges and up to
// kPQueries queries; consumer warpgroup w takes queries it = w, w + 2, ...,
// each a 64 x 128 (edges x this CTA's H columns) zi in acc0 and zr in acc1.
// While one warpgroup runs a query's epilogue the other runs the next
// query's mainloop on the tensor cores.  The W1 ring and the A ring are
// consumed in (query, step) order; a warpgroup starts query it's mainloop
// once the other has passed every wait of query it-1's last step (the `go`
// barriers), so no parity wait runs a phase ahead.  The warpgroup that
// releases a W1 stage refills it (it is the stage's only reader).
//   * Rows per W1 byte from L2 fall from 128 to 64 (each tile meets one
//     warpgroup's 64 rows): ~1.07 TB a 128-query call at M = 131,072.
//   * c_{f,b} and nav_{f,b} of the tile are read once per CTA into shared
//     memory (64 KB), not once per query from L2.
//   * LayerNorm's mean and variance take one cluster exchange: each CTA
//     sends its columns' mean and sum of squared deviations about it,
//     merged by Chan's formula; the head partials go to every CTA, and each
//     writes the scores of 1/8 of the rows.  Each lane of a quad sends,
//     merges and writes one (direction, row).
//   * The builder warpgroup is two halves of 64 threads, each on every
//     other (query, step): 8 edges of the tile per CTA and step (1/8 each),
//     pushed to every CTA with st.async.  Each half sends its err sums of a
//     query with its last step of it (step kc-2 or kc-1).
//   * 32 queries a CTA: the ping-pong's fill and drain (one mainloop, one
//     epilogue) were a quarter of a CTA's cycles at 8.
//
// Shared memory: W1 ring 6 x 16 KB (three steps), A ring 2 x 16 KB (u |
// r_ctx rows; one slot a builder half), c 64 KB, exchange 24 KB, ~5.5 KB of
// dist, nav, weights and barriers: kPSmemBytes (227,472 bytes with the
// alignment slack).  Registers: launched at 168 a thread (384 threads, one
// CTA an SM); setmaxnreg moves them to 208 for the consumers (128
// accumulators and the epilogue) and 88 for the builders.
//
// Measured (PERF.md, H100 SXM at 700 W, B = 128, M = 32,768, scaled to
// M = 131,072): the launch 374 ms against 531 for the earlier schedule.  A
// 64-row step takes ~2.3k cycles (8 wgmma ~1.3k, W1 wait ~0.4k): the W1
// stream from L2 (~2.9 TB/s; 3.4 without the epilogue) now paces the
// mainloop, ~37k cycles a query against ~32k of epilogue.
//
// Bound at D = H = 1024: 2 x 2*D*H = 4.19 MFLOP per (edge, query), plus
// 3 x 2*D*H per edge: 7.1e13 FLOP at B = 128, M = 131,072, 72 ms at
// 989 TFLOP/s; the tensor cores bound it.

#include "twin_wgmma.cuh"

namespace {

constexpr int kPEdges = 64;                             // edges per tile: one wgmma m64 block
constexpr int kPQueries = 32;                           // queries one CTA walks (16 a consumer warpgroup)
// Registers a thread after setmaxnreg: the builders give up what the
// consumers' accumulators and epilogue need.  setmaxnreg moves registers
// within what the CTA was launched with (384 threads at 168, multiples of 8).
constexpr int kPLaunchRegs = 65536 / kWgThreads / 8 * 8;
constexpr int kPBuilderRegs = 88;
constexpr int kPConsumerRegs = (kWgThreads * kPLaunchRegs - kBuilders * kPBuilderRegs) / kConsumers / 8 * 8;
static_assert(kBuilders * kPBuilderRegs + kConsumers * kPConsumerRegs <= kWgThreads * kPLaunchRegs,
              "setmaxnreg cannot take more registers than the CTA was launched with");
constexpr int kPStages = 6;                             // W1 ring (three steps)
constexpr int kPSlots = 2;                              // A ring; even, so each builder half owns its slots
constexpr int kPSlotBytes = 2 * kAChunkBytes;           // [u | r_ctx] rows of the tile, 16 KB
constexpr int kPDistBytes = 2 * kPEdges * 4;            // a builder half's err sums [2 dir][64]
constexpr int kPXStats = kMaxCluster * 2 * kPEdges * 2;  // floats [rank][dir][row][mean, M2]
constexpr int kPXHead = kMaxCluster * 2 * kPEdges;       // floats [rank][dir][row]
// Shared memory, from a 1024-byte aligned base.
constexpr int kPSmemW = 0;                                         // [kPStages][16 KB]
constexpr int kPSmemA = kPSmemW + kPStages * kTileBytes;           // [kPSlots][u, r_ctx][64][128 B]
constexpr int kPSmemC = kPSmemA + kPSlots * kPSlotBytes;           // [64][2 dir][128] f32, swizzled
constexpr int kPSmemX = kPSmemC + kPEdges * 2 * kSliceN * 4;       // [2 wg][stats | head] f32
constexpr int kPSmemDist = kPSmemX + 2 * (kPXStats + kPXHead) * 4;  // [kPSlots][2 dir][64] f32
constexpr int kPSmemDacc = kPSmemDist + kPSlots * kPDistBytes;     // [2 half][2 dir][64] f32 (builders)
constexpr int kPSmemNav = kPSmemDacc + 2 * kPDistBytes;            // [64][2] f32
constexpr int kPSmemWts = kPSmemNav + 2 * kPEdges * 4;             // [5][128] f32: w1d, b1, ln1s, ln1b, w2s
constexpr int kPSmemBar = kPSmemWts + 5 * kSliceN * 4;
// Barriers: W1 full, A full / empty, and per warpgroup the stats and head
// exchanges, the stats buffer free again, and the go to its next mainloop.
constexpr int kPBarW = 0, kPBarAFull = kPStages, kPBarAEmpty = kPBarAFull + kPSlots;
constexpr int kPBarStats = kPBarAEmpty + kPSlots, kPBarHead = kPBarStats + 2, kPBarFree = kPBarHead + 2;
constexpr int kPBarGo = kPBarFree + 2, kPBars = kPBarGo + 2;
constexpr size_t kPSmemBytes = kPSmemBar + kPBars * 8 + 1024;      // + alignment slack
static_assert(kPSmemBytes <= 232448, "wg_kernel_pooled's shared memory exceeds a block's 227 KB");

// Column cc (0..127) of c row e, direction dir in the tile's c image: the
// 8-float groups are XOR-swizzled by e % 4, so that the float2 reads of a
// half warp (4 rows, 4 lanes a row) hit 32 distinct banks.
__device__ __forceinline__ int c_index(int e, int dir, int cc) {
  return (e * 2 + dir) * kSliceN + (cc ^ ((e & 3) << 3));
}

__global__ void __launch_bounds__(kWgThreads, 1) wg_kernel_pooled(WgArgs p) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned, by pointer arithmetic on the shared array (so that its
  // accesses stay shared-memory ones, not generic).
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const int D = p.w.D, H = p.w.H, kc = D / kChunkK;
  const int ranks = gridDim.x, rank = blockIdx.x, col0 = rank * kSliceN;
  const int m0 = blockIdx.z * kPEdges, q0 = blockIdx.y * kPQueries;
  const int iters = min(kPQueries, p.B - q0);
  const int gsteps = iters * kc, tiles = 2 * gsteps;  // (query, step) pairs; W1 tiles, two a step
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
#ifdef WG_TRACE
  const bool traced = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
#endif
  const uint32_t w_base = smem_u32(smem + kPSmemW), a_smem = smem_u32(smem + kPSmemA);
  const uint32_t bar0 = smem_u32(smem + kPSmemBar);
  auto bar = [&](int i) { return bar0 + 8 * i; };
  float* cbuf = reinterpret_cast<float*>(smem + kPSmemC);
  float* xbuf = reinterpret_cast<float*>(smem + kPSmemX);
  float* dist = reinterpret_cast<float*>(smem + kPSmemDist);
  float* navs = reinterpret_cast<float*>(smem + kPSmemNav);
  float* wts = reinterpret_cast<float*>(smem + kPSmemWts);
  const uint32_t x_smem = smem_u32(xbuf), dist_smem = smem_u32(dist);
  // A step s of a query carries a builder half's err sums of the query if it
  // is that half's last step of it (the halves take every other step).
  auto carries_dist = [&](int s) { return s >= kc - 2; };
  auto slot_bytes = [&](int g) { return kPSlotBytes + (carries_dist(g % kc) ? kPDistBytes : 0); };
  const uint32_t stats_bytes = ranks * 2 * kPEdges * 2 * 4, head_bytes = ranks * 2 * kPEdges * 4;

  if (tid == 0) {
    for (int s = 0; s < kPStages; ++s) mbar_init(bar(kPBarW + s), 1);
    for (int s = 0; s < kPSlots; ++s) {
      mbar_init(bar(kPBarAFull + s), 1);
      mbar_init(bar(kPBarAEmpty + s), ranks);
    }
    for (int w = 0; w < 2; ++w) {
      mbar_init(bar(kPBarStats + w), 1);
      mbar_init(bar(kPBarHead + w), 1);
      mbar_init(bar(kPBarFree + w), 4 * ranks);  // each warp of each CTA's warpgroup
      mbar_init(bar(kPBarGo + w), 1);
    }
    // Arm the first phase of every A slot and exchange in use.
    for (int g = 0; g < kPSlots && g < gsteps; ++g) mbar_expect_tx(bar(kPBarAFull + g), slot_bytes(g));
    for (int w = 0; w < 2 && w < iters; ++w) {
      mbar_expect_tx(bar(kPBarStats + w), stats_bytes);
      mbar_expect_tx(bar(kPBarHead + w), head_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The tile's query-independent terms, once per CTA: c of this CTA's
  // columns (0 past H or M) and nav; the epilogue's per-column weights.
  for (int i = tid; i < kPEdges * 2 * (kSliceN / 4); i += kWgThreads) {
    const int e = i / (2 * kSliceN / 4), dir = (i / (kSliceN / 4)) & 1, cc = 4 * (i % (kSliceN / 4));
    const int m = m0 + e;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < p.M && col0 + cc < H) v = *reinterpret_cast<const float4*>(p.c + (2 * (size_t)m + dir) * H + col0 + cc);
    *reinterpret_cast<float4*>(cbuf + c_index(e, dir, cc)) = v;
  }
  if (tid < 2 * kPEdges) navs[tid] = m0 + tid / 2 < p.M ? p.nav[2 * (size_t)m0 + tid] : 0.f;
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

  const __nv_bfloat16* w_src = p.w1_tiles + (size_t)rank * 3 * kc * (kTileBytes / 2);
  auto issue_tile = [&](int t) {  // W1 tile t of this CTA's sequence into stage t % kPStages
    const int st = t % kPStages;
    mbar_expect_tx(bar(kPBarW + st), kTileBytes);
    bulk_copy(w_base + st * kTileBytes, w_src + (size_t)tile_chunk<kPooled>(t % (2 * kc), kc) * (kTileBytes / 2),
              kTileBytes, bar(kPBarW + st));
  };
  if (tid == 0)
    for (int t = 0; t < kPStages && t < tiles; ++t) issue_tile(t);

  if (warp >= kConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPBuilderRegs) : "memory");
    // ---- A builders: half h of the warpgroup builds the (query, step)
    // pairs g = h, h + 2, ...; in each, this CTA's share of the tile's edges,
    // 8 threads per edge (one 16-byte unit each), 8 edges per round.  The
    // raw units of the half's next step (first round) load while this step
    // waits for its slot and builds.
    const int bt = tid - kConsumers, half = bt >> 6, hb = bt & 63, u = hb & 7;
    const int per = (kPEdges + ranks - 1) / ranks, e0 = rank * per, e1 = min(kPEdges, e0 + per);
    const int rounds = (per + 7) / 8;
    auto edge_of = [&](int rd) { return e0 + rd * 8 + (hb >> 3); };
    float* dh = reinterpret_cast<float*>(smem + kPSmemDacc) + half * 2 * kPEdges;  // [dir][edge]
    if (u == 0)
      for (int rd = 0; rd < rounds; ++rd)
        if (edge_of(rd) < e1) dh[edge_of(rd)] = dh[kPEdges + edge_of(rd)] = 0.f;
    auto fetch = [&](int g, uint4 (&v)[5]) {
      const int e = edge_of(0);
      if (g < gsteps && e < e1 && m0 + e < p.M) load_units<kPooled>(p, m0 + e, g % kc, kc, q0 + g / kc, u, v);
    };
    uint4 cur[5], nxt[5];
    fetch(half, cur);
    for (int g = half; g < gsteps; g += 2) {
      const int s = g % kc, slot = g % kPSlots, q = q0 + g / kc;
      fetch(g + 2, nxt);
      WG_MARK(traced && hb == 0 && g < kTraceSteps, g * 8 + 5);
      mbar_wait(bar(kPBarAEmpty + slot), ((g / kPSlots) & 1) ^ 1);
      WG_MARK(traced && hb == 0 && g < kTraceSteps, g * 8 + 6);
      for (int rd = 0; rd < rounds; ++rd) {
        const int e = edge_of(rd);
        const bool valid = e < e1;
        float df = 0.f, db = 0.f;
        if (valid) {
          uint4 o0 = make_uint4(0u, 0u, 0u, 0u), o1 = o0;
#ifdef WG_NO_BUILD
          if (false) {
#else
          if (m0 + e < p.M) {
#endif
            uint4 v[5];
            if (rd == 0) {
#pragma unroll
              for (int x = 0; x < 5; ++x) v[x] = cur[x];
            } else {
              load_units<kPooled>(p, m0 + e, s, kc, q, u, v);
            }
            build_units<kPooled>(v, s, kc, o0, o1, df, db, 0.f, 0.f);
          }
          const uint32_t off = slot * kPSlotBytes + e * 128 + ((u ^ (e & 7)) << 4);
          for (int rk = 0; rk < ranks; ++rk) {
            const uint32_t fb = mapa(bar(kPBarAFull + slot), rk);
            st_async16(mapa(a_smem + off, rk), o0, fb);
            st_async16(mapa(a_smem + off + kAChunkBytes, rk), o1, fb);
          }
        }
        // err sums: the 8 threads of an edge, then over the half's steps in dh.
        df += __shfl_xor_sync(0xffffffffu, df, 1);
        df += __shfl_xor_sync(0xffffffffu, df, 2);
        df += __shfl_xor_sync(0xffffffffu, df, 4);
        db += __shfl_xor_sync(0xffffffffu, db, 1);
        db += __shfl_xor_sync(0xffffffffu, db, 2);
        db += __shfl_xor_sync(0xffffffffu, db, 4);
        if (valid && u == 0) {
          dh[e] += df;
          dh[kPEdges + e] += db;
        }
      }
#pragma unroll
      for (int x = 0; x < 5; ++x) cur[x] = nxt[x];
      if (carries_dist(s)) {
        // This half's err sums of the query's edges, to every CTA, with this
        // step's slot (one thread per edge: the one that summed them).
        for (int rd = 0; rd < rounds; ++rd) {
          const int e = edge_of(rd);
          if (e < e1 && u == 0) {
            const float dfv = dh[e], dbv = dh[kPEdges + e];
            dh[e] = dh[kPEdges + e] = 0.f;
            const uint32_t off = (slot * 2 * kPEdges + e) * 4;
            for (int rk = 0; rk < ranks; ++rk) {
              const uint32_t fb = mapa(bar(kPBarAFull + slot), rk);
              st_async4(mapa(dist_smem + off, rk), dfv, fb);
              st_async4(mapa(dist_smem + off + kPEdges * 4, rk), dbv, fb);
            }
          }
        }
      }
      WG_MARK(traced && hb == 0 && g < kTraceSteps, g * 8 + 7);
    }
    cluster_sync();  // no CTA leaves while a peer may still push to or arrive on its shared memory
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kPConsumerRegs) : "memory");
    // ---- consumers: warpgroup wg takes queries it = wg, wg + 2, ...
    const int wg = warp >> 2, tw = tid & 127;
    // Rows of the tile this thread holds: e[0] (row lane/4 of the warp's 16) and e[1] = e[0] + 8.
    int ecta[2];
    ecta[0] = (warp & 3) * 16 + (lane >> 2);
    ecta[1] = ecta[0] + 8;
    float* xs = xbuf + wg * (kPXStats + kPXHead);  // [rank][dir][row][mean, M2], then [rank][dir][row]
    const uint32_t xs_smem = x_smem + wg * (kPXStats + kPXHead) * 4, xh_smem = xs_smem + kPXStats * 4;
    float acc0[64], acc1[64];

    for (int it = wg; it < iters; it += 2) {
      const int q = q0 + it;
      // The other warpgroup has passed the waits of query it-1's last step:
      // every W1 tile and A slot this query waits for is one phase ahead at most.
      if (it > 0) mbar_wait(bar(kPBarGo + wg), ((it - 1) >> 1) & 1);
      float dsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // err sums of the rows (dir, row)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
      for (int s = 0; s < kc; ++s) {
        const int g = it * kc + s, slot = g % kPSlots, j = 2 * g;
        const int st0 = j % kPStages, st1 = (j + 1) % kPStages;
        WG_MARK(traced && tw == 0 && g < kTraceSteps, g * 8 + 0);
        mbar_wait(bar(kPBarW + st0), (j / kPStages) & 1);
        mbar_wait(bar(kPBarW + st1), ((j + 1) / kPStages) & 1);
        WG_MARK(traced && tw == 0 && g < kTraceSteps, g * 8 + 1);
        mbar_wait(bar(kPBarAFull + slot), (g / kPSlots) & 1);
        WG_MARK(traced && tw == 0 && g < kTraceSteps, g * 8 + 2);
        if (tw == 0 && g + kPSlots < gsteps) mbar_expect_tx(bar(kPBarAFull + slot), slot_bytes(g + kPSlots));
        // Past the last wait of the query: the other warpgroup may start the next.
        if (tw == 0 && s == kc - 1 && it + 1 < iters) mbar_arrive(bar(kPBarGo + (wg ^ 1)));
        if (carries_dist(s)) {  // a half's err sums, read before the slot is released
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            dsum[0][i] += dist[slot * 2 * kPEdges + ecta[i]];
            dsum[1][i] += dist[slot * 2 * kPEdges + kPEdges + ecta[i]];
          }
        }
        fence_async_smem();
        __syncwarp();  // wgmma is warp-aligned: reconverge after the waits
        const uint32_t a0 = a_smem + slot * kPSlotBytes;
        const uint64_t da0 = sw128_desc(a0), da1 = sw128_desc(a0 + kAChunkBytes);
        const uint64_t db0 = sw128_desc(w_base + st0 * kTileBytes), db1 = sw128_desc(w_base + st1 * kTileBytes);
        wgmma_fence();
        acc_fence(acc0);
        acc_fence(acc1);
#ifndef WG_NO_MMA
#pragma unroll
        for (int kk = 0; kk < kChunkK / 16; ++kk) {  // 32 bytes of k per step: +2 in the descriptor
          wgmma_m64n128k16(acc0, da0 + 2 * kk, db0 + 2 * kk);
          wgmma_m64n128k16(acc1, da1 + 2 * kk, db1 + 2 * kk);
        }
#endif
        wgmma_commit();
        wgmma_wait_all();
        acc_fence(acc0);
        acc_fence(acc1);
        WG_MARK(traced && tw == 0 && g < kTraceSteps, g * 8 + 3);
        __syncwarp();
        // The A slot to every CTA (warp 0, one lane per CTA); the two W1 stages,
        // whose only reader this warpgroup was, refilled at once (warp 1).
        if (tw < ranks) mbar_arrive_cluster(mapa(bar(kPBarAEmpty + slot), tw));
        if (tw == 32)
          for (int t = j; t < j + 2; ++t)
            if (t + kPStages < tiles) issue_tile(t + kPStages);
        WG_MARK(traced && tw == 0 && g < kTraceSteps, g * 8 + 4);
      }
#ifdef WG_NO_EPI
      if (tw < 2 && rank == 0 && m0 + tw < p.M) p.scores[(long long)q * p.ld_scores + m0 + tw] = acc0[0] + acc1[5];
      continue;
#endif

      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8);
      float nv[2][2], dv[2][2];
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          nv[dir][i] = navs[2 * ecta[i] + dir];
          dv[dir][i] = -sqrtf(dsum[dir][i] + 1e-12f);
        }
      // z into acc0 (fwd) and acc1 (bwd); columns past H are zero.
      float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int jn = 0; jn < kSliceN / 8; ++jn) {
        const int cc = 8 * jn + 2 * (lane & 3);
        const bool ok = col0 + cc < H;
        const float2 wd = *reinterpret_cast<const float2*>(wts + cc);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 cf = *reinterpret_cast<const float2*>(cbuf + c_index(ecta[i], 0, cc));
          const float2 cb = *reinterpret_cast<const float2*>(cbuf + c_index(ecta[i], 1, cc));
#pragma unroll
          for (int c = 2 * i; c < 2 * i + 2; ++c) {
            const bool odd = c & 1;
            const float w = odd ? wd.y : wd.x;
            const float zi = acc0[4 * jn + c], zr = acc1[4 * jn + c];
            float zf = nv[0][i] * zi + zr + (odd ? cf.y : cf.x) + dv[0][i] * w;
            float zb = nv[1][i] * zi + zr + (odd ? cb.y : cb.x) + dv[1][i] * w;
            if (!ok) zf = zb = 0.f;
            acc0[4 * jn + c] = zf;
            acc1[4 * jn + c] = zb;
            part[0][i] += zf;
            part[1][i] += zb;
          }
        }
      }
      // This CTA's columns: their sum (quad), mean, and squared deviations about it.
      const float n_loc = static_cast<float>(min(kSliceN, H - col0));
      float m2[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, mloc[2][2];
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          part[dir][i] += __shfl_xor_sync(0xffffffffu, part[dir][i], 1);
          part[dir][i] += __shfl_xor_sync(0xffffffffu, part[dir][i], 2);
          mloc[dir][i] = part[dir][i] / n_loc;
        }
#pragma unroll
      for (int jn = 0; jn < kSliceN / 8; ++jn) {
        if (col0 + 8 * jn < H) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float a = acc0[4 * jn + c] - mloc[0][c >> 1], b = acc1[4 * jn + c] - mloc[1][c >> 1];
            m2[0][c >> 1] += a * a;
            m2[1][c >> 1] += b * b;
          }
        }
      }
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          m2[dir][i] += __shfl_xor_sync(0xffffffffu, m2[dir][i], 1);
          m2[dir][i] += __shfl_xor_sync(0xffffffffu, m2[dir][i], 2);
        }
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 1);
      // One exchange: (mean, M2) of each (dir, row) to every CTA, once every
      // CTA has read the previous query's (this warpgroup's buffer is single).
      // Lane q4 of a quad carries (dir, row) = (q4 / 2, e[q4 % 2]).
      const int q4 = lane & 3, qe = ecta[0] + 8 * (q4 & 1), qx = (q4 >> 1) * kPEdges + qe;
      const float qmean = q4 == 0 ? mloc[0][0] : q4 == 1 ? mloc[0][1] : q4 == 2 ? mloc[1][0] : mloc[1][1];
      const float qm2 = q4 == 0 ? m2[0][0] : q4 == 1 ? m2[0][1] : q4 == 2 ? m2[1][0] : m2[1][1];
      if (it >= 2) mbar_wait(bar(kPBarFree + wg), ((it >> 1) - 1) & 1);
      for (int rk = 0; rk < ranks; ++rk) {
        const uint32_t a = mapa(xs_smem + 8 * (rank * 2 * kPEdges + qx), rk), fb = mapa(bar(kPBarStats + wg), rk);
        st_async4(a, qmean, fb);
        st_async4(a + 4, qm2, fb);
      }
      mbar_wait(bar(kPBarStats + wg), (it >> 1) & 1);
      if (tw == 0 && it + 2 < iters) mbar_expect_tx(bar(kPBarStats + wg), stats_bytes);
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 2);
      // Chan's merge, in rank order, of the ranks' (n_r, mean_r, M2_r):
      // mean = sum_r n_r mean_r / H, M2 = sum_r M2_r + n_r (mean_r - mean)^2;
      // each lane its (dir, row), then shared across the quad.
      float qmu, qrs;
      {
        float sum = 0.f;
        for (int rk = 0; rk < ranks; ++rk) sum += min(kSliceN, H - rk * kSliceN) * xs[2 * (rk * 2 * kPEdges + qx)];
        qmu = sum / H;
        float ss = 0.f;
        for (int rk = 0; rk < ranks; ++rk) {
          const float2 x = *reinterpret_cast<const float2*>(xs + 2 * (rk * 2 * kPEdges + qx));
          const float d = x.x - qmu;
          ss += x.y + min(kSliceN, H - rk * kSliceN) * d * d;
        }
        qrs = rsqrtf(ss / H + 1e-5f);
      }
      // This warp is done with the stats buffer: every CTA may overwrite it.
      __syncwarp();
      if (lane < ranks && it + 2 < iters) mbar_arrive_cluster(mapa(bar(kPBarFree + wg), lane));
      float mean[2][2], rstd[2][2];
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mean[dir][i] = __shfl_sync(0xffffffffu, qmu, (lane & ~3) | (dir * 2 + i));
          rstd[dir][i] = __shfl_sync(0xffffffffu, qrs, (lane & ~3) | (dir * 2 + i));
          part[dir][i] = 0.f;
        }
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 3);
      // GELU and the folded head of column block jn (acc*[base .. base + 4)).
      auto gelu_head = [&](int jn, int base) {
        const int cc = 8 * jn + 2 * (lane & 3);
        if (col0 + cc < H) {
          const float2 ls = *reinterpret_cast<const float2*>(wts + 2 * kSliceN + cc);
          const float2 lb = *reinterpret_cast<const float2*>(wts + 3 * kSliceN + cc);
          const float2 w2 = *reinterpret_cast<const float2*>(wts + 4 * kSliceN + cc);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int i = c >> 1;
            const bool odd = c & 1;
            const float sl = odd ? ls.y : ls.x, o = odd ? lb.y : lb.x, w = odd ? w2.y : w2.x;
            part[0][i] += epi_gelu((acc0[base + c] - mean[0][i]) * rstd[0][i] * sl + o) * w;
            part[1][i] += epi_gelu((acc1[base + c] - mean[1][i]) * rstd[1][i] * sl + o) * w;
          }
        }
      };
#pragma unroll
      for (int jn = 0; jn < kSliceN / 8; ++jn) gelu_head(jn, 4 * jn);
#pragma unroll
      for (int dir = 0; dir < 2; ++dir)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          part[dir][i] += __shfl_xor_sync(0xffffffffu, part[dir][i], 1);
          part[dir][i] += __shfl_xor_sync(0xffffffffu, part[dir][i], 2);
        }
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 4);
      // The head partials to every CTA (lane q4 its (dir, row)); each sums
      // them in rank order and writes the scores of its share of the rows.
      {
        const float qh = q4 == 0 ? part[0][0] : q4 == 1 ? part[0][1] : q4 == 2 ? part[1][0] : part[1][1];
        for (int rk = 0; rk < ranks; ++rk)
          st_async4(mapa(xh_smem + 4 * (rank * 2 * kPEdges + qx), rk), qh, mapa(bar(kPBarHead + wg), rk));
      }
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 5);
      mbar_wait(bar(kPBarHead + wg), (it >> 1) & 1);
      if (tw == 0 && it + 2 < iters) mbar_expect_tx(bar(kPBarHead + wg), head_bytes);
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 6);
      if (q4 < 2 && qe % ranks == rank && m0 + qe < p.M) {
        const float* xh = xs + kPXStats;
        float sf = 0.f, sb = 0.f;
        for (int rk = 0; rk < ranks; ++rk) {
          sf += xh[rk * 2 * kPEdges + qe];
          sb += xh[(rk * 2 + 1) * kPEdges + qe];
        }
        const float b2 = p.w.b2s[0];
        p.scores[(long long)q * p.ld_scores + m0 + qe] = combine(sf + b2, sb + b2);
      }
      WG_MARK(traced && tw == 0 && it < kTraceItems, kTraceEpi + it * 8 + 7);
    }
    cluster_sync();
  }
}

// Launches wg_kernel_pooled: a cluster of ceil(H / 128) CTAs per tile of 64
// of the M edges and group of kQueriesPerCta of the B queries; returns the
// CUDA error (a cluster that cannot be scheduled is refused).
cudaError_t launch_pooled(const WgArgs& a, cudaStream_t stream) {
  const int ranks = (a.w.H + kSliceN - 1) / kSliceN;
  const int qgroups = (a.B + kPQueries - 1) / kPQueries;
  const int tiles = (a.M + kPEdges - 1) / kPEdges;
  if (tiles > 65535 || qgroups > 65535) return cudaErrorInvalidValue;
  void (*fn)(WgArgs) = wg_kernel_pooled;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kPSmemBytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, qgroups, tiles);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = kPSmemBytes;
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
  return cudaLaunchKernelEx(&cfg, fn, a);
}

}  // namespace

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
  return static_cast<int>(launch_pooled(a, s));
}

// Shared memory of wg_kernel_pooled, for the ptxas report.
extern "C" int pq_smem_bytes() { return static_cast<int>(kPSmemBytes); }

#ifdef WG_TRACE
// The clock64 marks of the last traced launch (twin_wgmma.cuh), into host memory `out`.
extern "C" int wg_trace_read(long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_wg_trace, sizeof(g_wg_trace)));
}
#endif
