// The attention half of a Swin block on windowed rows:
//
//     y[w] = attention(x[w] Wqkv^T + bqkv) Wproj^T + bproj      x, y: [B*nW, 49, C]
//
// where attention is, per head h of width 32,
// softmax(q k^T * 32^-0.5 + bias[h] + (-100 where region ids differ)) v.
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/window_attention.py::
// window_attention_block_fused (_block_kernel). The [49, 3C] qkv never reaches
// device memory. Region ids are the [nW, 49] int32 map of the shifted
// partition (null for an unshifted block); window w uses row w % nW and the
// kernel compares ids itself.
//
// Rounding places (T is float or bf16), as in the JAX kernel: qkv accumulates
// in float32, + bqkv in float32, rounded to T; q * scale rounded to T (the
// scale rounded first); scores, bias and the additive -100 add in float32;
// the softmax output is rounded to T; p v accumulates in float32 and is
// rounded to T once; proj accumulates in float32, + bproj in float32, rounded
// once. Wqkv [3C, C] and Wproj [C, C] are in T, laid out as nn.Linear keeps
// them; both biases are float32; the relative-position bias [heads, 49, 49]
// is in T.
//
// What bounds it on an H100: 8 C^2 + 4 * 49 C operations a row against 4 C
// bytes in bf16, so bytes at C = 96 and operations from C = 192 on
// (0.036 / 0.026 / 0.025 / 0.035 ms at the four stages of swin_tiny at 544,
// batch 16). What sets the pace here is the attention, latency-bound on
// mma.sync and the softmax (four warps a (window, head)), and the weights
// and x rows that every product has to fetch. Two bf16 forms for the H100
// (sm_90a), chosen at compile time by width (attn_block()):
//
// Tiled, C = 96, one launch, from swin_block.cu's tiled body (the pieces of
// swin_tiled.cuh):
// - A persistent block (one a multiprocessor) walks tiles of G = 3
//   consecutive windows in a fixed order (no atomics: the same bits every
//   run), one warpgroup a window. Both weight matrices stay in shared memory,
//   loaded once a block by TMA (96 KB with the k-tail padded to 64), so the
//   windows never wait on each other.
// - A window's x rows arrive by TMA (a box of 56 rows x 64 columns a
//   k-block, 128-byte swizzled); the next tile's rows are loaded as soon as
//   the last qkv product is done with them. The windows of a tile lie 56 rows
//   apart in the x and attention-output tiles, so a window's 64-row product
//   tile overlaps the next window's first 8 rows: those rows feed only
//   output rows 56-63, which are never stored (rows 49-63 of q, k and v are
//   written as zeros). That is what makes room for G = 3.
// - Per head, a [64, 96] x [96, 96] product on wgmma gives q | k | v; it is
//   issued before the previous head's attention and waited for after it, so
//   the tensor cores work under the attention. Attention on mma.sync with p
//   in registers (attend_rows; the region mask bits once a tile). proj on
//   wgmma from the swizzled attention-output tile; + bproj, rounded, back
//   into that tile and out by TMA. Each accumulator zeroed just before its
//   product (left undefined, ptxas serialises every wgmma); bqkv and bproj
//   in shared memory. 384 threads, 227872 B of shared memory.
//
// Two phases, C = 192, 384 and 768, two launches (a window's own weights
// traffic, 4 C^2 bf16 a window, is what a window-at-a-time form cannot
// share at these widths):
// - Phase 1 (swin_tiled.cuh::attend_heads, which swin_block.cu runs at C =
//   768 too), a block per (head, chunk of windows): the head's 96 q | k | v
//   rows of wqkv stay in shared memory; each warpgroup walks its own windows,
//   their x rows streamed a 64-wide k-block at a time by TMA through a ring
//   of its own ([64, C] x [C, 96] on wgmma); q stays in registers as the A
//   fragments of q k^T, k and v go through their tiles, attention on
//   mma.sync (attend_q), and the head's 32 columns of the attention output,
//   rounded once, go to out. A block reads its head's weights once and the x
//   rows of its windows once a head.
// - Phase 2, persistent blocks over groups of 64-row tiles of out (rows of
//   consecutive windows, no padding rows): the tiles by TMA into shared
//   memory, the next group landing under this one's products where two fit;
//   proj on wgmma in pieces of 96 columns, a warpgroup a tile and column
//   group, wproj slices by TMA through a ring whose every use serves all the
//   group's tiles; + bproj, rounded once, back into the same rows of out. A
//   block reads its tiles whole before it writes any of them, and no other
//   block touches those rows.
//          phase 1                         phase 2
//     C    warpgroups x slots smem         tiles x column groups ring tile groups smem
//     192  3          5       185592 B     1 x 2                 4    2           149328 B
//     384  3          5       222456 B     3 x 1                 6    1           223848 B
//     768  2          4       230536 B     1 x 2                 4    1           200776 B
//
// float32: one block of 256 threads a window, dot products on the CUDA cores
// in index order, no TF32; the attention output passes through `out` as
// scratch (see swin_common.cuh).
#include "sm90.cuh"
#include "swin_common.cuh"
#include "swin_tiled.cuh"

namespace {

using namespace swin;

// ---------------------------------------------------- bf16, tiled (C = 96) -----

template <int C> struct AttnPlan {
  static_assert(C == 96, "the tiled form keeps both weight matrices in shared memory");
  static constexpr int G = 3;                        // windows a tile, one warpgroup each
  static constexpr int THREADS = G * 128;
  static constexpr int HEADS = C / HD;
  static constexpr int KB = (C + 63) / 64;           // 64-wide k-blocks over C
  // x and attention-output tiles: per k-block G windows 56 rows apart and 8
  // rows for the last window's 64-row product tile (a multiple of 1024 bytes)
  static constexpr int WROW = 56;
  static constexpr int TB = (G * WROW + 8) * 128;
  static constexpr int QT = 64 * 64;                 // one of the q, k, v tiles
  static constexpr int X = 0;
  static constexpr int AO = X + KB * TB;             // also the output tile on its way out
  static constexpr int QKV = AO + KB * TB;           // per window q, k, v
  static constexpr int W = QKV + G * 3 * QT;
  // per head and k-block the head's 96 q | k | v rows of wqkv, then per
  // k-block the C rows of wproj
  static constexpr int WQKV_BYTES = HEADS * KB * 96 * 128, WPROJ_BYTES = KB * C * 128;
  static constexpr int BIAS = W + WQKV_BYTES + WPROJ_BYTES;   // bqkv [3C], bproj [C], float32
  static constexpr int BAR = BIAS + 4 * C * 4;       // the x tiles' [G], the weights'
  static constexpr int SMEM = BAR + (G + 1) * 8 + 1024;       // + aligning the base
  static_assert(TB % 1024 == 0 && W % 1024 == 0, "swizzle atoms");
  static_assert(SMEM <= 232448, "shared memory");
};

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of G windows;
// warpgroup g takes window g of a tile and never waits on another window's
// warpgroup; a warpgroup whose window is missing (the last tile) stops.
template <int C>
__global__ void __launch_bounds__(AttnPlan<C>::THREADS, 1)
attn_block_bf16_tiled_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_qkv,
                             const __grid_constant__ CUtensorMap tm_proj,
                             const __grid_constant__ CUtensorMap tm_out,
                             const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                             const int* __restrict__ region, const float* __restrict__ bproj,
                             int bnw, int nw) {
  using P = AttnPlan<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  uint64_t* xbar = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* wbar = xbar + P::G;
  float* sbq = reinterpret_cast<float*>(smem + P::BIAS);
  float* sbp = sbq + 3 * C;
  const int tiles = (bnw + P::G - 1) / P::G;
  const int g = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::G; ++i) sm90::mbar_init(xbar + i, 1);
    sm90::mbar_init(wbar, 1);
    sm90::fence_mbar_init();
  }
  for (int i = threadIdx.x; i < 3 * C; i += P::THREADS) sbq[i] = bqkv[i];
  for (int i = threadIdx.x; i < C; i += P::THREADS) sbp[i] = bproj[i];
  __syncthreads();

  // The first thread of window g's warpgroup moves the window's rows: x of
  // tile t in (56 rows a k-block: the next window's first 7, or zeros past
  // the last window) where the window exists, and its output rows out.
  const bool loader = threadIdx.x % 128 == 0;
  const int wrow = g * P::WROW * 128;                        // this window in the x / AO tiles
  auto load_x = [&](int t) {
    const int w = t * P::G + g;
    if (!loader || t >= tiles || w >= bnw) return;
    sm90::mbar_expect_tx(xbar + g, P::KB * P::WROW * 128);
    for (int kb = 0; kb < P::KB; ++kb)
      sm90::tma_load_2d(base + P::X + kb * P::TB + wrow, &tm_x, kb * 64, w * N, xbar + g);
  };

  const int warp = threadIdx.x / 32, wq = warp % 4;
  const int lane = threadIdx.x % 32;
  const int er = 16 * wq + lane / 4, ec = 2 * (lane % 4);    // accumulator row and column
  unsigned char* ao = smem + P::AO + wrow;
  unsigned char* qkv = smem + P::QKV + g * 3 * P::QT;
  const uint64_t da_x = sm90::sw128_desc(base + P::X + wrow);
  const uint64_t da_ao = sm90::sw128_desc(base + P::AO + wrow);
  const float scale = round_to<bf16>(QK_SCALE);
  auto sync_wg = [g] { sm90::named_barrier(1 + g, 128); };   // the window's warpgroup

  // q | k | v of head h, [64, C] x [C, 96], issued; qkv_wait waits for it
  auto qkv_issue = [&](int h, float (&acc)[48]) {
#pragma unroll
    for (int z = 0; z < 48; ++z) acc[z] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < P::KB; ++kb) {
      const uint64_t db = sm90::sw128_desc(base + P::W + (h * P::KB + kb) * 96 * 128);
#pragma unroll
      for (int k = 0; k < 64; k += 16)
        if (kb * 64 + k < C)
          sm90::wgmma_ss(acc, sm90::desc_add(da_x, kb * P::TB + k * 2),
                         sm90::desc_add(db, k * 2), kb > 0 || k > 0);
    }
    sm90::wgmma_commit();
  };
  auto qkv_wait = [&](float (&acc)[48]) {
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
  };

  if (threadIdx.x == 0) {               // both weight matrices, once
    sm90::mbar_expect_tx(wbar, P::WQKV_BYTES + P::WPROJ_BYTES);
    for (int h = 0; h < P::HEADS; ++h)
      for (int kb = 0; kb < P::KB; ++kb)
        for (int j = 0; j < 3; ++j)
          sm90::tma_load_2d(base + P::W + ((h * P::KB + kb) * 3 + j) * HD * 128, &tm_qkv,
                            kb * 64, j * C + h * HD, wbar);
    for (int kb = 0; kb < P::KB; ++kb)
      sm90::tma_load_2d(base + P::W + P::WQKV_BYTES + kb * C * 128, &tm_proj, kb * 64, 0, wbar);
  }
  load_x(blockIdx.x);
  sm90::mbar_wait(wbar, 0);
  uint32_t xphase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int w = t * P::G + g;
    if (w >= bnw) break;
    // which of this thread's scores take the region fill: the same each head
    uint32_t differ = 0;
    if (region != nullptr) {
      const int* rr = region + static_cast<size_t>(w % nw) * N;
      differ = region_differ(wq, rr[lane], lane < N - 32 ? rr[32 + lane] : 0);
    }
    sm90::mbar_wait(xbar + g, xphase);
    xphase ^= 1;

    // head h + 1's product runs under head h's attention
    float acc[48];
    uint32_t bz[7][2];                  // the head's bias
    head_bias(bias, wq, bz);
    qkv_issue(0, acc);
    qkv_wait(acc);
    if (loader) sm90::bulk_wait_read<0>();       // the last tile's output has left its tile
    sync_wg();                          // and the last tile's attention is done with q, k, v
    store_qkv<C, 96>(acc, sbq, 0, 0, scale, qkv, er, ec);
    sync_wg();
    for (int h = 0; h + 1 < P::HEADS; ++h) {
      qkv_issue(h + 1, acc);
      attend_rows(qkv, P::QT, 0, wq, bz, differ, ao, P::TB, h * HD);
      head_bias(bias + static_cast<size_t>(h + 1) * N * N, wq, bz);
      qkv_wait(acc);
      sync_wg();                        // every warp is done with head h's q, k, v
      store_qkv<C, 96>(acc, sbq, h + 1, 0, scale, qkv, er, ec);
      sync_wg();
    }
    load_x(t + gridDim.x);              // every product is done with the x tile
    attend_rows(qkv, P::QT, 0, wq, bz, differ, ao, P::TB, (P::HEADS - 1) * HD);
    sm90::fence_proxy_async();
    sync_wg();                          // the attention-output tile is whole

    // proj: [64, C] x [C, C]
    float pacc[48];
#pragma unroll
    for (int z = 0; z < 48; ++z) pacc[z] = 0.0f;
    sm90::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < P::KB; ++kb) {
      const uint64_t db = sm90::sw128_desc(base + P::W + P::WQKV_BYTES + kb * C * 128);
#pragma unroll
      for (int k = 0; k < 64; k += 16)
        if (kb * 64 + k < C)
          sm90::wgmma_ss(pacc, sm90::desc_add(da_ao, kb * P::TB + k * 2),
                         sm90::desc_add(db, k * 2), kb > 0 || k > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(pacc);
    sync_wg();                          // every product is done with the attention output

    // y = proj + bproj, rounded once, into the attention-output tile's rows
    // 0-48, then out by TMA (the window's 49 rows, k-block by k-block)
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = 8 * j + ec;
      const float2 b = *reinterpret_cast<const float2*>(sbp + col);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = er + 8 * hi;
        if (row < N)
          *reinterpret_cast<uint32_t*>(ao + (col / 64) * P::TB + sm90::sw128_offset(row, col % 64)) =
              pack_bf16(pacc[4 * j + 2 * hi] + b.x, pacc[4 * j + 2 * hi + 1] + b.y);
      }
    }
    sm90::fence_proxy_async();
    sync_wg();
    if (loader) {
      for (int kb = 0; kb < P::KB; ++kb)
        sm90::tma_store_2d(&tm_out, kb * 64, w * N, base + P::AO + kb * P::TB + wrow);
      sm90::bulk_commit();
    }
  }
  if (loader) sm90::bulk_wait<0>();
}

template <int C>
int launch_bf16_tiled(const void* x, const void* wqkv, const float* bqkv, const void* bias,
                      const int* region, const void* wproj, const float* bproj, void* out,
                      int bnw, int nw, cudaStream_t stream) {
  using P = AttnPlan<C>;
  CUtensorMap tx, tq, tp, to;
  if (!sm90::map_sw128(&tx, x, C, bnw * N, P::WROW) || !sm90::map_sw128(&tq, wqkv, C, 3 * C, HD) ||
      !sm90::map_sw128(&tp, wproj, C, C, C) || !sm90::map_sw128(&to, out, C, bnw * N, N))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (bnw + P::G - 1) / P::G;
  const int blocks = tiles < sms ? tiles : sms;     // ops/attn_block.py::kernel_geometry
  auto kernel = attn_block_bf16_tiled_kernel<C>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, P::THREADS, P::SMEM, stream>>>(tx, tq, tp, to, bqkv,
                                                  static_cast<const bf16*>(bias), region, bproj,
                                                  bnw, nw);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------ bf16, two phases (C = 192-768) -----

template <int C>
__global__ void __launch_bounds__(HeadPlan<C>::THREADS, 1)
attn_heads_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_qkv,
                       const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                       const int* __restrict__ region, bf16* __restrict__ ao, int bnw, int nw) {
  attend_heads<C>(tm_x, tm_qkv, bqkv, bias, region, ao, bnw, nw);
}

// Phase 2 per width: RW warpgroups take RW consecutive 64-row tiles at once,
// one each, and CS warpgroups split a tile's columns (NP pieces of 96 each,
// one at a time); wproj comes through a ring whose every use (one k-block of
// each column group's piece) serves all RW tiles; ABUF groups of tiles in
// shared memory, the next group landing under this one's products where two
// fit.
template <int RW_, int CS_, int STAGES_, int ABUF_> struct ProjShapeOf {
  static constexpr int RW = RW_, CS = CS_, STAGES = STAGES_, ABUF = ABUF_;
};
template <int C> struct ProjShape;
template <> struct ProjShape<192> : ProjShapeOf<1, 2, 4, 2> {};
template <> struct ProjShape<384> : ProjShapeOf<3, 1, 6, 1> {};
template <> struct ProjShape<768> : ProjShapeOf<1, 2, 4, 1> {};

template <int C> struct ProjPlan {
  static constexpr int RW = ProjShape<C>::RW, CS = ProjShape<C>::CS;
  static constexpr int STAGES = ProjShape<C>::STAGES, ABUF = ProjShape<C>::ABUF;
  static constexpr int THREADS = RW * CS * 128;
  static constexpr int KB = C / 64, NP = C / 96 / CS;
  static constexpr int AT = 64 * 128;                // one k-block of a tile
  static constexpr int A = 0;                        // per buffer, tile and k-block
  static constexpr int RING = A + ABUF * RW * KB * AT;
  static constexpr int SLOT = CS * 96 * 128, USES = NP * KB;
  static constexpr int BIAS = RING + STAGES * SLOT;  // bproj [C], float32
  // barriers: full[STAGES], empty[STAGES], the tile groups' [ABUF]
  static constexpr int BAR = BIAS + C * 4;
  static constexpr int SMEM = BAR + (2 * STAGES + ABUF) * 8 + 1024;
  static_assert(C % 64 == 0 && C % (96 * CS) == 0 && STAGES >= 3, "k-blocks, pieces, ring");
  static_assert(SMEM <= 232448, "shared memory");
};

template <int C>
__global__ void __launch_bounds__(ProjPlan<C>::THREADS, 1)
proj_rows_bf16_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_proj,
                      const float* __restrict__ bproj, bf16* out, int rows) {
  using P = ProjPlan<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::STAGES;
  uint64_t* abar = empty + P::STAGES;
  float* sbp = reinterpret_cast<float*>(smem + P::BIAS);
  const int tiles = (rows + 63) / 64, groups = (tiles + P::RW - 1) / P::RW;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, P::THREADS / 32);
    }
    for (int b = 0; b < P::ABUF; ++b) sm90::mbar_init(abar + b, 1);
    sm90::fence_mbar_init();
  }
  for (int i = threadIdx.x; i < C; i += P::THREADS) sbp[i] = bproj[i];
  __syncthreads();

  // Thread 0: start the copies of every use before `upto`; use v: piece
  // (v % USES) / KB of each column group, k-block v % KB.
  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto; ++issued) {
      if (blockIdx.x + (issued / P::USES) * gridDim.x >= groups) return;
      const int s = issued % P::STAGES, e = issued % P::USES;
      sm90::mbar_wait(empty + s, ((issued / P::STAGES) & 1) ^ 1);
      sm90::mbar_expect_tx(full + s, P::SLOT);
      for (int c = 0; c < P::CS; ++c)
        sm90::tma_load_2d(base + P::RING + s * P::SLOT + c * 96 * 128, &tm_proj, (e % P::KB) * 64,
                          (c * P::NP + e / P::KB) * 96, full + s);
    }
  };
  // Thread 0: the rows of the block's i-th group of tiles, all k-blocks, into
  // buffer i % ABUF.
  auto load_group = [&](int i) {
    const int t0 = (blockIdx.x + i * gridDim.x) * P::RW;
    if (t0 >= tiles) return;
    const int n = tiles - t0 < P::RW ? tiles - t0 : P::RW;
    uint64_t* bar = abar + i % P::ABUF;
    sm90::mbar_expect_tx(bar, n * P::KB * P::AT);
    for (int r = 0; r < n; ++r)
      for (int kb = 0; kb < P::KB; ++kb)
        sm90::tma_load_2d(base + P::A + (((i % P::ABUF) * P::RW + r) * P::KB + kb) * P::AT,
                          &tm_a, kb * 64, (t0 + r) * 64, bar);
  };
  const int wg = threadIdx.x / 128, rw = wg / P::CS, cs = wg % P::CS;
  const int warp = threadIdx.x / 32, wq = warp % 4;
  const int lane = threadIdx.x % 32;
  const int er = 16 * wq + lane / 4, ec = 2 * (lane % 4);
  RingReader<P::STAGES, P::SLOT> ring{full, empty, base + P::RING};
  if (threadIdx.x == 0) {
    issue_upto(P::STAGES - 1);
    for (int i = 0; i < P::ABUF; ++i) load_group(i);
  }
  for (int i = 0, gr = blockIdx.x; gr < groups; ++i, gr += gridDim.x) {
    sm90::mbar_wait(abar + i % P::ABUF, (i / P::ABUF) & 1);
    const int t = gr * P::RW + rw;      // this warpgroup's tile (past the last: nothing stored)
    const uint64_t da = sm90::sw128_desc(base + P::A + ((i % P::ABUF) * P::RW + rw) * P::KB * P::AT);
#pragma unroll 1
    for (int p = 0; p < P::NP; ++p) {
      float acc[48];
#pragma unroll
      for (int z = 0; z < 48; ++z) acc[z] = 0.0f;
#pragma unroll 1
      for (int kb = 0; kb < P::KB; ++kb) {
        const uint64_t db = sm90::sw128_desc(ring.acquire(issue_upto) + cs * 96 * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 64; k += 16)
          sm90::wgmma_ss(acc, sm90::desc_add(da, kb * P::AT + k * 2), sm90::desc_add(db, k * 2),
                         kb > 0 || k > 0);
        ring.retire();
      }
      ring.drain();
      sm90::fence_regs(acc);
      // y = proj + bproj, rounded once, into the same rows
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int col = (cs * P::NP + p) * 96 + 8 * j + ec;
        const float2 b = *reinterpret_cast<const float2*>(sbp + col);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = t * 64 + er + 8 * hi;
          if (row < rows)
            *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(row) * C + col) =
                pack_bf16(acc[4 * j + 2 * hi] + b.x, acc[4 * j + 2 * hi + 1] + b.y);
        }
      }
    }
    __syncthreads();                    // every warp is done with the group's buffer
    if (threadIdx.x == 0) load_group(i + P::ABUF);
  }
}

template <int C>
int launch_bf16_two_phase(const void* x, const void* wqkv, const float* bqkv, const void* bias,
                          const int* region, const void* wproj, const float* bproj, void* out,
                          int bnw, int nw, cudaStream_t stream) {
  using P1 = HeadPlan<C>;
  using P2 = ProjPlan<C>;
  const int rows = bnw * N;
  CUtensorMap tx, tq, ta, tp;
  if (!sm90::map_sw128(&tx, x, C, rows, 64) || !sm90::map_sw128(&tq, wqkv, C, 3 * C, HD) ||
      !sm90::map_sw128(&ta, out, C, rows, 64) || !sm90::map_sw128(&tp, wproj, C, C, 96))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // ops/attn_block.py::kernel_geometry
  const int chunks = sms / P1::HEADS > 1 ? sms / P1::HEADS : 1;
  const int groups = ((rows + 63) / 64 + P2::RW - 1) / P2::RW;
  const int blocks2 = groups < sms ? groups : sms;
  auto k1 = attn_heads_bf16_kernel<C>;
  auto k2 = proj_rows_bf16_kernel<C>;
  err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize, P1::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(k2, cudaFuncAttributeMaxDynamicSharedMemorySize, P2::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1<<<P1::HEADS * chunks, P1::THREADS, P1::SMEM, stream>>>(
      tx, tq, bqkv, static_cast<const bf16*>(bias), region, static_cast<bf16*>(out), bnw, nw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  k2<<<blocks2, P2::THREADS, P2::SMEM, stream>>>(ta, tp, bproj, static_cast<bf16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32 -----

template <int C>
__global__ void __launch_bounds__(THREADS)
attn_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ wqkv,
                      const float* __restrict__ bqkv, const float* __restrict__ bias,
                      const int* __restrict__ region, const float* __restrict__ wproj,
                      const float* __restrict__ bproj, float* out, int nw) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sx = smem + WindowSmemF32<C>::SX;
  const int w = blockIdx.x;
  float* y = out + static_cast<size_t>(w) * N * C;
  const float* xw = x + static_cast<size_t>(w) * N * C;

  for (int e = threadIdx.x; e < N * C; e += THREADS) sx[e] = xw[e];
  window_heads_f32<C>(smem, wqkv, bqkv, bias, region, w, nw, y);
  for (int e = threadIdx.x; e < N * C; e += THREADS) sx[e] = y[e];
  __syncthreads();
  window_linear_f32<C>(sx, wproj,
                       [&](int r, int n, float acc) { y[r * C + n] = acc + bproj[n]; });
}

template <int C>
int launch_f32(const void* x, const void* wqkv, const float* bqkv, const void* bias,
               const int* region, const void* wproj, const float* bproj, void* out, int bnw,
               int nw, cudaStream_t stream) {
  const int smem = WindowSmemF32<C>::END * sizeof(float);
  auto kernel = attn_block_f32_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bnw, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(wqkv), bqkv,
      static_cast<const float*>(bias), region, static_cast<const float*>(wproj), bproj,
      static_cast<float*>(out), nw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [bnw, 49, c]; wqkv [3c, c]; bqkv [3c]; bias [c / 32, 49, 49]; region
// [nw, 49] int32 or null; wproj [c, c]; bproj [c]. x, wqkv, bias, wproj and
// out are bf16 when is_bf16 is nonzero, else float32; bqkv and bproj are
// float32. bf16 at c = 96 runs the tiled kernel, one block a multiprocessor
// of the current device at most; at c = 192, 384 and 768 the two phases
// (ops/attn_block.py::kernel_geometry). c is 96, 192, 384 or 768; any other
// width, or bf16 x, out or weights not 16-byte aligned, return
// cudaErrorInvalidValue.
extern "C" int attn_block(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                          const void* region, const void* wproj, const void* bproj, void* out,
                          int bnw, int c, int nw, int is_bf16, void* stream) {
  if (bnw <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* reg = static_cast<const int*>(region);
  const float* bq = static_cast<const float*>(bqkv);
  const float* bp = static_cast<const float*>(bproj);
#define ATTN_BLOCK(C, BF16)                                                              \
  case C:                                                                                \
    return is_bf16 ? BF16<C>(x, wqkv, bq, bias, reg, wproj, bp, out, bnw, nw, s)         \
                   : launch_f32<C>(x, wqkv, bq, bias, reg, wproj, bp, out, bnw, nw, s);
  switch (c) {
    ATTN_BLOCK(96, launch_bf16_tiled)
    ATTN_BLOCK(192, launch_bf16_two_phase)
    ATTN_BLOCK(384, launch_bf16_two_phase)
    ATTN_BLOCK(768, launch_bf16_two_phase)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ATTN_BLOCK
}

// The compiled shape of the bf16 kernel `which` runs at width c into
// g[0..4): threads a block, dynamic shared memory bytes a block, registers
// and local (spill) bytes a thread. which 0: the tiled kernel (c = 96) or
// phase 1 (c = 192, 384, 768); which 1: phase 2.
extern "C" int attn_block_attributes(int c, int which, int* g) {
  cudaFuncAttributes attr;
  int threads = 0, smem = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define ATTN_ATTRS(C)                                                                     \
  case C:                                                                                 \
    if (which == 0) {                                                                     \
      threads = HeadPlan<C>::THREADS, smem = HeadPlan<C>::SMEM;                           \
      err = cudaFuncGetAttributes(&attr, attn_heads_bf16_kernel<C>);                      \
    } else if (which == 1) {                                                              \
      threads = ProjPlan<C>::THREADS, smem = ProjPlan<C>::SMEM;                           \
      err = cudaFuncGetAttributes(&attr, proj_rows_bf16_kernel<C>);                       \
    }                                                                                     \
    break;
  switch (c) {
    case 96:
      if (which == 0) {
        threads = AttnPlan<96>::THREADS, smem = AttnPlan<96>::SMEM;
        err = cudaFuncGetAttributes(&attr, attn_block_bf16_tiled_kernel<96>);
      }
      break;
    ATTN_ATTRS(192)
    ATTN_ATTRS(384)
    ATTN_ATTRS(768)
    default:
      break;
  }
#undef ATTN_ATTRS
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[4] = {threads, smem, attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 4; ++i) g[i] = v[i];
  return 0;
}
