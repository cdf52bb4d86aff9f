// The MLP half of a Swin block:
//
//     y = x + fc2(gelu_erf(fc1(LayerNorm(x))))       x, y: [R, C]
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/swin_mlp.py::
// mlp_block_fused (_kernel).
//
// Rounding places (T is float or bf16), as in the JAX kernel: LayerNorm in
// float32 (eps 1e-5), rounded to T; fc1 accumulates in float32, + b1 in
// float32, rounded to T; gelu (erff) in float32, rounded to T; fc2 accumulates
// in float32, + b2 and + x in float32, rounded to T once. LayerNorm
// parameters and both biases are float32; k1 [4C, C] and k2 [C, 4C] are in T,
// laid out as nn.Linear keeps them ([out, in]).
//
// bf16, for the H100 (sm_90a). The bound is operations, 16 R C^2 of them
// (0.044 ms at 989 TFLOP/s at every stage of swin_tiny at 544, batch 16,
// 0.1765 ms at every stage of swin_large), against 4 R C bytes of rows. Two
// forms, by width (ops/swin_mlp.py::mlp_form):
// - C = 96 and 192: one pass over the rows (the fused kernel, next
//   section); the 4C-wide hidden activations never reach device memory.
//   What bounds it (PERF.md): nothing overlaps within a warpgroup, so a
//   chunk's gelu (erff on the CUDA cores) and the LayerNorm at each tile's
//   start wait for and are waited on by the products; 14% and 21% of the
//   bound at swin_tiny's C = 96 and 192, 23% at swin_large's C = 192. The
//   wide form, given C = 192 on its best tiles, took 0.78 device ms against
//   this kernel's 0.76 at swin_large's 295,936 rows and 0.20 against 0.22
//   at swin_tiny's 73,984 (probes/h100_swin_mlp, PERF.md): no gain that
//   would pay for a second form at this width.
// - C = 384, 768 and 1536: LayerNorm, fc1 and fc2 as three launches with
//   the hidden activations in device memory (the section after). There a
//   tile's [rows, C] float32 fc2 accumulator and its LN(x) tile leave the
//   fused plan 64-row tiles and narrow fc1 products that keep the tensor
//   cores idle most of the time (15.6% of the bound at C = 768); two
//   operation-bound GEMM launches move h through device memory for less.
// float32: plain FMAs on the CUDA cores, no TF32, summing in index order so
// that it can be held to a CPU run; BM = 32 rows.
// Rows beyond R are zero in shared memory and never written.
#include "sm90.cuh"
#include "swin_common.cuh"

namespace {

using namespace swin;

// ------------------------------------- bf16, C = 96 and 192: one pass -----
//
// Both products on wgmma (m64nNk16, bf16 in, float32 accumulators), B and
// the LN(x) tile from shared memory in the 128-byte swizzled layout that the
// descriptors name (sm90.cuh). A block normalises a tile of rows into shared
// memory, then walks the hidden units in chunks of BH: fc1 on the chunk,
// + b1, gelu, rounded, already fc2's A operand in registers, and at once the
// chunk's share of fc2 into accumulators that stay in registers; x is read
// again for the residual and y written once. The weight slices arrive by
// TMA through a ring of STAGES slots with full and empty mbarriers: thread 0
// keeps the next slots' copies in flight, and a slot is refilled once every
// warp has released it. A tile is 128 rows, a warpgroup on each 64; blocks
// are persistent, MINB a multiprocessor, and walk tiles b, b + gridDim.x,
// ... in a fixed order: no atomics, the same bits every run. The tensor maps
// are encoded on the host per launch through cuTensorMapEncodeTiled, found
// with cudaGetDriverEntryPointByVersion (no -lcuda).

// Per width: RG row groups of 64 rows per tile (a warpgroup each), STAGES
// ring slots, MINB blocks a multiprocessor, BH hidden units a chunk. Each
// chosen by timing the alternatives in one call on an H100 (PERF.md).
template <int RG_, int STAGES_, int MINB_, int BH_> struct MlpShapeOf {
  static constexpr int RG = RG_, STAGES = STAGES_, MINB = MINB_, BH = BH_;
};
template <int C> struct MlpShape;
template <> struct MlpShape<96> : MlpShapeOf<2, 4, 2, 64> {};
template <> struct MlpShape<192> : MlpShapeOf<2, 3, 1, 128> {};

template <int C> struct MlpPlan {
  static constexpr int RG = MlpShape<C>::RG, STAGES = MlpShape<C>::STAGES,
                       MINB = MlpShape<C>::MINB, BH = MlpShape<C>::BH;   // hidden units a chunk
  static constexpr int THREADS = RG * 128;
  static constexpr int BM = 64 * RG;               // rows of a tile
  static constexpr int KB = (C + 63) / 64;         // 64-wide blocks of a k1 slice (C = 96: 2)
  static constexpr int K1_BYTES = KB * BH * 128;   // KB blocks of [BH][64]
  static constexpr int K2_BYTES = C * BH * 2;      // BH / 64 blocks of [C][64]
  static constexpr int STAGE = K1_BYTES > K2_BYTES ? K1_BYTES : K2_BYTES;
  static constexpr int LN_BLOCK = BM * 128;        // one 64-wide block of the LN(x) tile
  // shared memory, bytes from a 1024-aligned base
  static constexpr int LN = 0;
  static constexpr int RING = LN + KB * LN_BLOCK;
  static constexpr int BAR = RING + STAGES * STAGE;             // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;      // + room to align the base
  static_assert(C % 8 == 0 && C <= 256, "a k2 box holds the C rows of 64 hidden units");
  static_assert(SMEM * MINB <= 232448, "shared memory");
};

// LayerNorm of rows row0 .. row0 + BM - 1 into the swizzled LN(x) tile,
// rounded to bf16; warp w takes rows w, w + NWARPS, ..., RB of them at a time,
// and loads all RB before it reduces any, so that their latencies overlap.
// Statistics as layer_norm_row computes them; a row past `rows` is zero.
template <int C, int BM, int NWARPS>
__device__ __forceinline__ void ln_tile_swizzled(const bf16* __restrict__ x,
                                                 const float* __restrict__ lns,
                                                 const float* __restrict__ lnb,
                                                 unsigned char* tile, int row0, int rows) {
  constexpr int PER_LANE = C / 32, RPW = BM / NWARPS;
  constexpr int RB = RPW < 48 / PER_LANE ? RPW : (48 / PER_LANE > 0 ? 48 / PER_LANE : 1);
  static_assert(BM % NWARPS == 0 && RPW % RB == 0, "rows per warp");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int k0 = 0; k0 < RPW; k0 += RB) {
    float v[RB][PER_LANE];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int g = row0 + warp + (k0 + k) * NWARPS;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i)
        v[k][i] = g < rows ? to_f<bf16>(x[static_cast<size_t>(g) * C + lane + 32 * i]) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = warp + (k0 + k) * NWARPS;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) sum += v[k][i];
      const float mu = warp_sum(sum) / C;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        v[k][i] -= mu;
        sq += v[k][i] * v[k][i];
      }
      const float inv = 1.0f / sqrtf(warp_sum(sq) / C + LN_EPS);
      const bool valid = row0 + r < rows;
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int c = lane + 32 * i;
        *reinterpret_cast<bf16*>(tile + (c / 64) * (BM * 128) + sm90::sw128_offset(r, c % 64)) =
            from_f<bf16>(valid ? v[k][i] * inv * lns[c] + lnb[c] : 0.0f);
      }
    }
  }
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of BM rows.
// For every tile and every chunk of BH hidden units it consumes the chunk's
// k1 slice [BH, C] and then its k2 slice [C, BH] ("uses" 0, 1, ... in that
// order) through a ring of STAGES slots: use u lies in slot u % STAGES.
// Thread 0 keeps the TMA copies of the next STAGES uses in flight; the
// warpgroups run fc1 and fc2 on wgmma as the slices land and release each
// slot once their products are done with it.
template <int C>
__global__ void __launch_bounds__(MlpPlan<C>::THREADS, MlpPlan<C>::MINB)
mlp_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tm1,
                     const __grid_constant__ CUtensorMap tm2, const bf16* __restrict__ x,
                     const float* __restrict__ lns, const float* __restrict__ lnb,
                     const float* __restrict__ b1, const float* __restrict__ b2,
                     bf16* __restrict__ out, int rows) {
  using P = MlpPlan<C>;
  constexpr int USES = 2 * 4 * C / P::BH;                  // uses a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::STAGES;
  const int tiles = (rows + P::BM - 1) / P::BM;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, P::THREADS / 32);   // every warp releases every slot
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // Thread 0: start the copies of every use before `upto`; use v waits for
  // the release of use v - STAGES.
  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto; ++issued) {
      if (blockIdx.x + (issued / USES) * gridDim.x >= tiles) return;
      const int s = issued % P::STAGES, e = issued % USES;   // k1 of chunk e / 2, or its k2
      sm90::mbar_wait(empty + s, ((issued / P::STAGES) & 1) ^ 1);
      const uint32_t dst = base + P::RING + s * P::STAGE;
      if (e % 2 == 0) {
        sm90::mbar_expect_tx(full + s, P::K1_BYTES);
        for (int kb = 0; kb < P::KB; ++kb)
          sm90::tma_load_2d(dst + kb * P::BH * 128, &tm1, kb * 64, e / 2 * P::BH, full + s);
      } else {
        sm90::mbar_expect_tx(full + s, P::K2_BYTES);
        for (int kh = 0; kh < P::BH / 64; ++kh)
          sm90::tma_load_2d(dst + kh * C * 128, &tm2, e / 2 * P::BH + kh * 64, 0, full + s);
      }
    }
  };

  const int wg = threadIdx.x / 128;                          // the tile's rows 64 wg ..
  const int warp = threadIdx.x / 32, wq = warp % 4, lane = threadIdx.x % 32;
  const int er = 16 * wq + lane / 4, ec = 2 * (lane % 4);    // accumulator row and column
  int use = 0;                                               // uses walked
  // Wait for use `use` to land (thread 0 first tops up the ring); returns its
  // slot's shared address.
  auto acquire = [&]() {
    if (threadIdx.x == 0) issue_upto(use + P::STAGES);
    __syncwarp();
    sm90::mbar_wait(full + use % P::STAGES, (use / P::STAGES) & 1);
    return base + P::RING + (use % P::STAGES) * P::STAGE;
  };
  auto release = [&]() {
    if (lane == 0) sm90::mbar_arrive(empty + use % P::STAGES);
    ++use;
  };

  if (threadIdx.x == 0) issue_upto(P::STAGES);      // the first slices land under the LayerNorm
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t * P::BM;
    sm90::named_barrier(1, P::THREADS);        // the last tile's fc1 is done with the LN(x) tile
    ln_tile_swizzled<C, P::BM, P::THREADS / 32>(x, lns, lnb, smem + P::LN, row0, rows);
    sm90::fence_proxy_async();
    sm90::named_barrier(1, P::THREADS);

    float y[C / 2];
#pragma unroll
    for (int i = 0; i < C / 2; ++i) y[i] = 0.0f;
    for (int h0 = 0; h0 < 4 * C; h0 += P::BH) {
      // fc1: acc = LN(x)[64, C] x k1 slice [C, BH] for this warpgroup's rows
      float acc[P::BH / 2];
      {
        const uint64_t da = sm90::sw128_desc(base + P::LN + wg * 64 * 128);
        const uint64_t db = sm90::sw128_desc(acquire());
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < C; k += 16)
          sm90::wgmma_ss(acc, sm90::desc_add(da, (k / 64) * P::LN_BLOCK + (k % 64) * 2),
                         sm90::desc_add(db, (k / 64) * P::BH * 128 + (k % 64) * 2), k > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release();
      }

      // + b1, round, gelu, round: to A fragments
      uint32_t frag[P::BH / 16][4];
#pragma unroll
      for (int j = 0; j < P::BH / 8; ++j) {
        const int col = 8 * j + ec;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + h0 + col);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = gelu_erf(round_to<bf16>(acc[4 * j + i] + (i % 2 ? bias.y : bias.x)));
        frag[j / 2][(j % 2) * 2] = pack_bf16(v[0], v[1]);
        frag[j / 2][(j % 2) * 2 + 1] = pack_bf16(v[2], v[3]);
      }

      // fc2: y[64, C] += gelu[64, BH] x k2 slice [BH, C]
      {
        const uint64_t db = sm90::sw128_desc(acquire());
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < P::BH; k += 16)
          sm90::wgmma_rs(y, frag[k / 16], sm90::desc_add(db, (k / 64) * C * 128 + (k % 64) * 2),
                         1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(y);
        release();
      }
    }

    // + b2, + x, round once; a lane writes two neighbouring columns at a time
#pragma unroll
    for (int j = 0; j < C / 8; ++j) {
      const int col = 8 * j + ec;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int g = row0 + wg * 64 + er + 8 * hi;
        if (g < rows) {
          const size_t at = static_cast<size_t>(g) * C + col;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at);
          *reinterpret_cast<uint32_t*>(out + at) =
              pack_bf16(__bfloat162float(xv.x) + (y[4 * j + 2 * hi] + bias.x),
                        __bfloat162float(xv.y) + (y[4 * j + 2 * hi + 1] + bias.y));
        }
      }
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(err);
}

// Blocks of the bf16 launch for `tiles` tiles: as many as stay resident
// (MINB a multiprocessor), or one a tile where there are fewer tiles.
template <int C>
int blocks_sm90(int tiles, int* blocks) {
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  *blocks = tiles < sms * MlpPlan<C>::MINB ? tiles : sms * MlpPlan<C>::MINB;
  return 0;
}

template <int C>
int launch_bf16_sm90(const void* x, const void* lns, const void* lnb, const void* k1,
                     const void* b1, const void* k2, const void* b2, void* out, int rows,
                     cudaStream_t stream) {
  using P = MlpPlan<C>;
  CUtensorMap tm1, tm2;
  if (!sm90::map_sw128(&tm1, k1, C, 4 * C, P::BH) ||
      !sm90::map_sw128(&tm2, k2, 4 * C, C, C))
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  if (int err = blocks_sm90<C>((rows + P::BM - 1) / P::BM, &blocks)) return err;
  auto kernel = mlp_bf16_sm90_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, P::THREADS, P::SMEM, stream>>>(
      tm1, tm2, static_cast<const bf16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<bf16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// {rows a tile, cluster size, blocks, tiles, ring stages, dynamic shared
// memory bytes, threads a block, registers a thread, local (spill) bytes a
// thread, columns a tile (C), column tiles (1)} of the bf16 launch for
// `rows` rows of width c.
template <int C>
int geometry_sm90(int rows, int* g) {
  using P = MlpPlan<C>;
  const int tiles = (rows + P::BM - 1) / P::BM;
  int blocks = 0;
  if (int err = blocks_sm90<C>(tiles, &blocks)) return err;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mlp_bf16_sm90_kernel<C>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[11] = {P::BM, 1, blocks, tiles, P::STAGES, P::SMEM, P::THREADS, attr.numRegs,
                     static_cast<int>(attr.localSizeBytes), C, 1};
  for (int i = 0; i < 11; ++i) g[i] = v[i];
  return 0;
}

// ---------------------------- bf16, C = 384, 768, 1536: three launches -----
//
// The hidden activations go through device memory, in three launches with
// the fused kernel's rounding places: LayerNorm of each row into xn [R, C]
// (mlp_wide_ln_kernel); fc1 on xn, + b1, gelu, into h [R, 4C]; fc2 on h,
// + b2, + x, into y (mlp_wide_gemm_kernel, once for each product). Both
// products are bound by operations: at Swin-L's stage 2 (18,496 rows of
// 768) each is 87 GFLOP against 114 MB of h, written once and read once,
// and 28 MB each of xn and x. The GEMM kernel:
// - Persistent blocks, one a multiprocessor, of two consumer warpgroups and
//   a producer warp. Block b takes output tiles b, b + gridDim.x, ... (a
//   fixed order: no split of k, no atomics, the same bits every run), row
//   tiles outer, so that tiles in flight together share their rows of A
//   and all of the weight (in L2).
// - Warp specialisation: one thread of the producer warp keeps TMA copies
//   of A's and the weight's 64-wide k slices in flight through a ring of
//   STAGES slots with full and empty mbarriers, across tiles. ptxas holds
//   every thread of a block of more than two warpgroups to 168 registers,
//   setmaxnreg or not (PERF.md), so the producer is one warp and keeps its
//   registers.
// - Two consumer warpgroups in ping-pong: each owns every other tile of the
//   block. Named barriers hand the tensor cores from one to the other: a
//   warpgroup issues its tile's products while the other runs its epilogue
//   (+ b1 and gelu's erff on R x 4C values, or + b2 + x), so the epilogue
//   hides behind the products. A warpgroup keeps one group of wgmma in
//   flight and releases a slot once the group that read it has retired.
// - Epilogue through shared memory: each consumer stages its tile in the
//   swizzled layout and one thread stores it by TMA (fc2's x tile arrives
//   the same way into the staging tile during the products; the tile's
//   biases are loaded during the products and read from shared memory).
// What bounds it (probes/h100_swin_mlp, PERF.md): fc2 runs at ~600 TFLOP/s,
// where a 128 x 128 tile's operands stream from L2 at 64 bytes a clock a
// multiprocessor at the full rate; fc1 waits for its gelu epilogue where k
// is short (C = 384: 0.31 of 0.52 ms at 73,984 rows). A consumer's 128 x 128
// float32 accumulators fit ptxas's 168 registers only because every shared
// access is 32-bit: with the base aligned through an integer the epilogue
// became generic 64-bit loads and stores, and spilled their addresses.
// Rows past R load as zeros and are never stored.
namespace wide {

// Each consumer warpgroup's output tile (BM rows x BN columns) and the ring
// slots, per width and product; chosen by timing the candidates in one call
// on an H100 (PERF.md, probes/h100_swin_mlp).
template <int BM_, int BN_, int STAGES_> struct ShapeOf {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
};
template <int C, bool FC2> struct Shape;
template <> struct Shape<384, false> : ShapeOf<64, 192, 5> {};
template <> struct Shape<384, true> : ShapeOf<128, 128, 4> {};
template <> struct Shape<768, false> : ShapeOf<128, 128, 4> {};
template <> struct Shape<768, true> : ShapeOf<128, 128, 4> {};
template <> struct Shape<1536, false> : ShapeOf<128, 128, 4> {};
template <> struct Shape<1536, true> : ShapeOf<128, 128, 4> {};

template <int C, bool FC2> struct Plan {
  static constexpr int BM = Shape<C, FC2>::BM, BN = Shape<C, FC2>::BN,
                       STAGES = Shape<C, FC2>::STAGES;
  static constexpr int K = FC2 ? 4 * C : C, N = FC2 ? C : 4 * C;
  static constexpr int KS = K / 64;                      // k slices of a tile
  static constexpr int NT = N / BN;                      // column tiles
  static constexpr int MS = BM / 64;                     // wgmma row tiles of a tile
  static constexpr int THREADS = 288;                    // two consumers + a producer warp
  static constexpr int A_BYTES = BM * 128, SLOT = A_BYTES + BN * 128;
  static constexpr int OUT_BYTES = BM * BN * 2;          // a consumer's staging tile
  // shared memory, bytes from a 1024-aligned base
  static constexpr int OUT = STAGES * SLOT;              // two staging tiles after the ring
  static constexpr int BIAS = OUT + 2 * OUT_BYTES;       // each consumer's BN biases
  static constexpr int BAR = BIAS + 2 * BN * 4;          // full[STAGES], empty[STAGES], xfull[2]
  static constexpr int SMEM = BAR + (2 * STAGES + 2) * 8 + 1024;   // + room to align the base
  static_assert(N % BN == 0 && BN % 64 == 0 && K % 64 == 0 && (BM == 64 || BM == 128), "tiles");
  static_assert(MS * BN / 2 <= 128, "accumulators");
  static_assert(SMEM <= 232448, "shared memory");
};

constexpr int LN_THREADS = 256;
constexpr int LN_ROWS = LN_THREADS / 32;              // rows a block of the LayerNorm launch
}  // namespace wide

template <int C>
__global__ void __launch_bounds__(wide::LN_THREADS)
mlp_wide_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                   const float* __restrict__ lnb, bf16* __restrict__ xn, int rows) {
  const int row = blockIdx.x * wide::LN_ROWS + threadIdx.x / 32;
  if (row < rows)
    layer_norm_row<bf16, bf16, C>(x + static_cast<size_t>(row) * C, lns, lnb, 1.0f,
                                  xn + static_cast<size_t>(row) * C);
}

// out = A [rows, K] times W^T, W [N, K] (K-major, as nn.Linear keeps it):
// fc1 (FC2 false: K = C, N = 4C; + b1, rounded, gelu, rounded, into h) or
// fc2 (FC2 true: K = 4C, N = C; + b2, + x, rounded once, into y). Tensor
// maps: ta A, tw W, tx x (fc2 only), ty the output, each in boxes of
// [BM or BN rows, 64 columns].
template <int C, bool FC2>
__global__ void __launch_bounds__(wide::Plan<C, FC2>::THREADS, 1)
mlp_wide_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap ty, const float* __restrict__ bias,
                     int rows) {
  using P = wide::Plan<C, FC2>;
  extern __shared__ unsigned char smem_raw[];
  // the 1024-aligned base as an offset into the shared array, so that the
  // compiler keeps every access through it in 32-bit shared addressing
  unsigned char* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::STAGES;
  uint64_t* xfull = empty + P::STAGES;
  const int tiles = (rows + P::BM - 1) / P::BM * P::NT;
  // this block's tiles: blockIdx.x + j * gridDim.x for j < mine
  const int grid = gridDim.x, mine = (tiles - static_cast<int>(blockIdx.x) + grid - 1) / grid;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 1);
    }
    sm90::mbar_init(xfull, 1);
    sm90::mbar_init(xfull + 1, 1);
    sm90::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: k slice u of the block (tile u / KS) lies in slot u % STAGES
    // and waits for the release of slice u - STAGES
    if (threadIdx.x == 256) {
      for (int j = 0, u = 0; j < mine; ++j) {
        const int t = blockIdx.x + j * grid;
        const int m0 = t / P::NT * P::BM, n0 = t % P::NT * P::BN;
        for (int k = 0; k < P::KS; ++k, ++u) {
          const int s = u % P::STAGES;
          sm90::mbar_wait(empty + s, ((u / P::STAGES) & 1) ^ 1);
          const uint32_t dst = base + s * P::SLOT;
          sm90::mbar_expect_tx(full + s, P::SLOT);
          sm90::tma_load_2d(dst, &ta, k * 64, m0, full + s);
          sm90::tma_load_2d(dst + P::A_BYTES, &tw, k * 64, n0, full + s);
        }
      }
    }
  } else {
    // consumer w takes the block's tiles j = w, w + 2, ...; it may issue its
    // products once it passes named barrier 1 + w, which the other consumer
    // arrives at when it has issued its own tile's products
    const int w = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int er = 16 * warp + lane / 4, ec = 2 * (lane % 4);   // accumulator row, column
    const uint32_t out_tile = P::OUT + w * P::OUT_BYTES;
    float* sbias = reinterpret_cast<float*>(smem + P::BIAS) + w * P::BN;
    if (w == 1 && mine > 0) sm90::named_barrier_arrive(1, 256);
    float acc[P::MS][P::BN / 2];
    for (int j = w, n = 0; j < mine; j += 2, ++n) {
      const int t = blockIdx.x + j * grid;
      const int m0 = t / P::NT * P::BM, n0 = t % P::NT * P::BN;
      // the tile's biases, stored to shared memory after the products
      float breg[(P::BN + 127) / 128];
#pragma unroll
      for (int i = 0; i < (P::BN + 127) / 128; ++i)
        breg[i] = tid + 128 * i < P::BN ? bias[n0 + tid + 128 * i] : 0.0f;
      if (tid == 0) {
        sm90::bulk_wait_read<0>();        // the last tile's store has read the staging tile
        if constexpr (FC2) {
          sm90::mbar_expect_tx(xfull + w, P::OUT_BYTES);
          for (int b = 0; b < P::BN / 64; ++b)
            sm90::tma_load_2d(base + out_tile + b * P::BM * 128, &tx, n0 + 64 * b, m0, xfull + w);
        }
      }
      sm90::named_barrier(1 + w, 256);
      int u = j * P::KS;
      for (int k = 0; k < P::KS; ++k, ++u) {
        const int s = u % P::STAGES;
        sm90::mbar_wait(full + s, (u / P::STAGES) & 1);
        const uint32_t slot = base + s * P::SLOT;
        const uint64_t da = sm90::sw128_desc(slot), db = sm90::sw128_desc(slot + P::A_BYTES);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 64; kk += 16)
#pragma unroll
          for (int ms = 0; ms < P::MS; ++ms)
            sm90::wgmma_ss(acc[ms], sm90::desc_add(da, ms * 64 * 128 + kk * 2),
                           sm90::desc_add(db, kk * 2), k > 0 || kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();            // the slice before this one is read
        sm90::mbar_arrive_if(empty + (u + P::STAGES - 1) % P::STAGES, tid == 0 && k > 0);
      }
      if (j + 1 < mine) sm90::named_barrier_arrive(2 - w, 256);
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int ms = 0; ms < P::MS; ++ms) sm90::fence_regs(acc[ms]);
      sm90::mbar_arrive_if(empty + (u + P::STAGES - 1) % P::STAGES, tid == 0);

      // epilogue into the staging tile: BN / 64 swizzled blocks of [BM][64];
      // a lane writes two neighbouring columns of two rows at a time
#pragma unroll
      for (int i = 0; i < (P::BN + 127) / 128; ++i)
        if (tid + 128 * i < P::BN) sbias[tid + 128 * i] = breg[i];
      sm90::named_barrier(3 + w, 128);    // the biases are in; fc1: the staging tile is free
      if constexpr (FC2) sm90::mbar_wait(xfull + w, n & 1);
#pragma unroll
      for (int j8 = 0; j8 < P::BN / 8; ++j8) {
        const int col = 8 * j8 + ec;
        const float2 b = *reinterpret_cast<const float2*>(sbias + col);
#pragma unroll
        for (int ms = 0; ms < P::MS; ++ms)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            uint32_t* at = reinterpret_cast<uint32_t*>(
                smem + out_tile + col / 64 * (P::BM * 128) +
                sm90::sw128_offset(64 * ms + er + 8 * hi, col % 64));
            const float v0 = acc[ms][4 * j8 + 2 * hi], v1 = acc[ms][4 * j8 + 2 * hi + 1];
            if constexpr (FC2) {
              const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(at);
              *at = pack_bf16(__bfloat162float(xv.x) + (v0 + b.x),
                              __bfloat162float(xv.y) + (v1 + b.y));
            } else {
              *at = pack_bf16(gelu_erf(round_to<bf16>(v0 + b.x)),
                              gelu_erf(round_to<bf16>(v1 + b.y)));
            }
          }
      }
      sm90::fence_proxy_async();
      sm90::named_barrier(3 + w, 128);
      if (tid == 0) {
        for (int b = 0; b < P::BN / 64; ++b)
          sm90::tma_store_2d(&ty, n0 + 64 * b, m0, base + out_tile + b * P::BM * 128);
        sm90::bulk_commit();
      }
    }
    if (tid == 0) sm90::bulk_wait<0>();
  }
}

template <int C, bool FC2>
int launch_wide_gemm(const void* a, const void* w, const void* x, void* out, const void* bias,
                     int rows, int sms, cudaStream_t stream) {
  using P = wide::Plan<C, FC2>;
  CUtensorMap ta, tw, tx, ty;
  if (!sm90::map_sw128(&ta, a, P::K, rows, P::BM) || !sm90::map_sw128(&tw, w, P::K, P::N, P::BN) ||
      !sm90::map_sw128(&ty, out, P::N, rows, P::BM) ||
      !sm90::map_sw128(&tx, FC2 ? x : out, P::N, rows, P::BM))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mlp_wide_gemm_kernel<C, FC2>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (rows + P::BM - 1) / P::BM * P::NT;
  kernel<<<tiles < sms ? tiles : sms, P::THREADS, P::SMEM, stream>>>(
      ta, tw, tx, ty, static_cast<const float*>(bias), rows);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_bf16_wide(const void* x, const void* lns, const void* lnb, const void* k1,
                     const void* b1, const void* k2, const void* b2, void* out, void* xn,
                     void* h, int rows, cudaStream_t stream) {
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  mlp_wide_ln_kernel<C><<<(rows + wide::LN_ROWS - 1) / wide::LN_ROWS, wide::LN_THREADS, 0,
                          stream>>>(static_cast<const bf16*>(x), static_cast<const float*>(lns),
                                    static_cast<const float*>(lnb), static_cast<bf16*>(xn), rows);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  if (int err = launch_wide_gemm<C, false>(xn, k1, nullptr, h, b1, rows, sms, stream)) return err;
  return launch_wide_gemm<C, true>(h, k2, x, out, b2, rows, sms, stream);
}

// The GEMM launch's geometry (fc2's where FC2, else fc1's) in
// geometry_sm90's order, then columns a tile and column tiles.
template <int C, bool FC2>
int geometry_wide(int rows, int* g) {
  using P = wide::Plan<C, FC2>;
  int sms = 0;
  if (int err = sm_count(&sms)) return err;
  const int tiles = (rows + P::BM - 1) / P::BM * P::NT;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mlp_wide_gemm_kernel<C, FC2>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[11] = {P::BM, 1, tiles < sms ? tiles : sms, tiles, P::STAGES, P::SMEM, P::THREADS,
                     attr.numRegs, static_cast<int>(attr.localSizeBytes), P::BN, P::NT};
  for (int i = 0; i < 11; ++i) g[i] = v[i];
  return 0;
}

// ------------------------------------------------------------- float32 -----

template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ k1,
               const float* __restrict__ b1, const float* __restrict__ k2,
               const float* __restrict__ b2, float* __restrict__ out, int rows) {
  constexpr int E2 = BM32 * C / THREADS;        // fc2 outputs per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);   // [BM32][C] LN(x)
  float* sh = sa + BM32 * C;                    // [BM32][BH] gelu chunk
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM32;

  layer_norm_tile<float, C, BM32, C>(x, lns, lnb, sa, row0, rows);
  __syncthreads();

  float y[E2];
  mlp_hidden_walk_f32<C>(sa, BM32 - 1, sh, k1, b1, k2, y);

#pragma unroll
  for (int i = 0; i < E2; ++i) {
    const int e = tid + THREADS * i;
    const int g = row0 + e / C, n = e % C;
    if (g < rows) {
      const size_t at = static_cast<size_t>(g) * C + n;
      out[at] = x[at] + (y[i] + b2[n]);
    }
  }
}

template <int C>
int launch_f32(const void* x, const void* lns, const void* lnb, const void* k1,
               const void* b1, const void* k2, const void* b2, void* out, int rows,
               cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BM32) * (C + BH) * sizeof(float);
  auto kernel = mlp_f32_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(rows + BM32 - 1) / BM32, THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [rows, c]; lns, lnb [c]; k1 [4c, c]; b1 [4c]; k2 [c, 4c]; b2 [c].
// x, k1, k2 and out are bf16 when is_bf16 is nonzero, else float32; the
// LayerNorm parameters and biases are float32. c is 96 or 192 in bf16 (the
// widths swin_mlp_wide does not take), 96 to 1536 in float32;
// any other width, or bf16 weights not 16-byte aligned, returns
// cudaErrorInvalidValue.
extern "C" int swin_mlp(const void* x, const void* lns, const void* lnb,
                        const void* k1, const void* b1, const void* k2,
                        const void* b2, void* out, int rows, int c, int is_bf16,
                        void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWIN_MLP_CASE(C)                                                                 \
  case C:                                                                                \
    return is_bf16 ? launch_bf16_sm90<C>(x, lns, lnb, k1, b1, k2, b2, out, rows, s)      \
                   : launch_f32<C>(x, lns, lnb, k1, b1, k2, b2, out, rows, s);
#define SWIN_MLP_F32_CASE(C)                                                             \
  case C:                                                                                \
    return is_bf16 ? static_cast<int>(cudaErrorInvalidValue)                             \
                   : launch_f32<C>(x, lns, lnb, k1, b1, k2, b2, out, rows, s);
  switch (c) {
    SWIN_MLP_CASE(96)
    SWIN_MLP_CASE(192)
    SWIN_MLP_F32_CASE(384)
    SWIN_MLP_F32_CASE(768)
    SWIN_MLP_F32_CASE(1536)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_MLP_CASE
#undef SWIN_MLP_F32_CASE
}

// A bf16 launch's geometry for `rows` rows of width c into g[0..11): rows a
// tile, cluster size, blocks, tiles, ring stages, dynamic shared memory
// bytes, threads a block, registers a thread, local (spill) bytes a thread,
// columns a tile, column tiles. launch: 0 the fused kernel (c = 96, 192),
// 1 and 2 swin_mlp_wide's fc1 and fc2 GEMM launches (c = 384, 768, 1536);
// any other pair returns cudaErrorInvalidValue.
extern "C" int swin_mlp_geometry(int c, int rows, int launch, int* g) {
#define SWIN_MLP_WIDE_GEOMETRY(C)                                                        \
  if (c == C && launch == 1) return geometry_wide<C, false>(rows, g);                   \
  if (c == C && launch == 2) return geometry_wide<C, true>(rows, g);
  if (launch == 0) {
    if (c == 96) return geometry_sm90<96>(rows, g);
    if (c == 192) return geometry_sm90<192>(rows, g);
  }
  SWIN_MLP_WIDE_GEOMETRY(384)
  SWIN_MLP_WIDE_GEOMETRY(768)
  SWIN_MLP_WIDE_GEOMETRY(1536)
#undef SWIN_MLP_WIDE_GEOMETRY
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16 at c = 384, 768 or 1536: x, out [rows, c]; k1 [4c, c], k2 [c, 4c],
// the LayerNorm parameters and biases as swin_mlp takes them; xn [rows, c]
// and h [rows, 4c] bf16 are room for LN(x) and the hidden activations.
// Three launches on `stream`.
extern "C" int swin_mlp_wide(const void* x, const void* lns, const void* lnb, const void* k1,
                             const void* b1, const void* k2, const void* b2, void* out,
                             void* xn, void* h, int rows, int c, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 384: return launch_bf16_wide<384>(x, lns, lnb, k1, b1, k2, b2, out, xn, h, rows, s);
    case 768: return launch_bf16_wide<768>(x, lns, lnb, k1, b1, k2, b2, out, xn, h, rows, s);
    case 1536: return launch_bf16_wide<1536>(x, lns, lnb, k1, b1, k2, b2, out, xn, h, rows, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
