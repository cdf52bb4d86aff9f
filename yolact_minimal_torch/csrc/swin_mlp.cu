// The MLP half of a Swin block in one pass over the rows:
//
//     y = x + fc2(gelu_erf(fc1(LayerNorm(x))))       x, y: [R, C]
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/swin_mlp.py::
// mlp_block_fused (_kernel). The 4C-wide hidden activations never reach
// device memory: a block normalises a tile of rows into shared memory, then
// walks the hidden units in chunks of 64 or 128: fc1 on the chunk, + b1,
// gelu, and at once the chunk's share of fc2 into accumulators that stay in
// registers; x is read again for the residual and y written once.
//
// Rounding places (T is float or bf16), as in the JAX kernel: LayerNorm in
// float32 (eps 1e-5), rounded to T; fc1 accumulates in float32, + b1 in
// float32, rounded to T; gelu (erff) in float32, rounded to T; fc2 accumulates
// in float32, + b2 and + x in float32, rounded to T once. LayerNorm
// parameters and both biases are float32; k1 [4C, C] and k2 [C, 4C] are in T,
// laid out as nn.Linear keeps them ([out, in]).
//
// bf16, for the H100 (sm_90a). The bound is operations, 16 R C^2 of them
// (43.6 GFLOP, 0.044 ms at 989 TFLOP/s, at every stage of swin_tiny at 544,
// batch 16), against 4 R C bytes of rows. The design:
// - Both products on wgmma (m64nNk16, bf16 in, float32 accumulators), B and
//   the LN(x) tile from shared memory in the 128-byte swizzled layout that
//   the descriptors name (sm90.cuh). The fc1 accumulators, + b1, gelu and
//   rounded, are already fc2's A operand in registers where one warpgroup
//   owns a chunk (C <= 192); where the warpgroups split it, they meet in a
//   swizzled gelu tile in shared memory (two of them, by chunk parity).
// - The weight slices arrive by TMA through a ring of 2-4 slots with full
//   and empty mbarriers: thread 0 keeps the next slots' copies in flight, and
//   a slot is refilled once every warp has released it, so a slice lands
//   while the one before it is in use. The tensor maps are encoded on the
//   host per launch through cuTensorMapEncodeTiled, found with
//   cudaGetDriverEntryPointByVersion (no -lcuda).
// - A tile is 128 rows (two warpgroups on their own 64 rows) at C = 96 and
//   192, 64 rows at 384 and 768, where the [64, C] float32 accumulator is
//   split over two or four warpgroups by output columns; blocks are
//   persistent, one a multiprocessor (two at C = 96), and walk tiles b,
//   b + gridDim.x, ... in a fixed order: no atomics, the same bits every run.
// - What bounds it now (chip_smoke.py phase 3 and knock-out builds, PERF.md):
//   nothing overlaps within a warpgroup, so a chunk's gelu (erff on the CUDA
//   cores, R x 4C of them) and the LayerNorm at each tile's start wait for
//   and are waited on by the products; at C = 768, 73 tiles leave 59 of the
//   132 multiprocessors idle and each warpgroup's fc1 is a narrow n32
//   product; at C = 384, 289 tiles take three rounds for 2.2 rounds of work.
// float32: plain FMAs on the CUDA cores, no TF32, summing in index order so
// that it can be held to a CPU run; BM = 32 rows.
// Rows beyond R are zero in shared memory and never written.
#include "sm90.cuh"
#include "swin_common.cuh"

namespace {

using namespace swin;

// ------------------------------------------------ bf16, Hopper (wgmma) -----

// Per width: RG row groups of 64 rows per tile, CS warpgroups sharing a row
// group (each takes 1/CS of the hidden chunk in fc1 and of the output
// columns in fc2), SUB pieces per weight slice, STAGES ring slots, MINB
// blocks a multiprocessor, BH hidden units a chunk. Each chosen by timing
// the alternatives in one call on an H100 (PERF.md): 128-unit chunks pay
// at C = 192 and 768 (fc1 wider than n16 there), not at 384.
template <int RG_, int CS_, int SUB_, int STAGES_, int MINB_, int BH_> struct MlpShapeOf {
  static constexpr int RG = RG_, CS = CS_, SUB = SUB_, STAGES = STAGES_, MINB = MINB_, BH = BH_;
};
template <int C> struct MlpShape;
template <> struct MlpShape<96> : MlpShapeOf<2, 1, 1, 4, 2, 64> {};
template <> struct MlpShape<192> : MlpShapeOf<2, 1, 1, 3, 1, 128> {};
template <> struct MlpShape<384> : MlpShapeOf<1, 2, 1, 3, 1, 64> {};
template <> struct MlpShape<768> : MlpShapeOf<1, 4, 4, 2, 1, 128> {};

template <int C> struct MlpPlan {
  static constexpr int RG = MlpShape<C>::RG, CS = MlpShape<C>::CS, SUB = MlpShape<C>::SUB,
                       STAGES = MlpShape<C>::STAGES, MINB = MlpShape<C>::MINB,
                       BH = MlpShape<C>::BH;         // hidden units of a chunk
  static constexpr int WG = RG * CS;               // consumer warpgroups
  static constexpr int THREADS = WG * 128;
  static constexpr int BM = 64 * RG;               // rows of a tile
  static constexpr int N1 = BH / CS;               // fc1 columns of a warpgroup
  static constexpr int N2 = C / CS;                // fc2 columns of a warpgroup
  static constexpr int KP = C / SUB;               // k1 piece [64][KP], k2 piece [KP][64]
  static constexpr int KB = (KP + 63) / 64;        // 64-wide blocks of a k1 piece (C = 96: 2)
  static constexpr int BN2 = KP < 192 ? KP : 192;  // rows of a k2 TMA box (at most 256)
  static constexpr int K1_BYTES = KB * BH * 128;   // KB blocks of [BH][64]
  static constexpr int K2_BYTES = KP * BH * 2;     // BH / 64 blocks of [KP][64]
  static constexpr int STAGE = K1_BYTES > K2_BYTES ? K1_BYTES : K2_BYTES;
  static constexpr int LN_BLOCK = BM * 128;        // one 64-wide block of the LN(x) tile
  // shared memory, bytes from a 1024-aligned base
  static constexpr int LN = 0;
  static constexpr int HT = LN + ((C + 63) / 64) * LN_BLOCK;   // CS > 1: 2 x [64][64] gelu tiles
  static constexpr int RING = HT + (CS > 1 ? 2 * BH * 128 : 0);
  static constexpr int BAR = RING + STAGES * STAGE;             // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;      // + room to align the base
  static_assert(KP % 64 == 0 || SUB == 1, "pieces");
  static_assert(KP % BN2 == 0 && N2 % 8 == 0 && (N2 * (CS - 1)) % 8 == 0, "tiles");
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
// k1 slice [BH, C] and then its k2 slice [C, BH], each in SUB pieces ("uses"
// 0, 1, ... in that order), through a ring of STAGES slots: use u lies in
// slot u % STAGES. Thread 0 keeps the TMA copies of the next STAGES uses in
// flight; the warpgroups run fc1 and fc2 on wgmma as the pieces land and
// release each slot once their products are done with it.
template <int C>
__global__ void __launch_bounds__(MlpPlan<C>::THREADS, MlpPlan<C>::MINB)
mlp_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tm1,
                     const __grid_constant__ CUtensorMap tm2, const bf16* __restrict__ x,
                     const float* __restrict__ lns, const float* __restrict__ lnb,
                     const float* __restrict__ b1, const float* __restrict__ b2,
                     bf16* __restrict__ out, int rows) {
  using P = MlpPlan<C>;
  constexpr int NCH = 4 * C / P::BH;                       // chunks a tile
  constexpr int USES = NCH * 2 * P::SUB;                   // uses a tile
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
      const int s = issued % P::STAGES, p = issued % P::SUB;
      const int e = (issued % USES) / P::SUB;          // k1 of chunk e / 2, or its k2
      sm90::mbar_wait(empty + s, ((issued / P::STAGES) & 1) ^ 1);
      const uint32_t dst = base + P::RING + s * P::STAGE;
      if (e % 2 == 0) {
        sm90::mbar_expect_tx(full + s, P::K1_BYTES);
        for (int kb = 0; kb < P::KB; ++kb)
          sm90::tma_load_2d(dst + kb * P::BH * 128, &tm1, p * P::KP + kb * 64, e / 2 * P::BH,
                            full + s);
      } else {
        sm90::mbar_expect_tx(full + s, P::K2_BYTES);
        for (int kh = 0; kh < P::BH / 64; ++kh)
          for (int nb = 0; nb < P::KP / P::BN2; ++nb)
            sm90::tma_load_2d(dst + kh * P::KP * 128 + nb * P::BN2 * 128, &tm2,
                              e / 2 * P::BH + kh * 64, p * P::KP + nb * P::BN2, full + s);
      }
    }
  };

  const int wg = threadIdx.x / 128, rg = wg / P::CS, cs = wg % P::CS;
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

  if (threadIdx.x == 0) issue_upto(P::STAGES);      // the first pieces land under the LayerNorm
  for (int t = blockIdx.x, step = 0; t < tiles; t += gridDim.x) {
    const int row0 = t * P::BM;
    sm90::named_barrier(1, P::THREADS);        // the last tile's fc1 is done with the LN(x) tile
    ln_tile_swizzled<C, P::BM, P::THREADS / 32>(x, lns, lnb, smem + P::LN, row0, rows);
    sm90::fence_proxy_async();
    sm90::named_barrier(1, P::THREADS);

    float y[P::N2 / 2];
#pragma unroll
    for (int i = 0; i < P::N2 / 2; ++i) y[i] = 0.0f;
    for (int h0 = 0; h0 < 4 * C; h0 += P::BH, ++step) {
      // fc1: acc = LN(x)[64, C] x k1 slice [C, N1] for this warpgroup's rows
      // and hidden columns
      float acc[P::N1 / 2];
#pragma unroll
      for (int p = 0; p < P::SUB; ++p) {
        const uint64_t da = sm90::sw128_desc(base + P::LN + rg * 64 * 128);
        const uint64_t db = sm90::sw128_desc(acquire() + cs * P::N1 * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < P::KP; k += 16) {
          const int ka = p * P::KP + k;
          sm90::wgmma_ss(acc, sm90::desc_add(da, (ka / 64) * P::LN_BLOCK + (ka % 64) * 2),
                         sm90::desc_add(db, (k / 64) * P::BH * 128 + (k % 64) * 2),
                         p > 0 || k > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(acc);
        release();
      }

      // + b1, round, gelu, round: to A fragments (CS = 1) or the gelu tile
      uint32_t frag[P::BH / 16][4];
      const uint32_t ht = P::HT + (step % 2) * P::BH * 128;
#pragma unroll
      for (int j = 0; j < P::N1 / 8; ++j) {
        const int col = cs * P::N1 + 8 * j + ec;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + h0 + col);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          v[i] = gelu_erf(round_to<bf16>(acc[4 * j + i] + (i % 2 ? bias.y : bias.x)));
        const uint32_t lo = pack_bf16(v[0], v[1]), hi = pack_bf16(v[2], v[3]);
        if constexpr (P::CS == 1) {
          frag[j / 2][(j % 2) * 2] = lo;
          frag[j / 2][(j % 2) * 2 + 1] = hi;
        } else {
          unsigned char* block = smem + ht + (col / 64) * 8192;
          *reinterpret_cast<uint32_t*>(block + sm90::sw128_offset(er, col % 64)) = lo;
          *reinterpret_cast<uint32_t*>(block + sm90::sw128_offset(er + 8, col % 64)) = hi;
        }
      }
      if constexpr (P::CS > 1) {
        sm90::fence_proxy_async();
        sm90::named_barrier(2, P::THREADS);      // the whole gelu chunk is written
      }

      // fc2: y[64, N2] += gelu[64, BH] x k2 slice [BH, N2] for this warpgroup's
      // columns, which lie in one piece
#pragma unroll
      for (int p = 0; p < P::SUB; ++p) {
        const uint32_t slot = acquire();
        if ((cs * P::N2) / P::KP == p) {
          const uint64_t db = sm90::sw128_desc(slot + ((cs * P::N2) % P::KP) * 128);
          sm90::wgmma_fence();
#pragma unroll
          for (int k = 0; k < P::BH; k += 16) {
            const uint64_t b = sm90::desc_add(db, (k / 64) * P::KP * 128 + (k % 64) * 2);
            if constexpr (P::CS == 1)
              sm90::wgmma_rs(y, frag[k / 16], b, 1);
            else
              sm90::wgmma_ss(y, sm90::desc_add(sm90::sw128_desc(base + ht),
                                               (k / 64) * 8192 + (k % 64) * 2), b, 1);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(y);
        }
        release();
      }
    }

    // + b2, + x, round once; a lane writes two neighbouring columns at a time
#pragma unroll
    for (int j = 0; j < P::N2 / 8; ++j) {
      const int col = cs * P::N2 + 8 * j + ec;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int g = row0 + rg * 64 + er + 8 * hi;
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

// A row-major bf16 [outer, inner] matrix in boxes of [box_outer, 64], 128-byte swizzled.
bool weight_map(CUtensorMap* map, const void* ptr, int inner, int outer, int box_outer) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * sizeof(bf16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (!weight_map(&tm1, k1, C, 4 * C, P::BH) || !weight_map(&tm2, k2, 4 * C, C, P::BN2))
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
// thread} of the bf16 launch for `rows` rows of width c.
template <int C>
int geometry_sm90(int rows, int* g) {
  using P = MlpPlan<C>;
  const int tiles = (rows + P::BM - 1) / P::BM;
  int blocks = 0;
  if (int err = blocks_sm90<C>(tiles, &blocks)) return err;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mlp_bf16_sm90_kernel<C>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[9] = {P::BM, 1, blocks, tiles, P::STAGES, P::SMEM, P::THREADS, attr.numRegs,
                    static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 9; ++i) g[i] = v[i];
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
// LayerNorm parameters and biases are float32. c is 96, 192, 384 or 768;
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
  switch (c) {
    SWIN_MLP_CASE(96)
    SWIN_MLP_CASE(192)
    SWIN_MLP_CASE(384)
    SWIN_MLP_CASE(768)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_MLP_CASE
}

// The bf16 launch geometry for `rows` rows of width c into g[0..9): rows a
// tile, cluster size, blocks, tiles, ring stages, dynamic shared memory
// bytes, threads a block, registers a thread, local (spill) bytes a thread.
extern "C" int swin_mlp_geometry(int c, int rows, int* g) {
  switch (c) {
    case 96: return geometry_sm90<96>(rows, g);
    case 192: return geometry_sm90<192>(rows, g);
    case 384: return geometry_sm90<384>(rows, g);
    case 768: return geometry_sm90<768>(rows, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
