// A whole Swin block on windowed PRE-norm rows, in one call (one launch at
// C <= 384, six at C = 768):
//
//     h = x + attention(LN1(x) * rowmask  Wqkv^T + bqkv) Wproj^T + bproj
//     y = h + fc2(gelu_erf(fc1(LN2(h))))                  x, y: [B*nW, 49, C]
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/swin_block.py::
// swin_block_fused (_kernel). rowmask [nW, 49] float32 is 0 on the tokens the
// caller's padding added (null when it added none): the block pads after
// norm1, so such a token enters the attention as 0, its qkv is bqkv, and it
// attends and is attended to like any other; its output row is computed and
// the caller crops it. Window w uses row w % nW of rowmask and of the region
// ids.
//
// Rounding places (T is float or bf16), as in the JAX kernel: LN1 in float32
// (eps 1e-5), times rowmask, rounded to T; qkv accumulates in float32, + bqkv,
// rounded; q * scale rounded (the scale rounded first); scores, bias and the
// -100 region fill in float32, the softmax rounded, p v accumulated in float32
// and rounded once per head; proj accumulates in float32 and h = x + proj +
// bproj stays float32. LN2 of that float32 h, rounded to T; fc1 accumulates
// in float32, + b1 and gelu (erff) in float32, rounded to T once; fc2
// accumulates in float32, h + fc2 + b2 in float32, rounded to T once. Weights
// are in T in nn.Linear's [out, in] layout; LayerNorm parameters and the four
// bias vectors float32.
//
// The bound is operations, 24 C^2 + 4 * 49 C a row (0.072-0.102 ms at 989
// TFLOP/s at the four stages of swin_tiny at 544, batch 16), against 4 C bytes
// of rows. Two bf16 forms, chosen at compile time by width (swin_block()):
// tiles of windows in one launch (C = 96, 192, 384), flat rows in six
// (C = 768).
//
// Tiled (C = 96, 192, 384), for the H100 (sm_90a):
// - A block takes a tile of G consecutive windows; CS warpgroups share a
//   window, each taking 1 / CS of every product's columns. Each window has
//   its own shared memory: the LN tile [64, C] (128-byte swizzled), the
//   attention-output tile, q / k / v tiles of 64-byte rows (two sets where
//   CS = 2, so that head h's attention, on warpgroup h % 2, runs beside the
//   other warpgroup's next qkv product), h [49, C] float32 over the last two
//   once they are free, and where CS = 2 the gelu tile fc2 reads. The windows
//   of a tile meet only in the ring: no block-wide barrier. Blocks are
//   persistent, one a multiprocessor (ops/swin_block.py::kernel_geometry),
//   and walk the tiles in a fixed order: no atomics, the same bits every run.
//     C    G  CS  threads  ring        qkv / fc1 k-blocks a use  shared memory
//     96   3  1   384      3 x 24 KB   2 / 2                     209968 B
//     192  2  1   256      4 x 24 KB   1 / 3                     224256 B
//     384  1  2   256      4 x 24 KB   2 / 3                     232448 B
// - All four products on wgmma (m64nNk16, bf16 in, float32 accumulators, A
//   from the swizzled tiles of sm90.cuh): qkv head by head (one [C, 96] slice
//   gives the head's q | k | v), proj, and over 64-unit hidden chunks fc1 and
//   fc2; with CS = 1 the fc1 accumulators (+ b1, gelu, rounded) are fc2's A
//   operand in registers. Each accumulator is set to zero just before its
//   product: left undefined, ptxas keeps it live from the kernel's entry and,
//   at C >= 192, runs out of registers and serialises every wgmma.
// - Weight slices by TMA (sm90::map_sw128, tensor maps encoded per launch)
//   through a ring with full and empty mbarriers; a use carries 1-3 k-blocks
//   of one product for all of a tile's windows (a head's q | k | v rows, a
//   chunk's k1 rows, a 96-column piece of every warpgroup's proj or k2 rows):
//   each use costs a round trip through the ring, so fewer, larger uses pay.
//   Thread 0 keeps the next uses in flight; a warp releases a use once the
//   product after it has waited for it (wgmma_wait<1>, releases predicated,
//   not branched, so that no product in flight meets a divergent path).
//   Weight reads from L2 at stage 0: 0.47 GB a launch (one block a window:
//   1.42 GB).
// - Attention per (window, head) on mma.sync, window_attention.cu's scheme:
//   warp r owns query rows 16 r .. 16 r + 15, keys 49-63 are -inf, p stays in
//   registers as p v's A operand, region ids compared through shuffles, the
//   head's bias loaded into registers under the qkv product. Rows 49-63 of
//   the q / k / v tiles are written as zeros, so 0 * v never meets a stale
//   inf; the products' output rows 49-63 are never stored.
// - What bounds it (clock64 phase counters of warpgroup 0 in a throwaway
//   build, NVIDIA H100 80GB HBM3 at 700 W; PERF.md): at C = 96 the CUDA-core
//   work (gelu's erff 30% of a warpgroup's time, the two LayerNorms 17%,
//   attention 11%; the products 27%); at C = 192 and 384 the ring's round
//   trips (fc1 25% and 38%, qkv 15% and 19%: 1500-3300 cycles a use, against
//   a few hundred of tensor-core work in it). 49 live rows fill each 64-row
//   product (77%); at C = 384, 400 tiles take 4 rounds on 132 SMs.
//
// Flat rows (C = 768; the same TPU kernel, swin_block_fused, at stage 3 of
// Swin-T), six launches on the rows taken as one [R = 49 bnw, C] matrix, in
// stream order, through a scratch buffer (FlatScratch):
// - Why not tiles of windows: a window's proj and fc2 accumulators ([64,
//   768] float32), its LN and attention-output tiles (2 x 84 KB) and a
//   weight ring exceed both the registers and the 227 KB of shared memory;
//   and a body that holds one window a block streams all 4 C^2 weights (14 MB)
//   through every block, 2 GB of L2 reads a launch at stage 3 for 101 GFLOP
//   (that body, which this form replaces: 2.09 ms, 48 TFLOP/s). Here every
//   weight slice a tile loads serves 128 rows, not 49 live of 64, and the
//   flat rows need no padding rows (7056 = 55.1 tiles of 128).
// - LN1 (swin_block_ln1_kernel): a warp a row, float32 statistics, times the
//   token's rowmask, rounded, into the LayerNorm rows; once, since the
//   attention reads its input once a head.
// - Attention (swin_block_heads_kernel): attn_block.cu's phase 1
//   (swin_tiled.cuh::attend_heads) on the LayerNorm rows: a block a (head,
//   chunk of windows), the head's 96 q | k | v rows of wqkv resident, rows by
//   TMA, q | k | v on wgmma, attention on mma.sync, the head's 32 output
//   columns rounded once.
// - proj (swin_block_proj_kernel), fc1 (swin_block_fc1_kernel) and fc2
//   (swin_block_fc2_kernel): one persistent wgmma product (flat_gemm) over
//   tiles of 128 rows by BN columns, both operands by TMA through a ring of
//   64-wide k-blocks (GemmShape), with the epilogue of each: h = x + acc +
//   bproj in float32 into the scratch; gelu(acc + b1) in float32 (erff),
//   rounded once, into the hidden rows [R, 4 C]; h + acc + b2, rounded once,
//   into out. Between proj and fc1, LN2 (swin_block_ln2_kernel) of the
//   float32 h, rounded, into the LayerNorm rows. Fixed tile orders, no
//   atomics: the same bits every run. The hidden rows' round trip (87 MB at
//   stage 3, mostly in the 50 MB L2) costs less than the weight re-reads of
//   a fused row-tile MLP at this width (kernel 4 at C = 768: 0.4172 ms).
//     launch     threads  grid                 shared memory
//     LN1, LN2   256      rows / 8             none
//     attention  256      heads x (SMs/heads)  230536 B
//     proj, fc2  256      1 a multiprocessor   BN 192, 4 slots: 164928 B
//     fc1        256      2 a multiprocessor   BN 128, 3 slots:  99376 B
//   fc1 runs two blocks a multiprocessor so that gelu's erff in one block's
//   epilogue runs under the other's products. The grids are the caller's
//   (ops/swin_block.py::kernel_geometry, passed in `grids`); each launch
//   walks its rows, windows or tiles with its grid as the stride, so any
//   grid in range covers them all. The tile shapes are compiled here, and
//   swin_block_attributes reports them for the caller to hold its copy to.
// - What bounds it (stage 3, [144, 49, 768], NVIDIA H100 80GB HBM3 at 700 W;
//   chip_smoke.py phase 3 and probes/h100_swin_block/variants.py, PERF.md):
//   0.34-0.37 ms device against the window body's 2.09 and the bound's
//   0.102. The
//   attention takes a third (0.125 ms: attn_block's phase 1 as it is,
//   latency-bound on its x-row ring and the mma.sync attention); fc1 0.114,
//   of which the gelu epilogue ~0.025 and the stores ~0.027 (0.089 without
//   the gelu, 0.062 storing nothing; erff beats the JAX kernel's rational
//   erf, whose rcp and exp load the special-function unit: 0.120); fc2
//   0.077, its operands' L2 traffic (437 MB at 128 x 192 tiles, ~5.7 TB/s);
//   proj 0.027, LN1 0.017, LN2 0.011.
//
// float32: one block of 256 threads a window on the CUDA cores, sums in index
// order, no TF32, so that a float32 run on the card can be held to a CPU run;
// `out` doubles as the scratch for the attention output and for h.
#include <initializer_list>

#include "sm90.cuh"
#include "swin_common.cuh"
#include "swin_tiled.cuh"

namespace {

using namespace swin;

// ------------------------------------------------ bf16, Hopper (wgmma) -----

// Per width: G windows a tile, CS warpgroups a window (each takes 1 / CS of
// every product's columns), STAGES ring slots, KQ and K1 k-blocks a use of
// the qkv and the fc1 product.
template <int G_, int CS_, int STAGES_, int KQ_, int K1_> struct BlockShapeOf {
  static constexpr int G = G_, CS = CS_, STAGES = STAGES_, KQ = KQ_, K1 = K1_;
};
template <int C> struct BlockShape;
template <> struct BlockShape<96> : BlockShapeOf<3, 1, 3, 2, 2> {};
template <> struct BlockShape<192> : BlockShapeOf<2, 1, 4, 1, 3> {};
template <> struct BlockShape<384> : BlockShapeOf<1, 2, 4, 2, 3> {};

template <int C> struct BlockPlan {
  static constexpr int G = BlockShape<C>::G, CS = BlockShape<C>::CS;
  static constexpr int STAGES = BlockShape<C>::STAGES;
  static constexpr int KQ = BlockShape<C>::KQ, K1 = BlockShape<C>::K1;
  static constexpr int THREADS = G * CS * 128;
  static constexpr int HEADS = C / HD;
  static constexpr int KB = (C + 63) / 64;           // 64-wide k-blocks over C
  static constexpr int BH = 64;                      // hidden units a chunk
  static constexpr int CHUNKS = 4 * C / BH;
  static constexpr int NQ = 96 / CS;                 // q | k | v columns of a warpgroup
  static constexpr int N1 = BH / CS;                 // fc1 columns of a warpgroup
  static constexpr int N2 = C / CS;                  // proj / fc2 columns of a warpgroup
  static constexpr int NP = N2 / 96;                 // ... in pieces of 96
  // A use of the ring holds 64-wide k-blocks of one product for all CS
  // warpgroups: KQ of a head's q | k | v rows of wqkv (96), one of piece q of
  // every warpgroup's proj or fc2 columns (CS x 96), or K1 of a chunk's k1
  // rows (64).
  static constexpr int SLOT = cmax(cmax(96 * KQ, 64 * K1), CS * 96) * 128;
  static constexpr int PIECE_BYTES = CS * 96 * 128, K1_BYTES = BH * 128;
  // uses a tile, in order: per head UQ; proj KB x NP; per chunk U1 (fc1)
  // then NP (fc2)
  static constexpr int UQ = KB / KQ, U1 = KB / K1;
  static constexpr int U_QKV = HEADS * UQ, U_PROJ = KB * NP, U_CHUNK = U1 + NP;
  static constexpr int USES = U_QKV + U_PROJ + CHUNKS * U_CHUNK;
  static constexpr int TB = 64 * 128;                // one k-block of the LN / attn-out tiles
  static constexpr int QT = 64 * 64;                 // one of the q, k, v tiles
  // a window's shared memory, bytes: the LN tile, the attention-output tile
  // and QB sets of q, k, v tiles with h [49, C] float32 over them, and where
  // CS > 1 the gelu tile [64, BH] that fc2 reads. With CS > 1 head h's q, k,
  // v go to set h % 2 and its attention to warpgroup h % CS, so that one
  // warpgroup's attention runs beside the other's next qkv product.
  static constexpr int QB = CS > 1 ? 2 : 1;
  static constexpr int LN = 0;
  static constexpr int AO = LN + KB * TB;
  static constexpr int QKV = AO + KB * TB;
  static constexpr int USED = cmax(QKV + QB * 3 * QT, AO + N * C * 4);
  static constexpr int GT = align1k(USED);
  static constexpr int WIN_BYTES = GT + (CS > 1 ? BH * 128 : 0);
  static constexpr int RING = G * WIN_BYTES;
  // the ring's barriers, full[STAGES] then empty[STAGES]: in window 0's unused
  // tail where it has room for them, else after the ring
  static constexpr bool BAR_IN_TAIL = GT - USED >= 2 * STAGES * 8;
  static constexpr int BAR = BAR_IN_TAIL ? USED : RING + STAGES * SLOT;
  static constexpr int SMEM =
      (BAR_IN_TAIL ? RING + STAGES * SLOT : BAR + 2 * STAGES * 8) + 1024;   // + aligning the base
  static_assert(C % 96 == 0 && N2 % 96 == 0 && NQ % 8 == 0 && N1 % 8 == 0, "pieces");
  static_assert(STAGES >= 3 && KB % KQ == 0 && KB % K1 == 0, "ring");
  static_assert(SMEM <= 232448, "shared memory");
};

// V consecutive elements of T from src (8-byte aligned), as float32.
template <typename T, int V>
__device__ __forceinline__ void load_run(const T* src, float (&v)[V]);
template <int V>
__device__ __forceinline__ void load_run(const bf16* src, float (&v)[V]) {
  static_assert(V % 4 == 0, "runs of 4");
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = b.x;
    v[i + 3] = b.y;
  }
}
template <int V>
__device__ __forceinline__ void load_run(const float* src, float (&v)[V]) {
  static_assert(V % 4 == 0, "runs of 4");
#pragma unroll
  for (int i = 0; i < V; i += 4) {
    const float4 u = *reinterpret_cast<const float4*>(src + i);
    v[i] = u.x;
    v[i + 1] = u.y;
    v[i + 2] = u.z;
    v[i + 3] = u.w;
  }
}

// The warps of one window (NW of them, the window's warp wl): LayerNorm of
// the window's 49 rows of src (row stride C), times mul(r), rounded to bf16
// into row r of a swizzled tile of 64-wide blocks TB bytes apart. A warp
// takes SUB rows at once, L = 32 / SUB lanes a row and V = 12 consecutive
// elements a lane (one vector load run), so that a row's sums need log2 L
// shuffles; it loads two passes before it reduces either. Statistics in
// float32 as layer_norm_row computes them (mean, then the mean square of
// the differences), summed in another order.
template <typename TIn, int C, int NW, typename Mul>
__device__ __forceinline__ void ln_window(const TIn* src, const float* __restrict__ lns,
                                          const float* __restrict__ lnb, Mul mul,
                                          unsigned char* tile, int wl) {
  constexpr int V = 12, L = C / V, SUB = 32 / L;
  constexpr int STEP = NW * SUB, PASSES = (N + STEP - 1) / STEP, RB = 2;
  constexpr int TB = 64 * 128;
  static_assert(C % V == 0 && 32 % L == 0 && (L & (L - 1)) == 0, "lanes a row");
  const int lane = threadIdx.x % 32, c0 = (lane % L) * V;
  float gs[V], gb[V];                             // this lane's LayerNorm parameters
#pragma unroll
  for (int i = 0; i < V; ++i) {
    gs[i] = lns[c0 + i];
    gb[i] = lnb[c0 + i];
  }
#pragma unroll 1
  for (int p0 = 0; p0 < PASSES; p0 += RB) {
    float v[RB][V];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = (p0 + k) * STEP + wl * SUB + lane / L;
      if (r < N) {
        load_run(src + r * C + c0, v[k]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = 0.0f;
      }
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = (p0 + k) * STEP + wl * SUB + lane / L;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) sum += v[k][i];
#pragma unroll
      for (int o = L / 2; o > 0; o /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float mu = sum / C;
      float sq = 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        v[k][i] -= mu;
        sq += v[k][i] * v[k][i];
      }
#pragma unroll
      for (int o = L / 2; o > 0; o /= 2) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      const float inv = 1.0f / sqrtf(sq / C + LN_EPS);
      const float m = mul(r);
      if (r < N) {
#pragma unroll
        for (int i = 0; i < V; i += 2) {
          const int c = c0 + i;
          *reinterpret_cast<uint32_t*>(tile + (c / 64) * TB + sm90::sw128_offset(r, c % 64)) =
              pack_bf16((v[k][i] * inv * gs[i] + gb[i]) * m,
                        (v[k][i + 1] * inv * gs[i + 1] + gb[i + 1]) * m);
        }
      }
    }
  }
}

// A persistent block walks tiles blockIdx.x, + gridDim.x, ... of G windows;
// the CS warpgroups g CS .. g CS + CS - 1 take window g of a tile, in its own
// shared memory, and meet the other windows' warpgroups only in the ring:
// every warp consumes all BlockPlan<C>::USES weight slices of a tile (use u
// lies in slot u % STAGES), and thread 0 refills a slot, STAGES - 1 uses
// ahead, once every warp has released it. Warpgroups without a window (the
// last tile) run the products on what their tiles hold and store nothing.
template <int C>
__global__ void __launch_bounds__(BlockPlan<C>::THREADS, 1)
swin_block_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tm_qkv,
                            const __grid_constant__ CUtensorMap tm_proj,
                            const __grid_constant__ CUtensorMap tm_k1,
                            const __grid_constant__ CUtensorMap tm_k2,
                            const bf16* __restrict__ x, const float* __restrict__ rowmask,
                            const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                            const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                            const int* __restrict__ region, const float* __restrict__ bproj,
                            const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                            const float* __restrict__ b1, const float* __restrict__ b2,
                            bf16* __restrict__ out, int bnw, int nw) {
  using P = BlockPlan<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::STAGES;
  const int tiles = (bnw + P::G - 1) / P::G;
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
      if (blockIdx.x + (issued / P::USES) * gridDim.x >= tiles) return;
      const int s = issued % P::STAGES;
      sm90::mbar_wait(empty + s, ((issued / P::STAGES) & 1) ^ 1);
      const uint32_t dst = base + P::RING + s * P::SLOT;
      int e = issued % P::USES;
      if (e < P::U_QKV) {               // head e / UQ: its q, k, v rows, KQ k-blocks
        const int h = e / P::UQ, k0 = (e % P::UQ) * P::KQ * 64;
        sm90::mbar_expect_tx(full + s, P::KQ * 96 * 128);
        for (int u = 0; u < P::KQ; ++u)
          for (int j = 0; j < 3; ++j)
            sm90::tma_load_2d(dst + (u * 3 + j) * HD * 128, &tm_qkv, k0 + u * 64,
                              j * C + h * HD, full + s);
        continue;
      }
      e -= P::U_QKV;
      if (e < P::U_PROJ) {              // proj: k-block e / NP, piece e % NP of each warpgroup
        sm90::mbar_expect_tx(full + s, P::PIECE_BYTES);
        for (int c = 0; c < P::CS; ++c)
          sm90::tma_load_2d(dst + c * 96 * 128, &tm_proj, (e / P::NP) * 64,
                            c * P::N2 + (e % P::NP) * 96, full + s);
        continue;
      }
      e -= P::U_PROJ;
      const int h0 = (e / P::U_CHUNK) * P::BH, r = e % P::U_CHUNK;
      if (r < P::U1) {                  // fc1: K1 k-blocks of the chunk's k1 rows
        sm90::mbar_expect_tx(full + s, P::K1 * P::K1_BYTES);
        for (int u = 0; u < P::K1; ++u)
          sm90::tma_load_2d(dst + u * P::K1_BYTES, &tm_k1, (r * P::K1 + u) * 64, h0, full + s);
      } else {                          // fc2: piece r - U1 of each warpgroup's k2 rows
        sm90::mbar_expect_tx(full + s, P::PIECE_BYTES);
        for (int c = 0; c < P::CS; ++c)
          sm90::tma_load_2d(dst + c * 96 * 128, &tm_k2, h0, c * P::N2 + (r - P::U1) * 96,
                            full + s);
      }
    }
  };

  const int wg = threadIdx.x / 128, g = wg / P::CS, cs = wg % P::CS;
  const int warp = threadIdx.x / 32, wq = warp % 4, wl = warp % (4 * P::CS);
  const int lane = threadIdx.x % 32;
  const int er = 16 * wq + lane / 4, ec = 2 * (lane % 4);    // accumulator row and column
  unsigned char* my = smem + g * P::WIN_BYTES;               // this window's tiles
  const uint32_t mine = base + g * P::WIN_BYTES;
  const uint64_t da_ln = sm90::sw128_desc(mine + P::LN);
  const uint64_t da_ao = sm90::sw128_desc(mine + P::AO);
  float* hw = reinterpret_cast<float*>(my + P::AO);          // h [49, C], over AO and q, k, v
  const float scale = round_to<bf16>(QK_SCALE);
  // the window's warpgroups meet here
  auto sync_wg = [g] { sm90::named_barrier(1 + g, 128 * P::CS); };
  RingReader<P::STAGES, P::SLOT> ring{full, empty, base + P::RING};

  if (threadIdx.x == 0) issue_upto(P::STAGES - 1);  // the first slices land under LN1
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int w = t * P::G + g;
    const bool has = w < bnw;
    const bf16* xw = x + static_cast<size_t>(has ? w : 0) * N * C;
    sync_wg();                          // this warpgroup's last tile is done with its tiles

    // LN1 * rowmask into the LN tile (rows 49-63 are never stored: their
    // output rows are not either); the window's region ids, token j in lane
    // j % 32 of rl (j < 32) or rh
    int rl = 0, rh = 0;
    if (has) {
      // the window's rowmask: token j's in lane j % 32 of rm0 (j < 32) or rm1
      float rm0 = 1.0f, rm1 = 1.0f;
      if (rowmask != nullptr) {
        const float* rm = rowmask + static_cast<size_t>(w % nw) * N;
        rm0 = rm[lane];
        rm1 = lane < N - 32 ? rm[32 + lane] : 1.0f;
      }
      ln_window<bf16, C, 4 * P::CS>(
          xw, ln1s, ln1b,
          [&](int r) {          // r differs between a warp's lanes: two shuffles
            const float lo = __shfl_sync(0xffffffffu, rm0, r % 32);
            const float hi = __shfl_sync(0xffffffffu, rm1, r % 32);
            return r < 32 ? lo : hi;
          },
          my + P::LN, wl);
      if (region != nullptr) {
        const int* rr = region + static_cast<size_t>(w % nw) * N;
        rl = rr[lane];
        rh = lane < N - 32 ? rr[32 + lane] : 0;
      }
    }
    sm90::fence_proxy_async();
    sync_wg();

    for (int h = 0; h < P::HEADS; ++h) {
      // q | k | v of head h, this warpgroup's NQ of the 96 columns:
      // [64, C] x [C, NQ]
      float acc[P::NQ / 2];
#pragma unroll
      for (int z = 0; z < P::NQ / 2; ++z) acc[z] = 0.0f;
      const bool attends = h % P::CS == cs;      // this warpgroup takes head h's attention
      unsigned char* qkv = my + P::QKV + (h % P::QB) * 3 * P::QT;
      uint32_t bz[7][2];                // the head's bias, loaded under the product
      if (attends) head_bias(bias + static_cast<size_t>(h) * N * N, wq, bz);
#pragma unroll
      for (int ku = 0; ku < P::UQ; ++ku) {
        const uint32_t slot = ring.acquire(issue_upto);
        sm90::wgmma_fence();
#pragma unroll
        for (int u = 0; u < P::KQ; ++u) {
          const int kb = ku * P::KQ + u;
          const uint64_t db = sm90::sw128_desc(slot + (u * 96 + cs * P::NQ) * 128);
#pragma unroll
          for (int k = 0; k < 64; k += 16)
            if (kb * 64 + k < C)
              sm90::wgmma_ss(acc, sm90::desc_add(da_ln, kb * P::TB + k * 2),
                             sm90::desc_add(db, k * 2), kb > 0 || k > 0);
        }
        ring.retire();
      }
      ring.drain();
      sm90::fence_regs(acc);
      // one set: the last head's attention must be done with it (two: the
      // barrier after the last head's epilogue saw the attention before that)
      if constexpr (P::QB == 1) sync_wg();
      // + bqkv, rounded; q * scale rounded; rows past the window zero
      store_qkv<C, P::NQ>(acc, bqkv, h, cs * P::NQ, scale, qkv, er, ec);
      sync_wg();
      if (has && attends)
        attend_rows(qkv, P::QT, 0, wq, bz, region != nullptr ? region_differ(wq, rl, rh) : 0u,
                    my + P::AO, P::TB, h * HD);
    }
    sm90::fence_proxy_async();
    sync_wg();                          // the attention-output tile is whole

    // proj: [64, C] x [C, N2] for this warpgroup's columns, in pieces of 96
    float pacc[P::NP][48];
#pragma unroll
    for (int z = 0; z < (P::NP) * 48; ++z) (&pacc[0][0])[z] = 0.0f;
#pragma unroll
    for (int kb = 0; kb < P::KB; ++kb) {
#pragma unroll
      for (int p = 0; p < P::NP; ++p) {
        const uint64_t db = sm90::sw128_desc(ring.acquire(issue_upto) + cs * 96 * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 64; k += 16)
          if (kb * 64 + k < C)
            sm90::wgmma_ss(pacc[p], sm90::desc_add(da_ao, kb * P::TB + k * 2),
                           sm90::desc_add(db, k * 2), kb > 0 || k > 0);
        ring.retire();
      }
    }
    ring.drain();
#pragma unroll
    for (int p = 0; p < P::NP; ++p) sm90::fence_regs(pacc[p]);
    sync_wg();                          // every product is done with the attention output
    // h = x + proj + bproj, float32
    if (has) {
#pragma unroll
      for (int p = 0; p < P::NP; ++p)
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int col = cs * P::N2 + p * 96 + 8 * j + ec;
          const float2 b = *reinterpret_cast<const float2*>(bproj + col);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int row = er + 8 * hi;
            if (row < N) {
              const float2 xv = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(xw + row * C + col));
              *reinterpret_cast<float2*>(hw + row * C + col) =
                  make_float2((xv.x + pacc[p][4 * j + 2 * hi]) + b.x,
                              (xv.y + pacc[p][4 * j + 2 * hi + 1]) + b.y);
            }
          }
        }
    }
    sync_wg();
    // LN2(h) into the LN tile
    if (has) ln_window<float, C, 4 * P::CS>(hw, ln2s, ln2b, [](int) { return 1.0f; }, my + P::LN, wl);
    sm90::fence_proxy_async();
    sync_wg();

    // the MLP: per chunk of BH hidden units, fc1, + b1, gelu, rounded once,
    // and the chunk's share of fc2 into y. The gelu values are fc2's A
    // operand in registers where one warpgroup holds them all (CS = 1), else
    // the window's warpgroups meet in the gelu tile.
    float y[P::NP][48];
#pragma unroll
    for (int p = 0; p < P::NP; ++p)
#pragma unroll
      for (int i = 0; i < 48; ++i) y[p][i] = 0.0f;
    for (int ch = 0; ch < P::CHUNKS; ++ch) {
      const int h0 = ch * P::BH;
      float a1[P::N1 / 2];
#pragma unroll
      for (int z = 0; z < P::N1 / 2; ++z) a1[z] = 0.0f;
#pragma unroll
      for (int ku = 0; ku < P::U1; ++ku) {
        const uint32_t slot = ring.acquire(issue_upto);
        sm90::wgmma_fence();
#pragma unroll
        for (int u = 0; u < P::K1; ++u) {
          const int kb = ku * P::K1 + u;
          const uint64_t db = sm90::sw128_desc(slot + u * P::K1_BYTES + cs * P::N1 * 128);
#pragma unroll
          for (int k = 0; k < 64; k += 16)
            if (kb * 64 + k < C)
              sm90::wgmma_ss(a1, sm90::desc_add(da_ln, kb * P::TB + k * 2),
                             sm90::desc_add(db, k * 2), kb > 0 || k > 0);
        }
        ring.retire();
      }
      ring.drain();
      sm90::fence_regs(a1);
      uint32_t frag[P::BH / 16][4];
      if constexpr (P::CS > 1) sync_wg();       // the last chunk's fc2 is done with the gelu tile
#pragma unroll
      for (int j = 0; j < P::N1 / 8; ++j) {
        const int col = cs * P::N1 + 8 * j + ec;
        const float2 b = *reinterpret_cast<const float2*>(b1 + h0 + col);
        const uint32_t lo = pack_bf16(gelu_erf(a1[4 * j] + b.x), gelu_erf(a1[4 * j + 1] + b.y));
        const uint32_t hi = pack_bf16(gelu_erf(a1[4 * j + 2] + b.x), gelu_erf(a1[4 * j + 3] + b.y));
        if constexpr (P::CS == 1) {
          frag[j / 2][(j % 2) * 2] = lo;
          frag[j / 2][(j % 2) * 2 + 1] = hi;
        } else {
          *reinterpret_cast<uint32_t*>(my + P::GT + sm90::sw128_offset(er, col)) = lo;
          *reinterpret_cast<uint32_t*>(my + P::GT + sm90::sw128_offset(er + 8, col)) = hi;
        }
      }
      if constexpr (P::CS > 1) {
        sm90::fence_proxy_async();
        sync_wg();                              // the whole gelu chunk is written
      }
#pragma unroll
      for (int p = 0; p < P::NP; ++p) {
        const uint64_t db = sm90::sw128_desc(ring.acquire(issue_upto) + cs * 96 * 128);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < P::BH; k += 16) {
          if constexpr (P::CS == 1)
            sm90::wgmma_rs(y[p], frag[k / 16], sm90::desc_add(db, k * 2), 1);
          else
            sm90::wgmma_ss(y[p], sm90::desc_add(sm90::sw128_desc(mine + P::GT), k * 2),
                           sm90::desc_add(db, k * 2), 1);
        }
        ring.retire();
      }
    }
    ring.drain();
#pragma unroll
    for (int p = 0; p < P::NP; ++p) sm90::fence_regs(y[p]);

    // y = h + fc2 + b2, rounded once
    if (has) {
#pragma unroll
      for (int p = 0; p < P::NP; ++p)
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int col = cs * P::N2 + p * 96 + 8 * j + ec;
          const float2 b = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi) {
            const int row = er + 8 * hi;
            if (row < N) {
              const float2 hv = *reinterpret_cast<const float2*>(hw + row * C + col);
              *reinterpret_cast<uint32_t*>(out + (static_cast<size_t>(w) * N + row) * C + col) =
                  pack_bf16((hv.x + y[p][4 * j + 2 * hi]) + b.x,
                            (hv.y + y[p][4 * j + 2 * hi + 1]) + b.y);
            }
          }
        }
    }
  }
}

// -------------------------------------------- bf16, flat rows (C = 768) -----
//
// Six launches on the rows taken as one flat [R = bnw * 49, C] matrix; what
// passes between them lies in the scratch (FlatScratch), the order on the
// stream orders them.

constexpr int FLAT_C = 768;
constexpr int LN_ROWS = 8;              // rows a LayerNorm block, one a warp

// One warp a row of src [rows, C]: LayerNorm in float32 (the mean, then the
// mean square of the differences, as layer_norm_row, summed in another
// order), times the rowmask of the row's token where rowmask is not null
// (row r is token r % 49 of window r / 49, which uses row (r / 49) % nw of
// rowmask), rounded to bf16 into dst. Warp w of block b takes rows
// LN_ROWS b + w, + LN_ROWS gridDim.x, ...; lane l the 16-byte chunks l,
// l + 32, ... of each.
template <typename TIn, int C>
__device__ __forceinline__ void ln_rows(const TIn* __restrict__ src,
                                        const float* __restrict__ rowmask,
                                        const float* __restrict__ lns,
                                        const float* __restrict__ lnb, bf16* __restrict__ dst,
                                        int rows, int nw) {
  constexpr int E = 16 / sizeof(TIn), Q = C / (32 * E);
  static_assert(C % (32 * E) == 0, "whole chunks a lane");
  const int lane = threadIdx.x % 32;
  for (int row = blockIdx.x * LN_ROWS + threadIdx.x / 32; row < rows;
       row += gridDim.x * LN_ROWS) {
    const TIn* s = src + static_cast<size_t>(row) * C;
    float v[Q][E];
    float sum = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      load_run(s + (lane + 32 * q) * E, v[q]);
#pragma unroll
      for (int i = 0; i < E; ++i) sum += v[q][i];
    }
    const float mu = warp_sum(sum) / C;
    float sq = 0.0f;
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int i = 0; i < E; ++i) {
        v[q][i] -= mu;
        sq += v[q][i] * v[q][i];
      }
    const float inv = 1.0f / sqrtf(warp_sum(sq) / C + LN_EPS);
    const float m =
        rowmask == nullptr ? 1.0f : rowmask[static_cast<size_t>((row / N) % nw) * N + row % N];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int c0 = (lane + 32 * q) * E;
      uint32_t pk[E / 2];
#pragma unroll
      for (int i = 0; i < E; i += 2)
        pk[i / 2] = pack_bf16((v[q][i] * inv * lns[c0 + i] + lnb[c0 + i]) * m,
                              (v[q][i + 1] * inv * lns[c0 + i + 1] + lnb[c0 + i + 1]) * m);
      bf16* d = dst + static_cast<size_t>(row) * C + c0;
      if constexpr (E == 8)
        *reinterpret_cast<uint4*>(d) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
      else
        *reinterpret_cast<uint2*>(d) = make_uint2(pk[0], pk[1]);
    }
  }
}

// The three products: A [R, K] bf16 times B^T, B [N, K] as nn.Linear keeps
// it, on wgmma (m64nBNk16). A persistent block of two warpgroups walks
// tiles of BM = 128 rows (64 a warpgroup) by BN columns, tiles blockIdx.x,
// + gridDim.x, ... (row tile t / NT, column tile t % NT), in a fixed order:
// no atomics, the same bits every run. Each 64-wide k-block is one use of a
// ring of STAGES slots, A's 128 x 64 and B's BN x 64 by TMA (rows past R
// arrive as zeros and are never stored); thread 0 keeps STAGES - 1 uses in
// flight across tiles, so the next tile's first k-blocks land under this
// one's epilogue. PER_SM blocks share a multiprocessor, so that one's
// epilogue runs under another's products.
template <int BN_, int STAGES_, int PER_SM_> struct GemmShapeOf {
  static constexpr int BN = BN_, STAGES = STAGES_, PER_SM = PER_SM_;
};
// proj and fc2: BN = 192, four slots, one block a multiprocessor; fc1: two
// blocks a multiprocessor (BN = 128, three slots each), so that gelu's erff
// in one block's epilogue runs under the other's products.
template <int K, int N> struct GemmShape : GemmShapeOf<192, 4, 1> {};
template <> struct GemmShape<FLAT_C, 4 * FLAT_C> : GemmShapeOf<128, 3, 2> {};

template <int K, int N> struct FlatGemm {
  static constexpr int BM = 128, BN = GemmShape<K, N>::BN, THREADS = 256;
  static constexpr int STAGES = GemmShape<K, N>::STAGES, PER_SM = GemmShape<K, N>::PER_SM;
  static constexpr int KB = K / 64, NT = N / BN;
  static constexpr int A_BYTES = BM * 128, SLOT = A_BYTES + BN * 128;
  static constexpr int BAR = STAGES * SLOT;                 // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;  // + aligning the base
  static_assert(K % 64 == 0 && N % BN == 0 && A_BYTES % 1024 == 0 && SLOT % 1024 == 0, "tiles");
  static_assert(STAGES >= 3 && PER_SM * (SMEM + 1024) <= 233472,   // 1 KB of each block reserved
                "ring, shared memory");
};

using ProjGemm = FlatGemm<FLAT_C, FLAT_C>;
using Fc1Gemm = FlatGemm<FLAT_C, 4 * FLAT_C>;
using Fc2Gemm = FlatGemm<4 * FLAT_C, FLAT_C>;

// The product's body; epi(row, col, a0, a1) takes the accumulators of
// columns col, col + 1 of a row below `rows`.
template <int K, int N, typename Epilogue>
__device__ __forceinline__ void flat_gemm(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                                          int rows, Epilogue epi) {
  using P = FlatGemm<K, N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* empty = full + P::STAGES;
  const int tiles = (rows + P::BM - 1) / P::BM * P::NT;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, P::THREADS / 32);  // every warp releases every slot
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();

  // Thread 0: start the copies of every use before `upto`; use v is k-block
  // v % KB of the block's tile v / KB and waits for the release of use
  // v - STAGES.
  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto; ++issued) {
      const int t = blockIdx.x + (issued / P::KB) * gridDim.x;
      if (t >= tiles) return;
      const int s = issued % P::STAGES, k0 = (issued % P::KB) * 64;
      const uint32_t dst = base + s * P::SLOT;
      sm90::mbar_wait(empty + s, ((issued / P::STAGES) & 1) ^ 1);
      sm90::mbar_expect_tx(full + s, P::SLOT);
      sm90::tma_load_2d(dst, &tm_a, k0, (t / P::NT) * P::BM, full + s);
      sm90::tma_load_2d(dst + P::A_BYTES, &tm_b, k0, (t % P::NT) * P::BN, full + s);
    }
  };
  const int wg = threadIdx.x / 128, wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int er = 16 * wq + lane / 4, ec = 2 * (lane % 4);    // accumulator row and column
  RingReader<P::STAGES, P::SLOT> ring{full, empty, base};
  if (threadIdx.x == 0) issue_upto(P::STAGES - 1);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    float acc[P::BN / 2];                 // [64, BN] of wgmma's accumulator layout
#pragma unroll
    for (int z = 0; z < P::BN / 2; ++z) acc[z] = 0.0f;
#pragma unroll 1
    for (int kb = 0; kb < P::KB; ++kb) {
      const uint32_t slot = ring.acquire(issue_upto);
      const uint64_t da = sm90::sw128_desc(slot + wg * 64 * 128);
      const uint64_t db = sm90::sw128_desc(slot + P::A_BYTES);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 64; k += 16)
        sm90::wgmma_ss(acc, sm90::desc_add(da, k * 2), sm90::desc_add(db, k * 2), kb > 0 || k > 0);
      ring.retire();
    }
    ring.drain();
    sm90::fence_regs(acc);
    const int row0 = (t / P::NT) * P::BM + wg * 64 + er, col0 = (t % P::NT) * P::BN + ec;
#pragma unroll
    for (int j = 0; j < P::BN / 8; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = row0 + 8 * hi;
        if (row < rows) epi(row, col0 + 8 * j, acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
      }
  }
}

// LN1(x) * rowmask, rounded, into the scratch's LayerNorm rows.
__global__ void __launch_bounds__(LN_ROWS * 32)
swin_block_ln1_kernel(const bf16* __restrict__ x, const float* __restrict__ rowmask,
                      const float* __restrict__ lns, const float* __restrict__ lnb,
                      bf16* __restrict__ xn, int rows, int nw) {
  ln_rows<bf16, FLAT_C>(x, rowmask, lns, lnb, xn, rows, nw);
}

// The attention of every (window, head): attn_block.cu's phase 1.
__global__ void __launch_bounds__(HeadPlan<FLAT_C>::THREADS, 1)
swin_block_heads_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_qkv,
                        const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                        const int* __restrict__ region, bf16* __restrict__ ao, int bnw, int nw) {
  attend_heads<FLAT_C>(tm_x, tm_qkv, bqkv, bias, region, ao, bnw, nw);
}

// h = x + proj + bproj, float32.
__global__ void __launch_bounds__(ProjGemm::THREADS, ProjGemm::PER_SM)
swin_block_proj_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b, const bf16* __restrict__ x,
                       const float* __restrict__ bproj, float* __restrict__ h, int rows) {
  flat_gemm<FLAT_C, FLAT_C>(tm_a, tm_b, rows, [&](int row, int col, float a0, float a1) {
    const size_t e = static_cast<size_t>(row) * FLAT_C + col;
    const float2 b = *reinterpret_cast<const float2*>(bproj + col);
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + e));
    *reinterpret_cast<float2*>(h + e) = make_float2((xv.x + a0) + b.x, (xv.y + a1) + b.y);
  });
}

// LN2(h), rounded, into the scratch's LayerNorm rows.
__global__ void __launch_bounds__(LN_ROWS * 32)
swin_block_ln2_kernel(const float* __restrict__ h, const float* __restrict__ lns,
                      const float* __restrict__ lnb, bf16* __restrict__ hn, int rows) {
  ln_rows<float, FLAT_C>(h, nullptr, lns, lnb, hn, rows, 1);
}

// u = gelu(fc1 + b1) in float32, rounded once.
__global__ void __launch_bounds__(Fc1Gemm::THREADS, Fc1Gemm::PER_SM)
swin_block_fc1_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ b1,
                      bf16* __restrict__ u, int rows) {
  flat_gemm<FLAT_C, 4 * FLAT_C>(tm_a, tm_b, rows, [&](int row, int col, float a0, float a1) {
    const float2 b = *reinterpret_cast<const float2*>(b1 + col);
    *reinterpret_cast<uint32_t*>(u + static_cast<size_t>(row) * 4 * FLAT_C + col) =
        pack_bf16(gelu_erf(a0 + b.x), gelu_erf(a1 + b.y));
  });
}

// y = h + fc2 + b2 in float32, rounded once.
__global__ void __launch_bounds__(Fc2Gemm::THREADS, Fc2Gemm::PER_SM)
swin_block_fc2_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_b, const float* __restrict__ h,
                      const float* __restrict__ b2, bf16* __restrict__ out, int rows) {
  flat_gemm<4 * FLAT_C, FLAT_C>(tm_a, tm_b, rows, [&](int row, int col, float a0, float a1) {
    const size_t e = static_cast<size_t>(row) * FLAT_C + col;
    const float2 b = *reinterpret_cast<const float2*>(b2 + col);
    const float2 hv = *reinterpret_cast<const float2*>(h + e);
    *reinterpret_cast<uint32_t*>(out + e) = pack_bf16((hv.x + a0) + b.x, (hv.y + a1) + b.y);
  });
}

// The flat form's scratch for `rows` rows, byte offsets from its start: the
// hidden activations u [rows, 4C] bf16, h [rows, C] float32, the attention
// output [rows, C] bf16 and the LayerNorm rows [rows, C] bf16 (LN1's, then
// LN2's); every offset a multiple of 16 bytes (C is).
struct FlatScratch {
  size_t u, h, ao, ln, bytes;
  explicit FlatScratch(size_t rows)
      : u(0), h(rows * 4 * FLAT_C * 2), ao(h + rows * FLAT_C * 4), ln(ao + rows * FLAT_C * 2),
        bytes(ln + rows * FLAT_C * 2) {}
};

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The tiles of a product over `rows` rows.
template <int K, int N>
int gemm_tiles(int rows) {
  using P = FlatGemm<K, N>;
  return (rows + P::BM - 1) / P::BM * P::NT;
}

// The six launches' grids, in the order they run (FLAT_LAUNCHES of
// ops/swin_block.py): LN1, the attention, proj, LN2, fc1, fc2.
enum FlatLaunch {
  LN1_LAUNCH, HEADS_LAUNCH, PROJ_LAUNCH, LN2_LAUNCH, FC1_LAUNCH, FC2_LAUNCH, FLAT_LAUNCHES
};

int launch_flat(const void* x, const float* rowmask, const float* ln1s, const float* ln1b,
                const void* wqkv, const float* bqkv, const void* bias, const int* region,
                const void* wproj, const float* bproj, const float* ln2s, const float* ln2b,
                const void* k1, const float* b1, const void* k2, const float* b2, void* scratch,
                void* out, int bnw, int nw, const int* grids, cudaStream_t stream) {
  constexpr int C = FLAT_C, H = 4 * C;
  using PH = HeadPlan<C>;
  using PP = ProjGemm;
  using P1 = Fc1Gemm;
  using P2 = Fc2Gemm;
  const int rows = bnw * N, ln_most = (rows + LN_ROWS - 1) / LN_ROWS;
  const int in_range[FLAT_LAUNCHES][2] = {
      {1, ln_most}, {PH::HEADS, 1 << 30}, {1, gemm_tiles<C, C>(rows)}, {1, ln_most},
      {1, gemm_tiles<C, H>(rows)}, {1, gemm_tiles<H, C>(rows)}};
  if (scratch == nullptr || grids == nullptr || grids[HEADS_LAUNCH] % PH::HEADS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < FLAT_LAUNCHES; ++i)
    if (grids[i] < in_range[i][0] || grids[i] > in_range[i][1])
      return static_cast<int>(cudaErrorInvalidValue);
  const FlatScratch sc(rows);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  bf16* u = reinterpret_cast<bf16*>(s + sc.u);
  float* h = reinterpret_cast<float*>(s + sc.h);
  bf16* ao = reinterpret_cast<bf16*>(s + sc.ao);
  bf16* ln = reinterpret_cast<bf16*>(s + sc.ln);
  CUtensorMap tx, tq, ta, tp, tl, t1, tu, t2;
  if (!sm90::map_sw128(&tx, ln, C, rows, 64) || !sm90::map_sw128(&tq, wqkv, C, 3 * C, HD) ||
      !sm90::map_sw128(&ta, ao, C, rows, PP::BM) || !sm90::map_sw128(&tp, wproj, C, C, PP::BN) ||
      !sm90::map_sw128(&tl, ln, C, rows, P1::BM) || !sm90::map_sw128(&t1, k1, C, H, P1::BN) ||
      !sm90::map_sw128(&tu, u, H, rows, P2::BM) || !sm90::map_sw128(&t2, k2, H, C, P2::BN))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(swin_block_heads_kernel, PH::SMEM);
  if (err == cudaSuccess) err = allow_smem(swin_block_proj_kernel, PP::SMEM);
  if (err == cudaSuccess) err = allow_smem(swin_block_fc1_kernel, P1::SMEM);
  if (err == cudaSuccess) err = allow_smem(swin_block_fc2_kernel, P2::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* xb = static_cast<const bf16*>(x);
  swin_block_ln1_kernel<<<grids[LN1_LAUNCH], LN_ROWS * 32, 0, stream>>>(xb, rowmask, ln1s, ln1b,
                                                                          ln, rows, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  swin_block_heads_kernel<<<grids[HEADS_LAUNCH], PH::THREADS, PH::SMEM, stream>>>(
      tx, tq, bqkv, static_cast<const bf16*>(bias), region, ao, bnw, nw);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  swin_block_proj_kernel<<<grids[PROJ_LAUNCH], PP::THREADS, PP::SMEM, stream>>>(ta, tp, xb,
                                                                               bproj, h, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  swin_block_ln2_kernel<<<grids[LN2_LAUNCH], LN_ROWS * 32, 0, stream>>>(h, ln2s, ln2b, ln, rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  swin_block_fc1_kernel<<<grids[FC1_LAUNCH], P1::THREADS, P1::SMEM, stream>>>(tl, t1, b1, u,
                                                                              rows);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  swin_block_fc2_kernel<<<grids[FC2_LAUNCH], P2::THREADS, P2::SMEM, stream>>>(
      tu, t2, h, b2, static_cast<bf16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32 -----

template <int C>
__global__ void __launch_bounds__(THREADS)
swin_block_f32_kernel(const float* __restrict__ x, const float* __restrict__ rowmask,
                      const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                      const float* __restrict__ wqkv, const float* __restrict__ bqkv,
                      const float* __restrict__ bias, const int* __restrict__ region,
                      const float* __restrict__ wproj, const float* __restrict__ bproj,
                      const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                      const float* __restrict__ k1, const float* __restrict__ b1,
                      const float* __restrict__ k2, const float* __restrict__ b2,
                      float* out, int nw) {
  using S = WindowSmemF32<C>;
  constexpr int E2 = BM32 * C / THREADS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* sx = smem + S::SX;
  float* sh = smem + S::SH;
  const int w = blockIdx.x, tid = threadIdx.x, warp = tid / 32;
  float* y = out + static_cast<size_t>(w) * N * C;      // attention output, then h, then y
  const float* xw = x + static_cast<size_t>(w) * N * C;

  for (int r = warp; r < N; r += WARPS) {
    const float mul = rowmask == nullptr ? 1.0f : rowmask[static_cast<size_t>(w % nw) * N + r];
    layer_norm_row<float, float, C>(xw + r * C, ln1s, ln1b, mul, sx + r * C);
  }
  window_heads_f32<C>(smem, wqkv, bqkv, bias, region, w, nw, y);
  for (int e = tid; e < N * C; e += THREADS) sx[e] = y[e];
  __syncthreads();
  window_linear_f32<C>(sx, wproj, [&](int r, int n, float acc) {
    y[r * C + n] = (xw[r * C + n] + acc) + bproj[n];
  });
  __syncthreads();                      // h is whole in y; sx is free

  for (int r = warp; r < N; r += WARPS)
    layer_norm_row<float, float, C>(y + r * C, ln2s, ln2b, 1.0f, sx + r * C);
  __syncthreads();
  for (int row0 = 0; row0 < N; row0 += BM32) {
    float acc[E2];
    mlp_hidden_walk_f32<C>(sx + row0 * C, N - 1 - row0, sh, k1, b1, k2, acc);
#pragma unroll
    for (int i = 0; i < E2; ++i) {
      const int e = tid + THREADS * i;
      const int r = row0 + e / C, n = e % C;
      if (r < N) y[r * C + n] = (y[r * C + n] + acc[i]) + b2[n];
    }
  }
}


template <int C>
int launch_bf16_sm90(const void* x, const void* rowmask, const void* ln1s, const void* ln1b,
                     const void* wqkv, const void* bqkv, const void* bias, const int* region,
                     const void* wproj, const void* bproj, const void* ln2s, const void* ln2b,
                     const void* k1, const void* b1, const void* k2, const void* b2, void* out,
                     int bnw, int nw, int blocks, cudaStream_t stream) {
  using P = BlockPlan<C>;
  const int tiles = (bnw + P::G - 1) / P::G;
  if (blocks <= 0 || blocks > tiles) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tp, t1, t2;
  if (!sm90::map_sw128(&tq, wqkv, C, 3 * C, HD) || !sm90::map_sw128(&tp, wproj, C, C, 96) ||
      !sm90::map_sw128(&t1, k1, C, 4 * C, P::BH) || !sm90::map_sw128(&t2, k2, 4 * C, C, 96))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto kernel = swin_block_bf16_sm90_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         P::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, P::THREADS, P::SMEM, stream>>>(
      tq, tp, t1, t2, static_cast<const bf16*>(x), f(rowmask), f(ln1s), f(ln1b), f(bqkv),
      static_cast<const bf16*>(bias), region, f(bproj), f(ln2s), f(ln2b), f(b1), f(b2),
      static_cast<bf16*>(out), bnw, nw);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_f32(const void* x, const void* rowmask, const void* ln1s, const void* ln1b,
               const void* wqkv, const void* bqkv, const void* bias, const int* region,
               const void* wproj, const void* bproj, const void* ln2s, const void* ln2b,
               const void* k1, const void* b1, const void* k2, const void* b2, void* out,
               int bnw, int nw, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int smem = WindowSmemF32<C>::END * sizeof(float);
  auto kernel = swin_block_f32_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bnw, THREADS, smem, stream>>>(
      f(x), f(rowmask), f(ln1s), f(ln1b), f(wqkv), f(bqkv), f(bias), region, f(wproj), f(bproj),
      f(ln2s), f(ln2b), f(k1), f(b1), f(k2), f(b2), static_cast<float*>(out), nw);
  return static_cast<int>(cudaGetLastError());
}

// A compiled kernel's shape into g[0..8): threads a block, dynamic shared
// memory bytes a block, registers and local (spill) bytes a thread, then
// the tile shape of its launch (`shape`, zeros after it).
template <typename Kernel>
int attributes(Kernel kernel, int threads, int smem, std::initializer_list<int> shape, int* g) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[4] = {threads, smem, attr.numRegs, static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 8; ++i) g[i] = 0;
  for (int i = 0; i < 4; ++i) g[i] = v[i];
  int i = 4;
  for (int d : shape) g[i++] = d;
  return 0;
}

template <int C>
int attributes_sm90(int* g) {
  using P = BlockPlan<C>;
  return attributes(swin_block_bf16_sm90_kernel<C>, P::THREADS, P::SMEM, {P::G, P::CS, P::STAGES},
                    g);
}

template <int K, int N, typename Kernel>
int attributes_gemm(Kernel kernel, int* g) {
  using P = FlatGemm<K, N>;
  return attributes(kernel, P::THREADS, P::SMEM, {P::BM, P::BN, P::STAGES, P::PER_SM}, g);
}

}  // namespace

// x, out [bnw, 49, c]; rowmask [nw, 49] float32 or null; ln1s, ln1b, ln2s,
// ln2b [c]; wqkv [3c, c]; bqkv [3c]; bias [c / 32, 49, 49]; region [nw, 49]
// int32 or null; wproj [c, c]; bproj [c]; k1 [4c, c]; b1 [4c]; k2 [c, 4c];
// b2 [c]. x, the four weight matrices, bias and out are bf16 when is_bf16 is
// nonzero, else float32; everything else is float32. bf16 at c = 96, 192 and
// 384 runs the tiled kernel on grids[0] blocks, at most one a tile; at c =
// 768 the six launches of the flat form on grids[0..6), in the order
// FlatLaunch lists (the attention's a multiple of the heads), with scratch of
// FlatScratch(bnw * 49).bytes bytes, 16-byte aligned; the grids come from
// ops/swin_block.py::kernel_geometry; float32 takes neither (null). c is 96,
// 192, 384 or 768; any other width, a grid out of range, missing scratch or
// bf16 weights not 16-byte aligned return cudaErrorInvalidValue; the first
// launch refused returns its error and the launches after it do not run.
extern "C" int swin_block(const void* x, const void* rowmask, const void* ln1s,
                          const void* ln1b, const void* wqkv, const void* bqkv,
                          const void* bias, const void* region, const void* wproj,
                          const void* bproj, const void* ln2s, const void* ln2b, const void* k1,
                          const void* b1, const void* k2, const void* b2, void* scratch,
                          void* out, int bnw, int c, int nw, int is_bf16, const int* grids,
                          void* stream) {
  if (bnw <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* reg = static_cast<const int*>(region);
#define SWIN_BLOCK_F32(C)                                                                  \
  launch_f32<C>(x, rowmask, ln1s, ln1b, wqkv, bqkv, bias, reg, wproj, bproj, ln2s, ln2b,  \
                k1, b1, k2, b2, out, bnw, nw, s)
#define SWIN_BLOCK_TILED(C)                                                                \
  case C:                                                                                  \
    return is_bf16 ? launch_bf16_sm90<C>(x, rowmask, ln1s, ln1b, wqkv, bqkv, bias, reg,    \
                                         wproj, bproj, ln2s, ln2b, k1, b1, k2, b2, out,    \
                                         bnw, nw, grids == nullptr ? 0 : grids[0], s)       \
                   : SWIN_BLOCK_F32(C);
  switch (c) {
    SWIN_BLOCK_TILED(96)
    SWIN_BLOCK_TILED(192)
    SWIN_BLOCK_TILED(384)
    case FLAT_C: {
      auto f = [](const void* p) { return static_cast<const float*>(p); };
      return is_bf16 ? launch_flat(x, f(rowmask), f(ln1s), f(ln1b), wqkv, f(bqkv), bias, reg,
                                   wproj, f(bproj), f(ln2s), f(ln2b), k1, f(b1), k2, f(b2),
                                   scratch, out, bnw, nw, grids, s)
                     : SWIN_BLOCK_F32(FLAT_C);
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_BLOCK_TILED
#undef SWIN_BLOCK_F32
}

// The compiled shape of bf16 launch `which` at width c into g[0..8), as
// attributes() lists it. c = 96, 192, 384: which 0, the tiled kernel, shape
// {windows a tile, warpgroups a window, ring slots}. c = 768: which is a
// FlatLaunch; the LayerNorms' shape {rows a block}, the attention's
// {warpgroups a block, x ring slots a warpgroup}, a product's {rows a tile,
// columns a tile, ring slots, blocks a multiprocessor}.
extern "C" int swin_block_attributes(int c, int which, int* g) {
  constexpr int C = FLAT_C;
  if (c != C) {
    if (which != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (c) {
      case 96: return attributes_sm90<96>(g);
      case 192: return attributes_sm90<192>(g);
      case 384: return attributes_sm90<384>(g);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  using PH = HeadPlan<C>;
  switch (which) {
    case LN1_LAUNCH: return attributes(swin_block_ln1_kernel, LN_ROWS * 32, 0, {LN_ROWS}, g);
    case HEADS_LAUNCH:
      return attributes(swin_block_heads_kernel, PH::THREADS, PH::SMEM, {PH::WGN, PH::XS}, g);
    case PROJ_LAUNCH: return attributes_gemm<C, C>(swin_block_proj_kernel, g);
    case LN2_LAUNCH: return attributes(swin_block_ln2_kernel, LN_ROWS * 32, 0, {LN_ROWS}, g);
    case FC1_LAUNCH: return attributes_gemm<C, 4 * C>(swin_block_fc1_kernel, g);
    case FC2_LAUNCH: return attributes_gemm<4 * C, C>(swin_block_fc2_kernel, g);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
