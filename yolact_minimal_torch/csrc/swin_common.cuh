// Device code shared by the four Swin kernels (window_attention.cu,
// swin_mlp.cu, attn_block.cu, swin_block.cu): conversions, LayerNorm of a
// row, the tensor-core tiles (ldmatrix + mma.sync m16n8k16, bf16 operands,
// float32 accumulators), the cp.async weight staging, and the bodies that
// more than one kernel runs: the hidden-unit walk of the MLP half and the
// per-head attention of a 49-token window, each for bf16 on the tensor cores
// (swin_block.cu's one-window body) and for float32 on the CUDA cores (no
// TF32, sums in index order, so that a float32 run on the card can be held
// to a CPU run).
//
// All block-level routines assume THREADS = 256 threads (8 warps).
#pragma once
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace swin {

using bf16 = __nv_bfloat16;

constexpr int N = 49;              // tokens per 7x7 window
constexpr int HD = 32;             // head width
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BH = 64;             // hidden units per MLP chunk
constexpr float LN_EPS = 1e-5f;
constexpr float NEG = -100.0f;     // additive fill for pairs in different regions
constexpr float QK_SCALE = 0.17677669529663687f;    // 32^-0.5

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// A float32 value rounded to T's grid.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One warp: dst[0..C) = (LayerNorm(src[0..C)) * mul) rounded to TOut;
// statistics in float32. src may be memory this kernel wrote earlier.
template <typename TIn, typename TOut, int C>
__device__ __forceinline__ void layer_norm_row(const TIn* src,
                                               const float* __restrict__ lns,
                                               const float* __restrict__ lnb, float mul,
                                               TOut* __restrict__ dst) {
  constexpr int PER_LANE = C / 32;
  const int lane = threadIdx.x % 32;
  float v[PER_LANE];
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    v[i] = to_f<TIn>(src[lane + 32 * i]);
    sum += v[i];
  }
  const float mu = warp_sum(sum) / C;
  float sq = 0.0f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    v[i] -= mu;
    sq += v[i] * v[i];
  }
  const float inv = 1.0f / sqrtf(warp_sum(sq) / C + LN_EPS);
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int c = lane + 32 * i;
    dst[c] = from_f<TOut>((v[i] * inv * lns[c] + lnb[c]) * mul);
  }
}

// LayerNorm of rows row0 .. row0+BM-1 of x into sa[BM][LD] (rounded to T);
// warp w takes rows w, w + 8, ...; rows past `rows` become zeros.
template <typename T, int C, int BM, int LD>
__device__ __forceinline__ void layer_norm_tile(const T* __restrict__ x,
                                                const float* __restrict__ lns,
                                                const float* __restrict__ lnb,
                                                T* __restrict__ sa, int row0, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    const int g = row0 + r;
    T* dst = sa + r * LD;
    if (g >= rows) {
#pragma unroll
      for (int i = 0; i < C / 32; ++i) dst[lane + 32 * i] = from_f<T>(0.0f);
      continue;
    }
    layer_norm_row<T, T, C>(x + static_cast<size_t>(g) * C, lns, lnb, 1.0f, dst);
  }
}

// ------------------------------------------------------ tensor-core tiles ---

// Start the copy of a [ROWS][COLS] bf16 tile (row stride src_ld in device
// memory) into shared rows of stride LD, 16 bytes a copy; the caller waits.
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_tile_async(bf16* __restrict__ dst,
                                                 const bf16* __restrict__ src, int src_ld) {
  constexpr int PER_ROW = COLS / 8;
  for (int e = threadIdx.x; e < ROWS * PER_ROW; e += THREADS) {
    const int r = e / PER_ROW, v = (e % PER_ROW) * 8;
    __pipeline_memcpy_async(dst + r * LD + v, src + static_cast<size_t>(r) * src_ld + v, 16);
  }
  __pipeline_commit();
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8, and gets in r[m] the pair (row lane / 4, columns
// 2 * (lane % 4), + 1) of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same four matrices, each transposed: lane l gets in r[m] the pair
// (rows 2 * (lane % 4), + 1; column lane / 4) of matrix m. With the rows of a
// matrix stored [k][n] (n contiguous), that is the B operand of mma_bf16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d[16x8] += a[16x16] b[16x8], bf16 operands, float32 accumulators. With
// g = lane / 4 and t = lane % 4: a holds (row g | g + 8, k 2t.. | 2t + 8..)
// as a0 = (g, 2t), a1 = (g + 8, 2t), a2 = (g, 2t + 8), a3 = (g + 8, 2t + 8);
// b0 = (k 2t.., column g), b1 = (k 2t + 8.., column g); d0, d1 = (row g,
// columns 2t, 2t + 1), d2, d3 = (row g + 8, the same columns).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: the lower address
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The ldmatrix lane offsets used throughout. A operand (16 rows x 16 k,
// stored [row][k]): lane -> row lane % 16, k offset 8 * (lane / 16). B
// operand, two 8-column tiles of a matrix stored [column][k]: lane -> column
// lane % 8 + 8 * (lane / 16), k offset 8 * ((lane / 8) % 2). Accumulator
// element (d0, d1 | d2, d3): rows lane / 4 | + 8, columns 2 * (lane % 4), + 1
// of an 8-column tile.
__device__ __forceinline__ int lane_a_row() { return (threadIdx.x % 32) % 16; }
__device__ __forceinline__ int lane_a_k() { return ((threadIdx.x % 32) / 16) * 8; }
__device__ __forceinline__ int lane_b_col() {
  const int lane = threadIdx.x % 32;
  return lane % 8 + (lane / 16) * 8;
}
__device__ __forceinline__ int lane_b_k() { return (((threadIdx.x % 32) / 8) % 2) * 8; }

// ------------------------------------------------------------ MLP, bf16 -----

// Shared-memory row strides: rows padded by 16 bytes, so that the 8 rows of
// an ldmatrix fall into 8 different bank groups.
template <int C> struct MlpTiles {
  static constexpr int LDA = C + 8;     // LN(x) rows and k1 slices
  static constexpr int LDH = BH + 8;    // gelu chunks and k2 slices
  // elements of the weight buffer: a k1 slice [BH][LDA], then a k2 slice [C][LDH]
  static constexpr int SW = (C * LDH > BH * LDA) ? C * LDH : BH * LDA;
};

// The walk over the hidden units for BM rows whose normalised values lie in
// shared memory: per chunk of BH units, fc1 on the chunk, + b1, gelu, and at
// once the chunk's share of fc2 into yacc. `a_lane` is this lane's A-operand
// address for k = 0 (its row of the normalised tile + lane_a_k()); sh
// [BM][LDH] and sw [MlpTiles<C>::SW] are scratch. Warp -> rows rt * 16 .. + 15
// of the tile in both products (rt = warp % (BM / 16), wc = warp / (BM / 16));
// fc2 16-column tiles wc * NT + t, t < NT = (C / 16) / (WARPS / (BM / 16)).
// ROUND_FC1: round fc1 + b1 to bf16 before the gelu as well as after it.
// Starts with a __syncthreads(), so the caller's writes of the normalised
// tile need none.
template <int C, int BM, bool ROUND_FC1, int NT>
__device__ __forceinline__ void mlp_hidden_walk(const bf16* a_lane, bf16* sh, bf16* sw,
                                                const bf16* __restrict__ k1,
                                                const float* __restrict__ b1,
                                                const bf16* __restrict__ k2,
                                                float (&yacc)[NT][2][4]) {
  constexpr int H = 4 * C;
  constexpr int LDA = MlpTiles<C>::LDA, LDH = MlpTiles<C>::LDH;
  constexpr int RT = BM / 16;           // row tiles of the block
  constexpr int WPR = WARPS / RT;       // warps sharing one row tile
  constexpr int G1 = RT * (BH / 16) / WARPS;   // fc1 16-column tiles per warp
  static_assert(WARPS % RT == 0 && (C / 16) % WPR == 0 && G1 >= 1, "tile split");
  static_assert(NT == (C / 16) / WPR, "fc2 tiles per warp");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp % RT, wc = warp / RT;
  const int b_col = lane_b_col(), b_k = lane_b_k();
  const int er = rt * 16 + lane / 4, ec = (lane % 4) * 2;
  const bf16* h_lane = sh + (rt * 16 + lane_a_row()) * LDH + lane_a_k();

#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) yacc[t][i / 4][i % 4] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += BH) {
    __syncthreads();                    // the tile is written; the last fc2 is done with sw, sh
    stage_tile_async<BH, C, LDA>(sw, k1 + static_cast<size_t>(h0) * C, C);
    __pipeline_wait_prior(0);
    __syncthreads();

    // fc1 on this chunk: [BM, C] x [C, BH]
    float hacc[G1][2][4];
#pragma unroll
    for (int g = 0; g < G1; ++g)
#pragma unroll
      for (int i = 0; i < 8; ++i) hacc[g][i / 4][i % 4] = 0.0f;
#pragma unroll 4
    for (int kk = 0; kk < C; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_lane + kk);
#pragma unroll
      for (int g = 0; g < G1; ++g) {
        uint32_t b[4];
        ldmatrix_x4(b, sw + ((wc + WPR * g) * 16 + b_col) * LDA + kk + b_k);
        mma_bf16(hacc[g][0], a, b[0], b[1]);
        mma_bf16(hacc[g][1], a, b[2], b[3]);
      }
    }
    __syncthreads();                    // every warp is done with the k1 slice
    stage_tile_async<C, BH, LDH>(sw, k2 + h0, H);

    // + b1, (round,) gelu, round -> sh, while the k2 slice arrives
#pragma unroll
    for (int g = 0; g < G1; ++g)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = (wc + WPR * g) * 16 + half * 8 + ec;
        const float2 bias = *reinterpret_cast<const float2*>(b1 + h0 + col);
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = hacc[g][half][i] + (i % 2 ? bias.y : bias.x);
          if (ROUND_FC1) v[i] = round_to<bf16>(v[i]);
          v[i] = gelu_erf(v[i]);
        }
        *reinterpret_cast<uint32_t*>(sh + er * LDH + col) = pack_bf16(v[0], v[1]);
        *reinterpret_cast<uint32_t*>(sh + (er + 8) * LDH + col) = pack_bf16(v[2], v[3]);
      }
    __pipeline_wait_prior(0);
    __syncthreads();

    // this chunk's share of fc2: [BM, BH] x [BH, C]
#pragma unroll
    for (int kk = 0; kk < BH; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, h_lane + kk);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t b[4];
        ldmatrix_x4(b, sw + ((wc * NT + t) * 16 + b_col) * LDH + kk + b_k);
        mma_bf16(yacc[t][0], a, b[0], b[1]);
        mma_bf16(yacc[t][1], a, b[2], b[3]);
      }
    }
  }
}

// --------------------------------------------------------- MLP, float32 -----

constexpr int BM32 = 32;           // rows per tile of the float32 MLP

// The same walk on the CUDA cores for BM32 rows whose normalised values lie
// in sa (row stride C; tile row r reads row min(r, last_row), so a short tile
// needs no padding rows): y[i] is output e = tid + THREADS * i of the
// [BM32, C] tile, row e / C, column e % C. sh is [BM32][BH] scratch.
template <int C>
__device__ __forceinline__ void mlp_hidden_walk_f32(const float* sa, int last_row, float* sh,
                                                    const float* __restrict__ k1,
                                                    const float* __restrict__ b1,
                                                    const float* __restrict__ k2,
                                                    float (&y)[BM32 * C / THREADS]) {
  constexpr int H = 4 * C;
  constexpr int R1 = BM32 / (THREADS / BH);     // fc1 rows per thread
  constexpr int E2 = BM32 * C / THREADS;        // fc2 outputs per thread
  const int tid = threadIdx.x;
  // fc1: thread -> hidden unit j of the chunk, rows rg, rg + 4, ... (a warp
  // shares its rows, so sa reads are broadcasts).
  const int j = tid % BH, rg = tid / BH;
  // fc2: a warp's 32 outputs lie in one row (C is a multiple of 32).
#pragma unroll
  for (int i = 0; i < E2; ++i) y[i] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += BH) {
    float acc[R1];
#pragma unroll
    for (int i = 0; i < R1; ++i) acc[i] = 0.0f;
    const float* w1 = k1 + static_cast<size_t>(h0 + j) * C;
    for (int c = 0; c < C; c += 4) {
      const float4 w = *reinterpret_cast<const float4*>(w1 + c);
#pragma unroll
      for (int i = 0; i < R1; ++i) {
        const float4 a =
            *reinterpret_cast<const float4*>(sa + min(rg + 4 * i, last_row) * C + c);
        acc[i] += a.x * w.x;
        acc[i] += a.y * w.y;
        acc[i] += a.z * w.z;
        acc[i] += a.w * w.w;
      }
    }
    const float bias1 = b1[h0 + j];
#pragma unroll
    for (int i = 0; i < R1; ++i) sh[(rg + 4 * i) * BH + j] = gelu_erf(acc[i] + bias1);
    __syncthreads();

#pragma unroll
    for (int i = 0; i < E2; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / C, n = e % C;
      const float* w2 = k2 + static_cast<size_t>(n) * H + h0;
      const float* hr = sh + r * BH;
      float a2 = y[i];
#pragma unroll 4
      for (int k = 0; k < BH; k += 4) {
        const float4 w = *reinterpret_cast<const float4*>(w2 + k);
        const float4 a = *reinterpret_cast<const float4*>(hr + k);
        a2 += a.x * w.x;
        a2 += a.y * w.y;
        a2 += a.z * w.z;
        a2 += a.w * w.w;
      }
      y[i] = a2;
    }
    __syncthreads();       // sh is rewritten by the next chunk
  }
}

// ------------------------------------------- attention, on the CUDA cores ---

// One thread, query row i of one (window, head). q (this row, already scaled
// and rounded), sk and sv ([N][HD], 16-byte aligned) hold float32 copies of
// values on T's grid; s[0..N) holds the row's bias and receives the scores in
// place. sreg is the window's region ids or null. The row of p v (float32,
// not yet rounded to T) replaces q.
template <typename T>
__device__ __forceinline__ void attention_row(float* q_row, const float* sk, const float* sv,
                                              float* s, const int* sreg, int i) {
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = q_row[d];
  const bool masked = sreg != nullptr;
  const int my_region = masked ? sreg[i] : 0;

  float row_max = -INFINITY;
#pragma unroll 7
  for (int j = 0; j < N; ++j) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 kk = *reinterpret_cast<const float4*>(sk + j * HD + d);
      acc += q[d] * kk.x;
      acc += q[d + 1] * kk.y;
      acc += q[d + 2] * kk.z;
      acc += q[d + 3] * kk.w;
    }
    acc += s[j];
    if (masked) acc += (sreg[j] != my_region) ? NEG : 0.0f;
    s[j] = acc;
    row_max = fmaxf(row_max, acc);
  }
  float sum = 0.0f;
#pragma unroll 7
  for (int j = 0; j < N; ++j) {
    const float e = expf(s[j] - row_max);
    s[j] = e;
    sum += e;
  }

  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.0f;
#pragma unroll 7
  for (int j = 0; j < N; ++j) {
    const float p = round_to<T>(s[j] / sum);
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 vv = *reinterpret_cast<const float4*>(sv + j * HD + d);
      o[d] += p * vv.x;
      o[d + 1] += p * vv.y;
      o[d + 2] += p * vv.z;
      o[d + 3] += p * vv.w;
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) q_row[d] = o[d];
}

// ---------------------------- one window's attention half, bf16, per block ---
//
// A block holds one window: its 49 rows of the qkv input in sx and of the
// attention output in so, both [N + 1][C + 8] bf16 with row N all zeros. The
// mma row tiles cover 64 rows; a lane whose row is past the window reads the
// zero row, and rows past the window are never stored outside the small
// per-head buffers. Going head by head keeps q, k, v at [64, 32] each, so the
// [49, 3C] qkv is never whole anywhere.

constexpr int GN = 96;             // output columns of one window_gemm96 call
constexpr int GK = 96;             // its k chunk: divides every C
constexpr int LDW = GK + 8;
constexpr int WROWS = 64;          // rows the mma tiles cover
constexpr int LDQ = HD + 8;        // q and k rows
constexpr int LDP = WROWS + 8;     // p rows and v^T rows (k = token)

// Shared memory of one window's attention half in bf16, in bytes from the
// start of the dynamic shared memory; every offset is a multiple of 16.
template <int C> struct WindowSmem {
  static constexpr int LDA = C + 8;
  static constexpr int SX = 0;                                   // bf16 [N + 1][LDA]
  static constexpr int SO = SX + (N + 1) * LDA * 2;              // bf16 [N + 1][LDA]
  static constexpr int SW = SO + (N + 1) * LDA * 2;              // bf16 [2][GN][LDW]
  static constexpr int SQ = SW + 2 * GN * LDW * 2;               // bf16 [WROWS][LDQ]
  static constexpr int SK = SQ + WROWS * LDQ * 2;                // bf16 [WROWS][LDQ]
  static constexpr int SVT = SK + WROWS * LDQ * 2;               // bf16 [HD][LDP]
  static constexpr int SP = SVT + HD * LDP * 2;                  // bf16 [WROWS][LDP]
  static constexpr int STAT = SP + WROWS * LDP * 2;              // float2 [2][WROWS]
  static constexpr int END = STAT + 2 * WROWS * 8;
  static_assert(SO % 16 == 0 && SW % 16 == 0 && SP % 16 == 0 && STAT % 16 == 0, "alignment");
};

// The weight chunks of one window's attention half in the order the block
// consumes them: per head the [96, GK] k-chunks of its q | k | v rows of wqkv,
// then per 96 output columns those of wproj. Chunk i lands in slot i % 2 of
// sw, one chunk ahead of its use, so a copy runs under the products of the
// chunk before it, and a head's first chunk under the attention of the head
// before.
template <int C> struct WeightStream {
  static constexpr int KC = C / GK;                  // k chunks of one product
  static constexpr int QKV = (C / HD) * KC;          // chunks of all heads' qkv
  static constexpr int TOTAL = QKV + (C / GN) * KC;  // + proj
  static_assert(C % GK == 0 && C % GN == 0, "chunks");
  const bf16* wqkv;
  const bf16* wproj;
  bf16* sw;
  int fetched;

  // Start the copy of the next chunk (nothing past the last) and commit, so
  // that every call adds one group for the consumer to count.
  __device__ __forceinline__ void fetch() {
    if (fetched < TOTAL) {
      const bool qkv = fetched < QKV;
      const int c = qkv ? fetched : fetched - QKV;
      const bf16* w = qkv ? wqkv : wproj;
      // staged row r is weight row r0 + (r / 32) * seg + r % 32: a head's q,
      // k and v rows lie C apart, proj's 96 rows follow each other
      const int r0 = (c / KC) * (qkv ? HD : GN), seg = qkv ? C : HD, k0 = (c % KC) * GK;
      bf16* dst = sw + (fetched % 2) * GN * LDW;
      for (int e = threadIdx.x; e < GN * (GK / 8); e += THREADS) {
        const int r = e / (GK / 8), v = (e % (GK / 8)) * 8;
        const int row = r0 + (r / 32) * seg + r % 32;
        __pipeline_memcpy_async(dst + r * LDW + v, w + static_cast<size_t>(row) * C + k0 + v,
                                16);
      }
    }
    __pipeline_commit();
    ++fetched;
  }
};

// This lane's A-operand address in a [N + 1][LD] window buffer, for the row
// tile its warp owns (warp % 4).
template <int LD>
__device__ __forceinline__ const bf16* window_a_lane(const bf16* s) {
  const int row = min(((threadIdx.x / 32) % 4) * 16 + lane_a_row(), N);
  return s + row * LD + lane_a_k();
}

// acc = A[64, C] W^T for the stream's next C / GK chunks (96 weight rows).
// Warp (rt = warp % 4, wc = warp / 4) gets rows rt * 16 .. and the 16-column
// tiles wc * 3 + t of the 96. The stream must be one chunk ahead on entry
// (fetched == consumed + 1) and is so on return. Synchronises before it reads
// A and after its last read of the staged weights.
template <int C>
__device__ __forceinline__ void window_gemm96(const bf16* a_lane, WeightStream<C>& stream,
                                              float (&acc)[3][2][4]) {
  const int wc = threadIdx.x / 128;
  const int b_col = lane_b_col(), b_k = lane_b_k();
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[t][i / 4][i % 4] = 0.0f;
  for (int k0 = 0; k0 < C; k0 += GK) {
    const bf16* sw = stream.sw + ((stream.fetched - 1) % 2) * GN * LDW;
    stream.fetch();                     // the chunk after this one, into the other slot
    __pipeline_wait_prior(1);           // this chunk has landed
    __syncthreads();                    // for every thread; and A is written
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, a_lane + k0 + kk);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        uint32_t b[4];
        ldmatrix_x4(b, sw + ((wc * 3 + t) * 16 + b_col) * LDW + kk + b_k);
        mma_bf16(acc[t][0], a, b[0], b[1]);
        mma_bf16(acc[t][1], a, b[2], b[3]);
      }
    }
    __syncthreads();                    // the slot is free for the chunk after the next
  }
}

// Zero row N of both window buffers and start the weight stream. The caller
// fills rows 0..N-1 of sx.
template <int C>
__device__ __forceinline__ void window_setup(unsigned char* smem, WeightStream<C>& stream,
                                             const bf16* wqkv, const bf16* wproj) {
  using S = WindowSmem<C>;
  stream.wqkv = wqkv;
  stream.wproj = wproj;
  stream.sw = reinterpret_cast<bf16*>(smem + S::SW);
  stream.fetched = 0;
  stream.fetch();
  bf16* sx = reinterpret_cast<bf16*>(smem + S::SX);
  bf16* so = reinterpret_cast<bf16*>(smem + S::SO);
  for (int c = threadIdx.x; c < S::LDA; c += THREADS) {
    sx[N * S::LDA + c] = from_f<bf16>(0.0f);
    so[N * S::LDA + c] = from_f<bf16>(0.0f);
  }
}

// sx rows 0..N-1 hold the window's (normalised) input; on return so rows
// 0..N-1 hold, per head h, softmax(q k^T + bias[h] + mask) v at columns
// h * 32 .. + 31, rounded to bf16. bqkv [3C] float32, bias [heads, N, N]
// bf16, region_row the window's N region ids or null; the stream delivers
// wqkv. The caller synchronises before it reads so (a window_gemm96 call
// does).
//
// The scores never leave the registers: warp (rt = warp % 4, wc = warp / 4)
// holds rows rt * 16 .. of q k^T for the keys wc * 32 .. + 31, adds bias and
// mask there, and takes the row maximum m and the sum l of exp(s - m) over
// its 32 keys. The two warps of a row tile exchange (m, l) through shared
// memory and each scales its exponentials to the row's softmax,
// exp(s - m) * exp(m - M) / (l exp(m - M) + l' exp(m' - M)) with M =
// max(m, m'), which is exp(s - M) / sum up to float32 rounding (__expf: its
// error is far below the bf16 rounding of p).
template <int C>
__device__ __forceinline__ void window_heads_bf16(unsigned char* smem, WeightStream<C>& stream,
                                                  const float* __restrict__ bqkv,
                                                  const bf16* __restrict__ bias,
                                                  const int* __restrict__ region_row) {
  using S = WindowSmem<C>;
  constexpr int LDA = S::LDA;
  const bf16* sx = reinterpret_cast<const bf16*>(smem + S::SX);
  bf16* so = reinterpret_cast<bf16*>(smem + S::SO);
  bf16* sq = reinterpret_cast<bf16*>(smem + S::SQ);
  bf16* sk = reinterpret_cast<bf16*>(smem + S::SK);
  bf16* svt = reinterpret_cast<bf16*>(smem + S::SVT);
  bf16* sp = reinterpret_cast<bf16*>(smem + S::SP);
  float2* stat = reinterpret_cast<float2*>(smem + S::STAT);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rt = warp % 4, wc = warp / 4;
  const int a_row = rt * 16 + lane_a_row(), a_k = lane_a_k();
  const int b_col = lane_b_col(), b_k = lane_b_k();
  const int er = rt * 16 + lane / 4, ec = (lane % 4) * 2;
  const bf16* x_lane = window_a_lane<LDA>(sx);
  const float scale = round_to<bf16>(QK_SCALE);

  // This thread's 16 scores: element (nt, j) is row er + 8 * (j / 2), key
  // wc * 32 + nt * 8 + ec + j % 2. Once per window: which of them lie past the
  // window's keys (dead) and which pair tokens of different regions (differ).
  uint32_t dead = 0, differ = 0;
  {
    int row_region[2] = {0, 0};
    if (region_row != nullptr) {
      row_region[0] = region_row[min(er, N - 1)];
      row_region[1] = region_row[min(er + 8, N - 1)];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = wc * 32 + nt * 8 + ec + j % 2;
        if (key >= N) dead |= 1u << (nt * 4 + j);
        else if (region_row != nullptr && region_row[key] != row_region[j / 2])
          differ |= 1u << (nt * 4 + j);
      }
  }

  for (int h = 0; h < C / HD; ++h) {
    // This head's bias for the 16 scores and the qkv bias of this thread's
    // columns come now, so that the loads run under the product.
    const bf16* hbias = bias + static_cast<size_t>(h) * N * N;
    float bz[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = min(er + 8 * (j / 2), N - 1);
        const int key = min(wc * 32 + nt * 8 + ec + j % 2, N - 1);
        bz[nt][j] = to_f<bf16>(hbias[row * N + key]);
      }
    float2 bq[3][2];
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        bq[t][half] = *reinterpret_cast<const float2*>(
            bqkv + ((wc * 3 + t) / 2) * C + h * HD + ((wc * 3 + t) % 2) * 16 + half * 8 + ec);

    // q | k | v of this head for all rows: [64, C] x [C, 96]
    float acc[3][2][4];
    window_gemm96<C>(x_lane, stream, acc);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const int which = (wc * 3 + t) / 2;           // 0 q, 1 k, 2 v
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = ((wc * 3 + t) % 2) * 16 + half * 8 + ec;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = er + hi * 8;
          float v0 = round_to<bf16>(acc[t][half][hi * 2] + bq[t][half].x);
          float v1 = round_to<bf16>(acc[t][half][hi * 2 + 1] + bq[t][half].y);
          if (which == 0) {
            *reinterpret_cast<uint32_t*>(sq + row * LDQ + d) = pack_bf16(v0 * scale, v1 * scale);
          } else if (which == 1) {
            *reinterpret_cast<uint32_t*>(sk + row * LDQ + d) = pack_bf16(v0, v1);
          } else {
            svt[d * LDP + row] = from_f<bf16>(v0);
            svt[(d + 1) * LDP + row] = from_f<bf16>(v1);
          }
        }
      }
    }
    __syncthreads();

    // q k^T + bias + mask
    float sacc[4][4];
#pragma unroll
    for (int i = 0; i < 16; ++i) sacc[i / 4][i % 4] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sq + a_row * LDQ + kk + a_k);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, sk + (wc * 32 + j * 16 + b_col) * LDQ + kk + b_k);
        mma_bf16(sacc[2 * j], a, b[0], b[1]);
        mma_bf16(sacc[2 * j + 1], a, b[2], b[3]);
      }
    }
    // m, l over this warp's 32 keys for rows er (hi = 0) and er + 8 (hi = 1):
    // in the thread, then across the four lanes that share a row
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t bit = 1u << (nt * 4 + j);
        float sc = sacc[nt][j] + bz[nt][j];
        sc += (differ & bit) ? NEG : 0.0f;
        sc = (dead & bit) ? -INFINITY : sc;
        sacc[nt][j] = sc;
        m[j / 2] = fmaxf(m[j / 2], sc);
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      m[hi] = fmaxf(m[hi], __shfl_xor_sync(0xffffffffu, m[hi], 1));
      m[hi] = fmaxf(m[hi], __shfl_xor_sync(0xffffffffu, m[hi], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sacc[nt][j] = __expf(sacc[nt][j] - m[j / 2]);
        l[j / 2] += sacc[nt][j];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
      if (lane % 4 == 0) stat[wc * WROWS + er + hi * 8] = make_float2(m[hi], l[hi]);
    }
    __syncthreads();

    // the row's softmax from both halves' (m, l); p rounded to bf16 -> sp
    float f[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float2 other = stat[(wc ^ 1) * WROWS + er + hi * 8];
      const float top = fmaxf(m[hi], other.x);
      const float mine = __expf(m[hi] - top);
      f[hi] = mine / (l[hi] * mine + other.y * __expf(other.x - top));
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int key = wc * 32 + nt * 8 + ec;
      *reinterpret_cast<uint32_t*>(sp + er * LDP + key) =
          pack_bf16(sacc[nt][0] * f[0], sacc[nt][1] * f[0]);
      *reinterpret_cast<uint32_t*>(sp + (er + 8) * LDP + key) =
          pack_bf16(sacc[nt][2] * f[1], sacc[nt][3] * f[1]);
    }
    __syncthreads();

    // p v: warp -> rows rt * 16 .., head columns wc * 16 .. + 15
    float oacc[2][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) oacc[i / 4][i % 4] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < WROWS; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, sp + a_row * LDP + kk + a_k);
      ldmatrix_x4(b, svt + (wc * 16 + b_col) * LDP + kk + b_k);
      mma_bf16(oacc[0], a, b[0], b[1]);
      mma_bf16(oacc[1], a, b[2], b[3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = er + hi * 8;
        if (row < N)
          *reinterpret_cast<uint32_t*>(so + row * LDA + h * HD + wc * 16 + half * 8 + ec) =
              pack_bf16(oacc[half][hi * 2], oacc[half][hi * 2 + 1]);
      }
    // the next head's window_gemm96 synchronises before anything is rewritten
  }
}

// ------------------------- one window's attention half, float32, per block ---
//
// sx [N][C] float32 holds the window's (normalised) input. Per head, q, k, v
// come from plain dot products in index order, the attention from
// attention_row, and the head's [N, 32] output goes to `att` in device memory
// (row stride C), because a second [N, C] float32 buffer does not fit in
// shared memory at C = 768; the caller reads it back once sx is free.

// acc[i] += sum_k sa[min(r0 + i, N - 1)][k] * w[k], k in index order.
template <int K, int R>
__device__ __forceinline__ void dot_rows(const float* sa, int r0, const float* __restrict__ w,
                                         float (&acc)[R]) {
  for (int k = 0; k < K; k += 4) {
    const float4 wv = *reinterpret_cast<const float4*>(w + k);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(sa + min(r0 + i, N - 1) * K + k);
      acc[i] += a.x * wv.x;
      acc[i] += a.y * wv.y;
      acc[i] += a.z * wv.z;
      acc[i] += a.w * wv.w;
    }
  }
}

// Shared memory of the float32 form, in floats from the start.
template <int C> struct WindowSmemF32 {
  static constexpr int SX = 0;                       // [N][C]
  static constexpr int SK = SX + N * C;              // [N][HD], 16-byte aligned
  static constexpr int SV = SK + N * HD;             // [N][HD]
  static constexpr int SH = SV + N * HD;             // [BM32][BH] (the MLP's chunk)
  static constexpr int SQ = SH + BM32 * BH;          // [N][HD + 1]
  static constexpr int SS = SQ + N * (HD + 1);       // [N][N]
  static constexpr int SREG = SS + N * N;            // int [N]
  static constexpr int END = SREG + N;
  static_assert((N * C) % 4 == 0, "alignment");
};

template <int C>
__device__ __forceinline__ void window_heads_f32(float* smem, const float* __restrict__ wqkv,
                                                 const float* __restrict__ bqkv,
                                                 const float* __restrict__ bias,
                                                 const int* __restrict__ region, int w, int nw,
                                                 float* att) {
  using S = WindowSmemF32<C>;
  const float* sx = smem + S::SX;
  float* sk = smem + S::SK;
  float* sv = smem + S::SV;
  float* sq = smem + S::SQ;
  float* ss = smem + S::SS;
  int* sreg = reinterpret_cast<int*>(smem + S::SREG);
  const int tid = threadIdx.x;
  const bool masked = region != nullptr;
  if (masked && tid < N) sreg[tid] = region[static_cast<size_t>(w % nw) * N + tid];

  constexpr int R = 5;                 // rows per thread and pass
  for (int h = 0; h < C / HD; ++h) {
    __syncthreads();                   // sx is written; the last head is done with sq, ss
    // thread -> column j of q | k | v, rows 25 * rg .. (warps 0-2 | 3-5)
    if (tid < 2 * GN) {
      const int j = tid % GN, rg = tid / GN;
      const int which = j / HD, d = j % HD;
      const int wrow = which * C + h * HD + d;
      const float b = bqkv[wrow];
      for (int r0 = rg * 25; r0 < min(rg * 25 + 25, N); r0 += R) {
        float acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = 0.0f;
        dot_rows<C, R>(sx, r0, wqkv + static_cast<size_t>(wrow) * C, acc);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = r0 + i;
          if (r >= N) continue;
          const float v = acc[i] + b;
          if (which == 0) sq[r * (HD + 1) + d] = v * QK_SCALE;
          else if (which == 1) sk[r * HD + d] = v;
          else sv[r * HD + d] = v;
        }
      }
    }
    const float* hbias = bias + static_cast<size_t>(h) * N * N;
    for (int e = tid; e < N * N; e += THREADS) ss[e] = hbias[e];
    __syncthreads();
    if (tid < N)
      attention_row<float>(sq + tid * (HD + 1), sk, sv, ss + tid * N, masked ? sreg : nullptr,
                           tid);
    __syncthreads();
    for (int e = tid; e < N * HD; e += THREADS) {
      const int r = e / HD, d = e % HD;
      att[static_cast<size_t>(r) * C + h * HD + d] = sq[r * (HD + 1) + d];
    }
  }
  __syncthreads();                     // att is written: the block may read it back
}

// out[r][n] = epilogue(r, n, sum_k sa[r][k] w[n][k]) for the window's N rows
// and all C columns: thread -> column n, rows seven at a time.
template <int C, typename Epilogue>
__device__ __forceinline__ void window_linear_f32(const float* sa, const float* __restrict__ w,
                                                  Epilogue epilogue) {
  constexpr int R = 7;
  for (int n = threadIdx.x; n < C; n += THREADS)
    for (int r0 = 0; r0 < N; r0 += R) {
      float acc[R];
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] = 0.0f;
      dot_rows<C, R>(sa, r0, w + static_cast<size_t>(n) * C, acc);
#pragma unroll
      for (int i = 0; i < R; ++i) epilogue(r0 + i, n, acc[i]);
    }
}

}  // namespace swin
