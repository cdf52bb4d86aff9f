// Device code shared by the four Swin kernels (window_attention.cu,
// swin_mlp.cu, attn_block.cu, swin_block.cu): conversions, LayerNorm of a
// row, the tensor-core tiles (ldmatrix + mma.sync m16n8k16, bf16 operands,
// float32 accumulators), and the float32 bodies that more than one kernel
// runs on the CUDA cores: the hidden-unit walk of the MLP half and the
// per-head attention of a 49-token window (no TF32, sums in index order, so
// that a float32 run on the card can be held to a CPU run).
//
// All block-level routines assume THREADS = 256 threads (8 warps).
#pragma once
#include <cuda_bf16.h>
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
// and rounded), sk and sv ([NT][HD], 16-byte aligned) hold float32 copies of
// values on T's grid; s[0..NT) holds the row's bias and receives the scores in
// place. sreg is the window's region ids or null. The row of p v (float32,
// not yet rounded to T) replaces q. NT is the window's token count.
template <typename T, int NT = N>
__device__ __forceinline__ void attention_row(float* q_row, const float* sk, const float* sv,
                                              float* s, const int* sreg, int i) {
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) q[d] = q_row[d];
  const bool masked = sreg != nullptr;
  const int my_region = masked ? sreg[i] : 0;

  float row_max = -INFINITY;
#pragma unroll 7
  for (int j = 0; j < NT; ++j) {
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
  for (int j = 0; j < NT; ++j) {
    const float e = expf(s[j] - row_max);
    s[j] = e;
    sum += e;
  }

  float o[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) o[d] = 0.0f;
#pragma unroll 7
  for (int j = 0; j < NT; ++j) {
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

// ------------------------- one window's attention half, float32, per block ---
//
// sx [N][C] float32 holds the window's (normalised) input. Per head, q, k, v
// come from plain dot products in index order, the attention from
// attention_row, and the head's [N, 32] output goes to `att` in device memory
// (row stride C), because a second [N, C] float32 buffer does not fit in
// shared memory at C = 768; the caller reads it back once sx is free.

constexpr int GN = 96;             // a head's q | k | v columns

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
