// The MLP half of a Swin block in one pass over the rows:
//
//     y = x + fc2(gelu_erf(fc1(LayerNorm(x))))       x, y: [R, C]
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/swin_mlp.py::
// mlp_block_fused (_kernel). The 4C-wide hidden activations never reach
// device memory: a block normalises BM rows into shared memory, then walks the
// hidden units in chunks of 64: fc1 on the chunk, + b1, gelu, and at once the
// chunk's share of fc2 into accumulators that stay in registers; x is read
// again for the residual and y written once.
//
// Rounding places (T is float or bf16), as in the JAX kernel: LayerNorm in
// float32 (eps 1e-5), rounded to T; fc1 accumulates in float32, + b1 in
// float32, rounded to T; gelu (erff) in float32, rounded to T; fc2 accumulates
// in float32, + b2 and + x in float32, rounded to T once. LayerNorm
// parameters and both biases are float32; k1 [4C, C] and k2 [C, 4C] are in T,
// laid out as nn.Linear keeps them ([out, in]).
//
// What bounds it on an H100: operations, 16 R C^2 of them (43.6 GFLOP at every
// stage of swin_tiny at 544, batch 16), against 4 R C bytes of rows in bf16.
// - bf16: the tensor cores through mma.sync m16n8k16 (bf16 operands, float32
//   accumulators) fed by ldmatrix. 8 warps; BM = 64 rows (32 at C = 768,
//   where 64 rows of accumulators would not fit the registers); a warp owns
//   16 rows and a share of the columns. The [out, in] layout is the "col" B
//   operand as it stands. Each chunk's slice of k1 ([64, C]) and then of k2
//   ([C, 64]) is copied into one shared-memory buffer with 16-byte cp.async
//   copies (the weights stay in L2; the k2 copy runs under the gelu
//   epilogue), so every operand comes from padded shared-memory rows. The
//   accumulators' element order is known, so both epilogues work on
//   registers. mma.sync rather than nvcuda::wmma: a wmma fragment holds every
//   operand element twice, which doubles the shared-memory reads that bound
//   this kernel.
// - float32: plain FMAs on the CUDA cores, no TF32, summing in index order so
//   that it can be held to a CPU run; BM = 32 rows.
// Rows beyond R are zero in shared memory and never written.
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BH = 64;             // hidden units per chunk
constexpr float LN_EPS = 1e-5f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm of rows row0 .. row0+BM-1 of x into sa[BM][LD] (rounded to T);
// warp w takes rows w, w + 8, ...; rows past `rows` become zeros.
template <typename T, int C, int BM, int LD>
__device__ __forceinline__ void layer_norm_tile(const T* __restrict__ x,
                                                const float* __restrict__ lns,
                                                const float* __restrict__ lnb,
                                                T* __restrict__ sa, int row0, int rows) {
  constexpr int PER_LANE = C / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += WARPS) {
    const int g = row0 + r;
    T* dst = sa + r * LD;
    if (g >= rows) {
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) dst[lane + 32 * i] = from_f<T>(0.0f);
      continue;
    }
    const T* src = x + static_cast<size_t>(g) * C;
    float v[PER_LANE];
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < PER_LANE; ++i) {
      v[i] = to_f<T>(src[lane + 32 * i]);
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
      dst[c] = from_f<T>(v[i] * inv * lns[c] + lnb[c]);
    }
  }
}

// ---------------------------------------------------------------- bf16 -----

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

// C: row width; BM: rows per block.
template <int C, int BM>
__global__ void __launch_bounds__(THREADS)
mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                const float* __restrict__ lnb, const bf16* __restrict__ k1,
                const float* __restrict__ b1, const bf16* __restrict__ k2,
                const float* __restrict__ b2, bf16* __restrict__ out, int rows) {
  constexpr int H = 4 * C;
  constexpr int LDA = C + 8;            // rows padded by 16 bytes: the 8 rows of an
  constexpr int LDH = BH + 8;           // ldmatrix fall into 8 different bank groups
  constexpr int RT = BM / 16;           // row tiles of the block
  constexpr int WPR = WARPS / RT;       // warps sharing one row tile
  constexpr int NT = (C / 16) / WPR;    // fc2 16-column tiles per warp
  constexpr int G1 = RT * (BH / 16) / WARPS;   // fc1 16-column tiles per warp
  static_assert(WARPS % RT == 0 && (C / 16) % WPR == 0 && G1 >= 1, "tile split");
  static_assert(C * LDH >= BH * LDA, "the weight buffer holds either slice");

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);                 // [BM][LDA] LN(x)
  bf16* sh = sa + BM * LDA;                                 // [BM][LDH] gelu chunk
  bf16* sw = sh + BM * LDH;             // k1 slice [BH][LDA], then k2 slice [C][LDH]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  // Warp -> rows rt * 16 .. + 15 in both products; fc1 16-column tiles
  // wc + WPR * g, fc2 16-column tiles wc * NT + t.
  const int rt = warp % RT, wc = warp / RT;
  // ldmatrix row addresses. A operand (16 rows x 16 k): lane -> row lane % 16,
  // k offset 8 * (lane / 16). B operand, two 8-column tiles of a weight slice
  // stored [column][k]: lane -> column lane % 8 + 8 * (lane / 16), k offset
  // 8 * ((lane / 8) % 2).
  const int a_row = rt * 16 + lane % 16, a_k = (lane / 16) * 8;
  const int b_col = lane % 8 + (lane / 16) * 8, b_k = ((lane / 8) % 2) * 8;
  // Accumulator element (d0, d1 | d2, d3): rows er | er + 8, columns ec, ec + 1
  // of an 8-column tile.
  const int er = rt * 16 + lane / 4, ec = (lane % 4) * 2;

  layer_norm_tile<bf16, C, BM, LDA>(x, lns, lnb, sa, row0, rows);

  float yacc[NT][2][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i) yacc[t][i / 4][i % 4] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += BH) {
    __syncthreads();                    // sa is written; the last fc2 is done with sw, sh
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
      ldmatrix_x4(a, sa + a_row * LDA + kk + a_k);
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

    // + b1, round, gelu, round -> sh, while the k2 slice arrives
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
          v[i] = gelu_erf(__bfloat162float(__float2bfloat16_rn(v[i])));
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
      ldmatrix_x4(a, sh + a_row * LDH + kk + a_k);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t b[4];
        ldmatrix_x4(b, sw + ((wc * NT + t) * 16 + b_col) * LDH + kk + b_k);
        mma_bf16(yacc[t][0], a, b[0], b[1]);
        mma_bf16(yacc[t][1], a, b[2], b[3]);
      }
    }
  }

  // + b2, + x, round once; a lane writes two neighbouring columns at a time
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = (wc * NT + t) * 16 + half * 8 + ec;
      const float2 bias = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int g = row0 + er + hi * 8;
        if (g < rows) {
          const size_t at = static_cast<size_t>(g) * C + col;
          const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(x + at);
          *reinterpret_cast<uint32_t*>(out + at) =
              pack_bf16(__bfloat162float(xv.x) + (yacc[t][half][hi * 2] + bias.x),
                        __bfloat162float(xv.y) + (yacc[t][half][hi * 2 + 1] + bias.y));
        }
      }
    }
}

template <int C, int BM>
int launch_bf16(const void* x, const void* lns, const void* lnb, const void* k1,
                const void* b1, const void* k2, const void* b2, void* out, int rows,
                cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(BM) * (C + 8 + BH + 8) + C * (BH + 8)) * sizeof(bf16);
  auto kernel = mlp_bf16_kernel<C, BM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(rows + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(lns),
      static_cast<const float*>(lnb), static_cast<const bf16*>(k1),
      static_cast<const float*>(b1), static_cast<const bf16*>(k2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32 -----

constexpr int BM32 = 32;

template <int C>
__global__ void __launch_bounds__(THREADS)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ lns,
               const float* __restrict__ lnb, const float* __restrict__ k1,
               const float* __restrict__ b1, const float* __restrict__ k2,
               const float* __restrict__ b2, float* __restrict__ out, int rows) {
  constexpr int H = 4 * C;
  constexpr int R1 = BM32 / (THREADS / BH);     // fc1 rows per thread
  constexpr int E2 = BM32 * C / THREADS;        // fc2 outputs per thread
  extern __shared__ __align__(128) unsigned char smem[];
  float* sa = reinterpret_cast<float*>(smem);   // [BM32][C] LN(x)
  float* sh = sa + BM32 * C;                    // [BM32][BH] gelu chunk
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM32;

  layer_norm_tile<float, C, BM32, C>(x, lns, lnb, sa, row0, rows);
  __syncthreads();

  // fc1: thread -> hidden unit j of the chunk, rows rg, rg + 4, ... (a warp
  // shares its rows, so sa reads are broadcasts).
  const int j = tid % BH, rg = tid / BH;
  // fc2: thread -> outputs e = tid + 256 i of the [BM32, C] tile; a warp's 32
  // outputs lie in one row (C is a multiple of 32).
  float y[E2];
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
        const float4 a = *reinterpret_cast<const float4*>(sa + (rg + 4 * i) * C + c);
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
// any other width returns cudaErrorInvalidValue.
extern "C" int swin_mlp(const void* x, const void* lns, const void* lnb,
                        const void* k1, const void* b1, const void* k2,
                        const void* b2, void* out, int rows, int c, int is_bf16,
                        void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (C, rows per block of the bf16 kernel)
#define SWIN_MLP_CASE(C, BM)                                                        \
  case C:                                                                           \
    return is_bf16 ? launch_bf16<C, BM>(x, lns, lnb, k1, b1, k2, b2, out, rows, s)  \
                   : launch_f32<C>(x, lns, lnb, k1, b1, k2, b2, out, rows, s);
  switch (c) {
    SWIN_MLP_CASE(96, 64)
    SWIN_MLP_CASE(192, 64)
    SWIN_MLP_CASE(384, 64)
    SWIN_MLP_CASE(768, 32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_MLP_CASE
}
