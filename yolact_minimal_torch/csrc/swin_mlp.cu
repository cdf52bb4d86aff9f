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
#include "swin_common.cuh"

namespace {

using namespace swin;

// C: row width; BM: rows per block.
template <int C, int BM>
__global__ void __launch_bounds__(THREADS)
mlp_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ lns,
                const float* __restrict__ lnb, const bf16* __restrict__ k1,
                const float* __restrict__ b1, const bf16* __restrict__ k2,
                const float* __restrict__ b2, bf16* __restrict__ out, int rows) {
  constexpr int LDA = MlpTiles<C>::LDA, LDH = MlpTiles<C>::LDH;
  constexpr int RT = BM / 16;           // row tiles of the block
  constexpr int WPR = WARPS / RT;       // warps sharing one row tile
  constexpr int NT = (C / 16) / WPR;    // fc2 16-column tiles per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);                 // [BM][LDA] LN(x)
  bf16* sh = sa + BM * LDA;                                 // [BM][LDH] gelu chunk
  bf16* sw = sh + BM * LDH;             // k1 slice [BH][LDA], then k2 slice [C][LDH]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * BM;
  // Warp -> rows rt * 16 .. + 15, fc2 16-column tiles wc * NT + t; accumulator
  // element (d0, d1 | d2, d3): rows er | er + 8, columns ec, ec + 1 of an
  // 8-column tile.
  const int rt = warp % RT, wc = warp / RT;
  const int er = rt * 16 + lane / 4, ec = (lane % 4) * 2;

  layer_norm_tile<bf16, C, BM, LDA>(x, lns, lnb, sa, row0, rows);

  float yacc[NT][2][4];
  mlp_hidden_walk<C, BM, true>(sa + (rt * 16 + lane_a_row()) * LDA + lane_a_k(), sh, sw, k1, b1,
                               k2, yacc);

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
  const size_t smem = (static_cast<size_t>(BM) * (MlpTiles<C>::LDA + MlpTiles<C>::LDH) +
                       MlpTiles<C>::SW) * sizeof(bf16);
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
