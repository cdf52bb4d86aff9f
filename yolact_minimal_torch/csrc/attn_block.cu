// The attention half of a Swin block on windowed rows, one launch:
//
//     y[w] = attention(x[w] Wqkv^T + bqkv) Wproj^T + bproj      x, y: [B*nW, 49, C]
//
// where attention is, per head h of width 32,
// softmax(q k^T * 32^-0.5 + bias[h] + (-100 where region ids differ)) v.
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/window_attention.py::
// window_attention_block_fused (_block_kernel). The [49, 3C] qkv and the
// attention output never reach device memory. Region ids are the [nW, 49]
// int32 map of the shifted partition (null for an unshifted block); window w
// uses row w % nW and the kernel compares ids itself.
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
// bytes in bf16, so bytes at C = 96 and operations from C = 192 on.
// Design, simple first: one block of 256 threads per window.
// - bf16: the window's rows sit in shared memory, padded to the 64 rows of
//   four mma row tiles by one shared zero row. Head by head: a [64, C] x
//   [C, 96] product gives the head's q | k | v (weight slices staged in shared
//   memory with cp.async, 96 k at a time, each copy one chunk ahead of its
//   use), q k^T and p v run on the tensor cores too (keys padded to 64 with
//   p = 0), the softmax on the score accumulators in registers. proj is the
//   same 96-column product over the attention output, stored
//   straight from the accumulators. Every block reads
//   all of Wqkv and Wproj from L2: at C = 768 that is 4.7 MB for each of the
//   144 windows; sharing a staged slice between several windows is later work.
// - float32: dot products on the CUDA cores in index order, no TF32; the
//   attention output passes through `out` as scratch (see swin_common.cuh).
#include "swin_common.cuh"

namespace {

using namespace swin;

template <int C>
__global__ void __launch_bounds__(THREADS)
attn_block_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wqkv,
                       const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                       const int* __restrict__ region, const bf16* __restrict__ wproj,
                       const float* __restrict__ bproj, bf16* __restrict__ out, int nw) {
  using S = WindowSmem<C>;
  constexpr int LDA = S::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem + S::SX);
  const bf16* so = reinterpret_cast<const bf16*>(smem + S::SO);
  const int w = blockIdx.x;
  const size_t base = static_cast<size_t>(w) * N * C;

  WeightStream<C> stream;
  window_setup<C>(smem, stream, wqkv, wproj);
  for (int e = threadIdx.x; e < N * (C / 8); e += THREADS) {
    const int r = e / (C / 8), v = (e % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(sx + r * LDA + v) =
        *reinterpret_cast<const uint4*>(x + base + static_cast<size_t>(r) * C + v);
  }
  window_heads_bf16<C>(smem, stream, bqkv, bias,
                       region == nullptr ? nullptr : region + static_cast<size_t>(w % nw) * N);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int er = (warp % 4) * 16 + lane / 4, ec = (lane % 4) * 2;
  const bf16* o_lane = window_a_lane<LDA>(so);
  for (int n0 = 0; n0 < C; n0 += GN) {
    float acc[3][2][4];
    window_gemm96<C>(o_lane, stream, acc);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = n0 + ((warp / 4) * 3 + t) * 16 + half * 8 + ec;
        const float2 b = *reinterpret_cast<const float2*>(bproj + col);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = er + hi * 8;
          if (row < N)
            *reinterpret_cast<uint32_t*>(out + base + static_cast<size_t>(row) * C + col) =
                pack_bf16(acc[t][half][hi * 2] + b.x, acc[t][half][hi * 2 + 1] + b.y);
        }
      }
  }
}

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
int launch(const void* x, const void* wqkv, const void* bqkv, const void* bias,
           const void* region, const void* wproj, const void* bproj, void* out, int bnw,
           int nw, int is_bf16, cudaStream_t stream) {
  const int* reg = static_cast<const int*>(region);
  const float* bq = static_cast<const float*>(bqkv);
  const float* bp = static_cast<const float*>(bproj);
  cudaError_t err;
  if (is_bf16) {
    const int smem = WindowSmem<C>::END;
    auto kernel = attn_block_bf16_kernel<C>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<bnw, THREADS, smem, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv), bq,
        static_cast<const bf16*>(bias), reg, static_cast<const bf16*>(wproj), bp,
        static_cast<bf16*>(out), nw);
  } else {
    const int smem = WindowSmemF32<C>::END * sizeof(float);
    auto kernel = attn_block_f32_kernel<C>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<bnw, THREADS, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(wqkv), bq,
        static_cast<const float*>(bias), reg, static_cast<const float*>(wproj), bp,
        static_cast<float*>(out), nw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [bnw, 49, c]; wqkv [3c, c]; bqkv [3c]; bias [c / 32, 49, 49]; region
// [nw, 49] int32 or null; wproj [c, c]; bproj [c]. x, wqkv, bias, wproj and
// out are bf16 when is_bf16 is nonzero, else float32; bqkv and bproj are
// float32. c is 96, 192, 384 or 768; any other width returns
// cudaErrorInvalidValue.
extern "C" int attn_block(const void* x, const void* wqkv, const void* bqkv, const void* bias,
                          const void* region, const void* wproj, const void* bproj, void* out,
                          int bnw, int c, int nw, int is_bf16, void* stream) {
  if (bnw <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 96: return launch<96>(x, wqkv, bqkv, bias, region, wproj, bproj, out, bnw, nw, is_bf16, s);
    case 192: return launch<192>(x, wqkv, bqkv, bias, region, wproj, bproj, out, bnw, nw, is_bf16, s);
    case 384: return launch<384>(x, wqkv, bqkv, bias, region, wproj, bproj, out, bnw, nw, is_bf16, s);
    case 768: return launch<768>(x, wqkv, bqkv, bias, region, wproj, bproj, out, bnw, nw, is_bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
