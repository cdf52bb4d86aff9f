// A whole Swin block on windowed PRE-norm rows, one launch:
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
// ids. Between x and y nothing reaches device memory except, at C = 192 and
// 768, h.
//
// Rounding places (T is float or bf16), as in the JAX kernel: LN1 in float32
// (eps 1e-5), times rowmask, rounded to T; the attention half as in
// attn_block.cu, but proj is not rounded: h = x + proj + bproj stays float32.
// LN2 of that float32 h, rounded to T; fc1 accumulates in float32, + b1 and
// gelu (erff) in float32, rounded to T once; fc2 accumulates in float32,
// h + fc2 + b2 in float32, rounded to T once. Weights are in T in nn.Linear's
// [out, in] layout; LayerNorm parameters and the four bias vectors float32.
//
// What bounds it on an H100: operations, 24 C^2 + 4 * 49 C a row against 4 C
// bytes in bf16. Design: one block of 256 threads per window; the attention
// half is attn_block.cu's (swin_common.cuh), the MLP half is swin_mlp.cu's
// walk over the hidden units on the window's rows, whose staging buffers
// reuse the attention half's shared memory.
// - The float32 h [49, C] lives in shared memory at C = 96 and 384. At C = 768
//   (147 KB) it does not fit beside LN(x), the attention output and the
//   staging buffers, and goes through a float32 scratch tensor in device
//   memory that the block writes and reads back at once (L2). C = 192 takes
//   the scratch too: without h a block needs 105 KB, so two share an SM.
// - The MLP walk takes the 64 padded rows in one pass; at C = 768, where 64
//   rows of fc2 accumulators do not fit the registers, in two passes of 32,
//   which reads k1 and k2 twice.
// - Every block reads all four weight matrices from L2 (14 MB at C = 768,
//   twice for k1 and k2, for each of 144 windows): later work.
// - float32: the CUDA cores, sums in index order, no TF32; `out` doubles as
//   the scratch for the attention output and for h.
#include "swin_common.cuh"

namespace {

using namespace swin;

// Where the float32 h [49, C] lives between the halves: in shared memory at
// C = 96 and 384; through the scratch tensor at C = 768, where it does not
// fit, and at C = 192, where leaving it out lets two blocks share an SM.
template <int C> struct HShared { static constexpr bool value = C == 96 || C == 384; };

// BM: rows per pass of the MLP walk.
template <int C, int BM>
__global__ void __launch_bounds__(THREADS, C <= 192 ? 2 : 1)
swin_block_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ rowmask,
                       const float* __restrict__ ln1s, const float* __restrict__ ln1b,
                       const bf16* __restrict__ wqkv, const float* __restrict__ bqkv,
                       const bf16* __restrict__ bias, const int* __restrict__ region,
                       const bf16* __restrict__ wproj, const float* __restrict__ bproj,
                       const float* __restrict__ ln2s, const float* __restrict__ ln2b,
                       const bf16* __restrict__ k1, const float* __restrict__ b1,
                       const bf16* __restrict__ k2, const float* __restrict__ b2,
                       float* scratch, bf16* __restrict__ out, int nw) {
  using S = WindowSmem<C>;
  constexpr int LDA = S::LDA;
  constexpr bool H_SHARED = HShared<C>::value;
  constexpr int RT = BM / 16, WPR = WARPS / RT, NT = (C / 16) / WPR;
  static_assert(LDA == MlpTiles<C>::LDA, "the MLP walk reads the window buffer's rows");
  static_assert(MlpTiles<C>::SW * 2 <= S::SP - S::SO, "MLP weight slices fit over so .. svt");
  static_assert(BM * MlpTiles<C>::LDH * 2 <= S::STAT - S::SP, "gelu chunk fits over sp");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sx = reinterpret_cast<bf16*>(smem + S::SX);
  const bf16* so = reinterpret_cast<const bf16*>(smem + S::SO);
  const int w = blockIdx.x;
  const size_t base = static_cast<size_t>(w) * N * C;
  float* hbuf = H_SHARED ? reinterpret_cast<float*>(smem + S::END) : scratch + base;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  WeightStream<C> stream;
  window_setup<C>(smem, stream, wqkv, wproj);
  for (int r = warp; r < N; r += WARPS) {
    const float mul = rowmask == nullptr ? 1.0f : rowmask[static_cast<size_t>(w % nw) * N + r];
    layer_norm_row<bf16, bf16, C>(x + base + static_cast<size_t>(r) * C, ln1s, ln1b, mul,
                                  sx + r * LDA);
  }
  window_heads_bf16<C>(smem, stream, bqkv, bias,
                       region == nullptr ? nullptr : region + static_cast<size_t>(w % nw) * N);

  // h = x + proj + bproj, float32
  {
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
            if (row < N) {
              const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(
                  x + base + static_cast<size_t>(row) * C + col);
              *reinterpret_cast<float2*>(hbuf + row * C + col) =
                  make_float2((__bfloat162float(xv.x) + acc[t][half][hi * 2]) + b.x,
                              (__bfloat162float(xv.y) + acc[t][half][hi * 2 + 1]) + b.y);
            }
          }
        }
    }
  }
  __syncthreads();                      // h is whole; so and the weight slots are free

  for (int r = warp; r < N; r += WARPS)
    layer_norm_row<float, bf16, C>(hbuf + r * C, ln2s, ln2b, 1.0f, sx + r * LDA);

  bf16* mw = reinterpret_cast<bf16*>(smem + S::SO);     // k1 / k2 slices
  bf16* sh = reinterpret_cast<bf16*>(smem + S::SP);     // gelu chunk
  const int rt = warp % RT, wc = warp / RT;
  for (int row0 = 0; row0 < WROWS; row0 += BM) {
    const bf16* a_lane = sx + min(row0 + rt * 16 + lane_a_row(), N) * LDA + lane_a_k();
    float yacc[NT][2][4];
    mlp_hidden_walk<C, BM, false>(a_lane, sh, mw, k1, b1, k2, yacc);
    const int er = row0 + rt * 16 + lane / 4, ec = (lane % 4) * 2;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = (wc * NT + t) * 16 + half * 8 + ec;
        const float2 b = *reinterpret_cast<const float2*>(b2 + col);
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int row = er + hi * 8;
          if (row < N) {
            const float2 hv = *reinterpret_cast<const float2*>(hbuf + row * C + col);
            *reinterpret_cast<uint32_t*>(out + base + static_cast<size_t>(row) * C + col) =
                pack_bf16((hv.x + yacc[t][half][hi * 2]) + b.x,
                          (hv.y + yacc[t][half][hi * 2 + 1]) + b.y);
          }
        }
      }
  }
}

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

template <int C, int BM>
int launch(const void* x, const void* rowmask, const void* ln1s, const void* ln1b,
           const void* wqkv, const void* bqkv, const void* bias, const void* region,
           const void* wproj, const void* bproj, const void* ln2s, const void* ln2b,
           const void* k1, const void* b1, const void* k2, const void* b2, void* scratch,
           void* out, int bnw, int nw, int is_bf16, cudaStream_t stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  const int* reg = static_cast<const int*>(region);
  cudaError_t err;
  if (is_bf16) {
    constexpr bool H_SHARED = HShared<C>::value;
    if (!H_SHARED && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = WindowSmem<C>::END + (H_SHARED ? N * C * 4 : 0);
    auto kernel = swin_block_bf16_kernel<C, BM>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<bnw, THREADS, smem, stream>>>(
        h(x), f(rowmask), f(ln1s), f(ln1b), h(wqkv), f(bqkv), h(bias), reg, h(wproj), f(bproj),
        f(ln2s), f(ln2b), h(k1), f(b1), h(k2), f(b2), static_cast<float*>(scratch),
        static_cast<bf16*>(out), nw);
  } else {
    const int smem = WindowSmemF32<C>::END * sizeof(float);
    auto kernel = swin_block_f32_kernel<C>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<bnw, THREADS, smem, stream>>>(
        f(x), f(rowmask), f(ln1s), f(ln1b), f(wqkv), f(bqkv), f(bias), reg, f(wproj), f(bproj),
        f(ln2s), f(ln2b), f(k1), f(b1), f(k2), f(b2), static_cast<float*>(out), nw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out [bnw, 49, c]; rowmask [nw, 49] float32 or null; ln1s, ln1b, ln2s,
// ln2b [c]; wqkv [3c, c]; bqkv [3c]; bias [c / 32, 49, 49]; region [nw, 49]
// int32 or null; wproj [c, c]; bproj [c]; k1 [4c, c]; b1 [4c]; k2 [c, 4c];
// b2 [c]. x, the four weight matrices, bias and out are bf16 when is_bf16 is
// nonzero, else float32; everything else is float32. scratch is float32
// [bnw, 49, c], needed for bf16 at c = 192 and 768 only (null otherwise). c is 96,
// 192, 384 or 768; any other width returns cudaErrorInvalidValue.
extern "C" int swin_block(const void* x, const void* rowmask, const void* ln1s,
                          const void* ln1b, const void* wqkv, const void* bqkv,
                          const void* bias, const void* region, const void* wproj,
                          const void* bproj, const void* ln2s, const void* ln2b, const void* k1,
                          const void* b1, const void* k2, const void* b2, void* scratch,
                          void* out, int bnw, int c, int nw, int is_bf16, void* stream) {
  if (bnw <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // (C, rows per pass of the bf16 MLP walk)
#define SWIN_BLOCK_CASE(C, BM)                                                              \
  case C:                                                                                   \
    return launch<C, BM>(x, rowmask, ln1s, ln1b, wqkv, bqkv, bias, region, wproj, bproj,    \
                         ln2s, ln2b, k1, b1, k2, b2, scratch, out, bnw, nw, is_bf16, s);
  switch (c) {
    SWIN_BLOCK_CASE(96, 64)
    SWIN_BLOCK_CASE(192, 64)
    SWIN_BLOCK_CASE(384, 64)
    SWIN_BLOCK_CASE(768, 32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_BLOCK_CASE
}
