// Shifted-window attention on packed qkv, one launch for all windows and heads.
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/window_attention.py::
// window_attention_fused (_kernel). For window w and head h:
//
//     out[w, :, h*32:(h+1)*32] =
//         softmax(q k^T * 32^-0.5 + bias[h] + (-100 where region ids differ)) v
//
// with q, k, v the head's [49, 32] slices of qkv[w] = [49, q | k | v]. The
// region ids are the [nW, 49] int32 map of the shifted partition (null for an
// unshifted block); window w of the batch-major axis uses row w % nW, and the
// kernel compares ids itself, so no [nW, 49, 49] mask is ever materialised.
//
// Rounding places (T is float or bf16), as in the JAX kernel: q * scale is
// rounded to T (the scale rounded to T first); scores, bias and the additive
// -100 add in float32; the softmax output is rounded to T; p v accumulates in
// float32 and is rounded to T once.
//
// What bounds it on an H100: bytes. qkv is read once and out written once
// (241 MB in bf16 at 6400 windows of C = 96) against 5.9 GFLOP of products.
// Design, simple first: one block of 64 threads per (window, head). q, k, v
// and the head's bias go to shared memory as float32 with coalesced loads;
// thread i < 49 owns query row i: its 49 scores overwrite its bias row in
// shared memory (row stride 49 words, odd, so no bank conflicts), the row
// softmax runs in that thread's registers, and p v reads v rows as
// broadcasts. The products run on the CUDA cores in both instantiations;
// tensor cores (49 padded to 64) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N = 49;        // tokens per 7x7 window
constexpr int HD = 32;       // head width
constexpr int THREADS = 64;
constexpr float NEG = -100.0f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// A float32 value rounded to T's grid.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
window_attention_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                        const int* __restrict__ region, T* __restrict__ out,
                        int heads, int nw) {
  // sq doubles as the output staging tile; its rows are padded to 33 words so
  // that thread i reading row i hits bank (i + d) % 32.
  __shared__ float sq[N][HD + 1];
  __shared__ __align__(16) float sk[N][HD];
  __shared__ __align__(16) float sv[N][HD];
  __shared__ float ss[N * N];          // bias[h], then the scores in place
  __shared__ int sreg[N];

  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int c = heads * HD;
  const T* base = qkv + static_cast<size_t>(w) * N * 3 * c + h * HD;
  const float scale = round_to<T>(0.17677669529663687f);    // 32^-0.5

  for (int e = tid; e < N * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const T* row = base + static_cast<size_t>(r) * 3 * c + d;
    sq[r][d] = round_to<T>(to_f<T>(row[0]) * scale);
    sk[r][d] = to_f<T>(row[c]);
    sv[r][d] = to_f<T>(row[2 * c]);
  }
  const T* hbias = bias + static_cast<size_t>(h) * N * N;
  for (int e = tid; e < N * N; e += THREADS) ss[e] = to_f<T>(hbias[e]);
  const bool masked = region != nullptr;
  if (masked && tid < N) sreg[tid] = region[static_cast<size_t>(w % nw) * N + tid];
  __syncthreads();

  if (tid < N) {
    float q[HD];
#pragma unroll
    for (int d = 0; d < HD; ++d) q[d] = sq[tid][d];
    float* s = ss + tid * N;
    const int my_region = masked ? sreg[tid] : 0;

    float row_max = -INFINITY;
#pragma unroll 7
    for (int j = 0; j < N; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&sk[j][d]);
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
        const float4 vv = *reinterpret_cast<const float4*>(&sv[j][d]);
        o[d] += p * vv.x;
        o[d + 1] += p * vv.y;
        o[d + 2] += p * vv.z;
        o[d + 3] += p * vv.w;
      }
    }
    // Row tid of sq was read by this thread alone: reuse it as staging.
#pragma unroll
    for (int d = 0; d < HD; ++d) sq[tid][d] = o[d];
  }
  __syncthreads();

  T* obase = out + static_cast<size_t>(w) * N * c + h * HD;
  for (int e = tid; e < N * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    obase[static_cast<size_t>(r) * c + d] = from_f<T>(sq[r][d]);
  }
}

}  // namespace

// qkv [bnw, 49, 3 * heads * 32], bias [heads, 49, 49], region [nw, 49] int32
// or null, out [bnw, 49, heads * 32]; qkv, bias and out are bf16 when is_bf16
// is nonzero, else float32.
extern "C" int window_attention(const void* qkv, const void* bias,
                                const void* region, void* out, int bnw,
                                int heads, int nw, int is_bf16, void* stream) {
  if (bnw <= 0 || heads <= 0) return 0;
  const dim3 grid(bnw, heads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* reg = static_cast<const int*>(region);
  if (is_bf16) {
    window_attention_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const __nv_bfloat16*>(bias),
        reg, static_cast<__nv_bfloat16*>(out), heads, nw);
  } else {
    window_attention_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias), reg,
        static_cast<float*>(out), heads, nw);
  }
  return static_cast<int>(cudaGetLastError());
}
