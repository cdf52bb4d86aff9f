// Fused detect-mask finalize: lincomb -> crop -> bilinear upsample -> > 0.5.
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/pallas_masks.py::
// fused_mask_finalize (_kernel). For image b and slate slot d:
//
//     m[r, c]  = sigmoid(sum_k coefs[b, d, k] * proto[b, r, c, k])
//                inside the sanitize_coordinates(padding=1) box, else 0
//     out[y,x] = bilinear(m)(y, x) > 0.5       (0 everywhere if !valid[b, d])
//
// The bilinear sample takes its taps from the row and column tables
// (lo, hi, frac) that ops/resize.py::_gather_lerp builds, so any output size
// works; rows are mixed first and columns second, as in the reference.
//
// What bounds it on an H100: the bool output. At the main configuration
// (B=16, D=100, S=544) it is 473.5 MB of bytes written against 37.9 MB of
// proto read, ~0.15 ms at 3.35 TB/s; the lincomb is ~2 GFLOP. Design: one
// block per (output-row band, slot, image). The block computes the band's
// proto rows plus their halo once into shared memory (a 32-long dot per
// proto pixel, skipped outside the crop box, where the mask is 0), then
// upsamples from shared memory with consecutive threads on consecutive
// output bytes, so every store is coalesced. An invalid slot writes zeros
// without reading the proto. Blocks of one image are adjacent in the grid,
// so the proto they share is read from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void sanitize(float a, float b, int size,
                                         float* lo, float* hi) {
  // ops/boxes.py::sanitize_coordinates with padding=1, in the same order.
  a = __fmul_rn(a, static_cast<float>(size));
  b = __fmul_rn(b, static_cast<float>(size));
  *lo = fmaxf(__fsub_rn(fminf(a, b), 1.0f), 0.0f);
  *hi = fminf(__fadd_rn(fmaxf(a, b), 1.0f), static_cast<float>(size));
}

__global__ void mask_finalize_kernel(
    const float* __restrict__ proto, const float* __restrict__ coefs,
    const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
    const int* __restrict__ lo_h, const int* __restrict__ hi_h,
    const float* __restrict__ fh, const int* __restrict__ lo_w,
    const int* __restrict__ hi_w, const float* __restrict__ fw,
    uint8_t* __restrict__ out, int ph, int pw, int nc, int d_slots, int s,
    int band_rows, int do_crop) {
  const int band = blockIdx.x, d = blockIdx.y, b = blockIdx.z;
  const int y0 = band * band_rows;
  const int y1 = min(y0 + band_rows, s);
  const int slot = b * d_slots + d;
  uint8_t* dst = out + (static_cast<size_t>(slot) * s + y0) * s;
  const int n_out = (y1 - y0) * s;

  if (!valid[slot]) {
    for (int i = threadIdx.x; i < n_out; i += blockDim.x) dst[i] = 0;
    return;
  }

  extern __shared__ float smem[];
  float* coef = smem;        // [nc]
  float* m = smem + nc;      // [band proto rows, pw]
  for (int k = threadIdx.x; k < nc; k += blockDim.x)
    coef[k] = coefs[static_cast<size_t>(slot) * nc + k];

  float cx1 = 0.0f, cx2 = static_cast<float>(pw);
  float cy1 = 0.0f, cy2 = static_cast<float>(ph);
  if (do_crop) {
    const float* bx = boxes + static_cast<size_t>(slot) * 4;
    sanitize(bx[0], bx[2], pw, &cx1, &cx2);
    sanitize(bx[1], bx[3], ph, &cy1, &cy2);
  }
  const int r0 = lo_h[y0];
  const int n_rows = hi_h[y1 - 1] - r0 + 1;
  __syncthreads();

  const float* img = proto + static_cast<size_t>(b) * ph * pw * nc;
  for (int p = threadIdx.x; p < n_rows * pw; p += blockDim.x) {
    const int r = r0 + p / pw;
    const int c = p - (p / pw) * pw;
    float v = 0.0f;
    const float fc = static_cast<float>(c), fr = static_cast<float>(r);
    if (fc >= cx1 && fc < cx2 && fr >= cy1 && fr < cy2) {
      const float* px = img + (static_cast<size_t>(r) * pw + c) * nc;
      float acc = 0.0f;
      for (int k = 0; k < nc; ++k) acc = fmaf(coef[k], px[k], acc);
      v = 1.0f / (1.0f + expf(-acc));
    }
    m[p] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int yl = i / s;
    const int x = i - yl * s;
    const int y = y0 + yl;
    const float* top = m + (lo_h[y] - r0) * pw;
    const float* bot = m + (hi_h[y] - r0) * pw;
    const float wy = fh[y], wx = fw[x];
    const int xl = lo_w[x], xh = hi_w[x];
    const float left = (1.0f - wy) * top[xl] + wy * bot[xl];
    const float right = (1.0f - wy) * top[xh] + wy * bot[xh];
    dst[i] = ((1.0f - wx) * left + wx * right) > 0.5f;
  }
}

}  // namespace

extern "C" int mask_finalize(const void* proto, const void* coefs,
                             const void* boxes, const void* valid,
                             const void* lo_h, const void* hi_h, const void* fh,
                             const void* lo_w, const void* hi_w, const void* fw,
                             void* out, int b, int ph, int pw, int nc,
                             int d_slots, int s, int band_rows,
                             int max_band_proto_rows, int do_crop,
                             void* stream) {
  if (b <= 0 || d_slots <= 0 || s <= 0) return 0;
  const dim3 grid((s + band_rows - 1) / band_rows, d_slots, b);
  const size_t smem =
      (static_cast<size_t>(nc) + static_cast<size_t>(max_band_proto_rows) * pw) *
      sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mask_finalize_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proto), static_cast<const float*>(coefs),
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<const int*>(lo_h), static_cast<const int*>(hi_h),
      static_cast<const float*>(fh), static_cast<const int*>(lo_w),
      static_cast<const int*>(hi_w), static_cast<const float*>(fw),
      static_cast<uint8_t*>(out), ph, pw, nc, d_slots, s, band_rows, do_crop);
  return static_cast<int>(cudaGetLastError());
}
