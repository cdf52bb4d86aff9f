// Triangular IoU-max suppression for fast NMS.
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/pallas_nms.py::
// suppression_iou_max (_suppression_kernel). For every row r (one class of
// one image) and candidate i:
//
//     out[r, i] = max over j < i of IoU(box j, box i) where both are valid,
//                 0 for pairs with an invalid member.
//
// A valid pair of zero-area boxes gives 0/0 = NaN, and the max must let that
// NaN win, as jnp.max does in the JAX reference (the caller's
// `iou_max <= thre` is then False). fmaxf would drop it, so the max is
// written out by hand.
//
// What bounds it on an H100: at the main configuration (1280 rows of
// K = 200) the inputs and output are ~6 MB and the work is ~2.5e7 pair IoUs
// of ~12 fp32 operations, a few microseconds either way, so a launch costs
// more than the work. Design: one block per row; the row's four coordinate
// planes, its areas and its validity live in shared memory, read once from
// device memory; thread i loops over j < i reading shared memory only (the
// j index is uniform across the warp, so the reads are broadcasts). Each
// arithmetic step uses an explicitly rounded intrinsic so that the compiler
// cannot contract `a + b - x * y` into an fma: the result is then bit-equal
// to the elementwise PyTorch and XLA forms.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void suppression_kernel(const float* __restrict__ x1,
                                   const float* __restrict__ y1,
                                   const float* __restrict__ x2,
                                   const float* __restrict__ y2,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ out, int k) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;
  uint8_t* sval = reinterpret_cast<uint8_t*>(sarea + k);

  const size_t row = static_cast<size_t>(blockIdx.x) * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float a = x1[row + i], b = y1[row + i];
    const float c = x2[row + i], d = y2[row + i];
    sx1[i] = a;
    sy1[i] = b;
    sx2[i] = c;
    sy2[i] = d;
    sarea[i] = __fmul_rn(__fsub_rn(c, a), __fsub_rn(d, b));
    sval[i] = valid[row + i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float best = 0.0f;
    if (sval[i]) {
      const float ax1 = sx1[i], ay1 = sy1[i], ax2 = sx2[i], ay2 = sy2[i];
      const float aarea = sarea[i];
      for (int j = 0; j < i; ++j) {
        if (!sval[j]) continue;
        const float iw = fmaxf(__fsub_rn(fminf(sx2[j], ax2), fmaxf(sx1[j], ax1)), 0.0f);
        const float ih = fmaxf(__fsub_rn(fminf(sy2[j], ay2), fmaxf(sy1[j], ay1)), 0.0f);
        const float inter = __fmul_rn(iw, ih);
        const float uni = __fsub_rn(__fadd_rn(sarea[j], aarea), inter);
        const float iou = __fdiv_rn(inter, uni);
        // NaN-propagating max: once best is NaN it stays NaN.
        if (!(best >= iou) && best == best) best = iou;
      }
    }
    out[row + i] = best;
  }
}

}  // namespace

extern "C" int suppression_iou_max(const void* x1, const void* y1,
                                   const void* x2, const void* y2,
                                   const void* valid, void* out, int rows,
                                   int k, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  const int threads = k >= 256 ? 256 : ((k + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + 1);
  suppression_kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(y1),
      static_cast<const float*>(x2), static_cast<const float*>(y2),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), k);
  return static_cast<int>(cudaGetLastError());
}
