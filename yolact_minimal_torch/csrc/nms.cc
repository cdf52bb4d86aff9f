// Greedy per-class NMS on the host, for the --traditional_nms path.
//
// The port's own copy of native/nms.cc, which the JAX package's
// yolact_minimal_tpu/ops/traditional_nms.py builds and binds; it in turn
// stands in for the reference's Cython greedy-NMS extension. The fast-NMS
// path runs the suppression kernel on the card instead (csrc/suppression.cu).
//
// Conventions: boxes are pixel-scaled x1,y1,x2,y2 and areas use the +1 pixel
// convention ((x2-x1+1)*(y2-y1+1)); a box is suppressed when its IoU with a
// higher-scoring kept box is >= the threshold; candidates are visited in
// descending score order, ties in input order (std::stable_sort).
//
// Built by g++ into build/torch_host/ (yolact_minimal_torch/ops/_build.py)
// and called through ctypes by yolact_minimal_torch/ops/traditional_nms.py.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <vector>

extern "C" {

// boxes: [n * 4] row-major x1,y1,x2,y2 (pixel scale)
// scores: [n]
// keep_out: caller-allocated [n]; filled with the kept indices (positions in
//           the input), in descending score order.
// returns: the number of kept boxes.
int greedy_nms(const float* boxes, const float* scores, int n,
               float iou_thresh, int* keep_out) {
  if (n <= 0) return 0;

  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [scores](int a, int b) { return scores[a] > scores[b]; });

  std::vector<float> areas(n);
  for (int i = 0; i < n; ++i) {
    const float* b = boxes + 4 * i;
    areas[i] = (b[2] - b[0] + 1.0f) * (b[3] - b[1] + 1.0f);
  }

  std::vector<uint8_t> suppressed(n, 0);
  int num_kept = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep_out[num_kept++] = i;
    const float* bi = boxes + 4 * i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const float* bj = boxes + 4 * j;
      const float xx1 = std::max(bi[0], bj[0]);
      const float yy1 = std::max(bi[1], bj[1]);
      const float xx2 = std::min(bi[2], bj[2]);
      const float yy2 = std::min(bi[3], bj[3]);
      const float w = std::max(0.0f, xx2 - xx1 + 1.0f);
      const float h = std::max(0.0f, yy2 - yy1 + 1.0f);
      const float inter = w * h;
      const float iou = inter / (areas[i] + areas[j] - inter);
      if (iou >= iou_thresh) suppressed[j] = 1;
    }
  }
  return num_kept;
}

}  // extern "C"
