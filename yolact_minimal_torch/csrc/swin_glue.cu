// The layout glue of a Swin block's attention half, one pass each way
// (models/swin.py::SwinBlock, the 'composed' form, calls that need no
// gradient; ops/swin_glue.py holds the plain versions).
//
// Replaces no TPU kernel: the JAX package leaves norm1, the pad, the roll,
// the window partition and their reverse to XLA, which fuses them; in
// PyTorch they were about ten passes over the activations (the float32
// casts around the LayerNorm, the LayerNorm, pad, roll, the partition's
// permute copy; the reverse's copy, the roll back, the crop and the residual
// add), ~15 device ms of a Swin-L detect call at b16 (PERF.md).
//
//   swin_glue_to_windows:   out [B*nW, N, C] = window_partition(roll(pad(LN(x)), -shift))
//   swin_glue_from_windows: out [B, H, W, C] = shortcut + crop(roll(window_reverse(y), shift))
//
// Both are row remaps: window row (image b, window (wy, wx), token (ty, tx))
// is image row ((wy w + ty + shift) mod hp, (wx w + tx + shift) mod wp) of
// image b, or padding where that row lies at y >= h or x >= w (hp, wp: h, w
// padded up to a multiple of the window w). Each row is C contiguous values
// on both sides, so nothing is transposed: to_windows reads each image row
// once, takes its LayerNorm in float32 in registers (mean, then the centred
// variance, both over the row in index order within a lane and by a shuffle
// tree across lanes), applies the scale and bias in float32, rounds once to
// the compute dtype and writes it to its window row; padding rows are
// written as zeros without a read (padding after norm1). from_windows reads
// the window row of each image row and the shortcut row, adds them in
// float32 and rounds once (PyTorch's `shortcut + x` in either dtype, bit for
// bit); padding rows are never read.
//
// What bounds them on an H100: bytes. At Swin-L's stage 0 (b16, 544 px:
// 295,936 image rows, 331,776 window rows of 192 bf16 values) to_windows
// moves 114 + 127 MB and from_windows 3 x 114 MB; over Swin-L's 24 blocks
// 4.53 GB, 1.35 ms at 3.35 TB/s. The design is for the memory rate:
// - a row is L lanes of one warp, each lane V 16-byte vectors, lane l
//   holding vectors l, l + L, ... so that neighbouring lanes read and write
//   neighbouring 16 bytes (L = 4 to 32, V = 3 to 12 over C = 96..1536 in
//   bf16 and float32; RowPlan);
// - a persistent grid (the blocks that fit on the card at once) walks the
//   rows, each lane group U rows an iteration (two, one where a lane holds
//   six vectors or more) with all their loads issued before any use, so
//   that every lane keeps U V loads of each input in flight;
// - no shared memory: the LayerNorm's sums stay in the lanes of a row
//   (xor shuffles within aligned groups of L lanes); the scale and bias are
//   read through the read-only cache, where every row finds them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;       // nn.LayerNorm's eps in models/swin.py

// How lanes cover a row of C values of T: E values a 16-byte vector, NV
// vectors a row, L lanes a row (a power of two: C is 3 * 2^k), V vectors a
// lane, G rows a warp at once.
template <typename T, int C> struct RowPlan {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int NV = C / E;
  static constexpr int L = NV / 3 < 32 ? NV / 3 : 32;
  static constexpr int V = NV / L;
  static constexpr int G = 32 / L;
  // rows a lane group takes an iteration: two, or one where a lane holds
  // six vectors or more of a row (wide rows keep their registers)
  static constexpr int U = V >= 6 ? 1 : 2;
  static_assert(C % E == 0 && NV == L * V && (L & (L - 1)) == 0 && L >= 2,
                "C must be 3 * 2^k with k >= 5");
};

__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* f, bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ uint4 pack(const float* f, bf16) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// The sum of v over the L lanes of this lane's row (aligned groups of L).
template <int L> __device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A block's map: image h x w, padded hp x wp, nwx windows a row of them.
struct Geometry {
  int h, w, hp, wp, window, shift, nwx, tokens;
};

Geometry geometry(int h, int w, int window, int shift) {
  Geometry g;
  g.h = h;
  g.w = w;
  g.hp = (h + window - 1) / window * window;
  g.wp = (w + window - 1) / window * window;
  g.window = window;
  g.shift = shift;
  g.nwx = g.wp / window;
  g.tokens = window * window;
  return g;
}

// The image row (b h + y) w + x that window row r shows, or -1 for padding.
__device__ __forceinline__ long long image_row(const Geometry& g, long long r) {
  const long long per_image = static_cast<long long>(g.hp) * g.wp;
  const long long b = r / per_image;
  const int in_image = static_cast<int>(r - b * per_image);
  const int win = in_image / g.tokens, tok = in_image - win * g.tokens;
  const int wy = win / g.nwx, wx = win - wy * g.nwx;
  const int ty = tok / g.window, tx = tok - ty * g.window;
  int y = wy * g.window + ty + g.shift, x = wx * g.window + tx + g.shift;
  if (y >= g.hp) y -= g.hp;
  if (x >= g.wp) x -= g.wp;
  if (y >= g.h || x >= g.w) return -1;
  return (b * g.h + y) * g.w + x;
}

// The window row that image row r (of B h w) lands in.
__device__ __forceinline__ long long window_row(const Geometry& g, long long r) {
  const long long per_image = static_cast<long long>(g.h) * g.w;
  const long long b = r / per_image;
  const int in_image = static_cast<int>(r - b * per_image);
  const int i = in_image / g.w, j = in_image - i * g.w;
  int y = i - g.shift, x = j - g.shift;
  if (y < 0) y += g.hp;
  if (x < 0) x += g.wp;
  const int wy = y / g.window, ty = y - wy * g.window;
  const int wx = x / g.window, tx = x - wx * g.window;
  const long long windows_before = b * (g.hp / g.window) * g.nwx + wy * g.nwx + wx;
  return windows_before * g.tokens + ty * g.window + tx;
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
swin_to_windows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       long long rows, Geometry g) {
  using P = RowPlan<T, C>;
  const int lane = threadIdx.x % 32, group = lane / P::L, sub = lane % P::L;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * kThreads / 32;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const float4* sv = reinterpret_cast<const float4*>(scale);
  const float4* bv = reinterpret_cast<const float4*>(bias);
  constexpr int PER_WARP = P::G * P::U;
  // warp-uniform trip count: every lane reaches every shuffle
  for (long long base = warp * PER_WARP; base < rows; base += warps * PER_WARP) {
    uint4 v[P::U][P::V];
    long long src[P::U];
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const long long r = base + group + u * P::G;
      src[u] = r < rows ? image_row(g, r) : -1;
#pragma unroll
      for (int k = 0; k < P::V; ++k)
        v[u][k] = src[u] >= 0 ? __ldg(xv + src[u] * P::NV + sub + k * P::L)
                              : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const long long r = base + group + u * P::G;
      float f[P::E];
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < P::V; ++k) {
        unpack(v[u][k], f, T());
#pragma unroll
        for (int e = 0; e < P::E; ++e) sum += f[e];
      }
      const float mu = group_sum<P::L>(sum) / C;
      float sq = 0.0f;
#pragma unroll
      for (int k = 0; k < P::V; ++k) {
        unpack(v[u][k], f, T());
#pragma unroll
        for (int e = 0; e < P::E; ++e) sq += (f[e] - mu) * (f[e] - mu);
      }
      const float inv = rsqrtf(group_sum<P::L>(sq) / C + kEps);
      if (r >= rows) continue;
#pragma unroll
      for (int k = 0; k < P::V; ++k) {
        const int vec = sub + k * P::L;
        if (src[u] >= 0) {
          unpack(v[u][k], f, T());
#pragma unroll
          for (int e4 = 0; e4 < P::E / 4; ++e4) {
            const float4 s = __ldg(sv + vec * (P::E / 4) + e4);
            const float4 b = __ldg(bv + vec * (P::E / 4) + e4);
            float* q = f + 4 * e4;
            q[0] = fmaf(s.x, inv * (q[0] - mu), b.x);
            q[1] = fmaf(s.y, inv * (q[1] - mu), b.y);
            q[2] = fmaf(s.z, inv * (q[2] - mu), b.z);
            q[3] = fmaf(s.w, inv * (q[3] - mu), b.w);
          }
          ov[r * P::NV + vec] = pack(f, T());
        } else {
          ov[r * P::NV + vec] = make_uint4(0, 0, 0, 0);
        }
      }
    }
  }
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
swin_from_windows_kernel(const T* __restrict__ y, const T* __restrict__ shortcut,
                         T* __restrict__ out, long long rows, Geometry g) {
  using P = RowPlan<T, C>;
  const int lane = threadIdx.x % 32, group = lane / P::L, sub = lane % P::L;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * kThreads / 32;
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  const uint4* sv = reinterpret_cast<const uint4*>(shortcut);
  uint4* ov = reinterpret_cast<uint4*>(out);
  constexpr int PER_WARP = P::G * P::U;
  for (long long base = warp * PER_WARP; base < rows; base += warps * PER_WARP) {
    uint4 a[P::U][P::V], b[P::U][P::V];
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const long long r = base + group + u * P::G;
      if (r >= rows) continue;
      const long long src = window_row(g, r);
#pragma unroll
      for (int k = 0; k < P::V; ++k) {
        a[u][k] = __ldg(sv + r * P::NV + sub + k * P::L);
        b[u][k] = __ldg(yv + src * P::NV + sub + k * P::L);
      }
    }
#pragma unroll
    for (int u = 0; u < P::U; ++u) {
      const long long r = base + group + u * P::G;
      if (r >= rows) continue;
#pragma unroll
      for (int k = 0; k < P::V; ++k) {
        float fa[P::E], fb[P::E];
        unpack(a[u][k], fa, T());
        unpack(b[u][k], fb, T());
#pragma unroll
        for (int e = 0; e < P::E; ++e) fa[e] += fb[e];
        ov[r * P::NV + sub + k * P::L] = pack(fa, T());
      }
    }
  }
}

// Blocks of the persistent grid: those of `kernel` resident on the card at
// once (asked at its first launch and kept in `resident`, one a kernel), or
// fewer where the rows need fewer.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int& resident, long long rows, int rows_per_block,
                     int* blocks) {
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long need = (rows + rows_per_block - 1) / rows_per_block;
  *blocks = static_cast<int>(need < resident ? need : resident);
  return cudaSuccess;
}

template <typename T, int C>
cudaError_t launch_to(const void* x, const void* scale, const void* bias, void* out,
                      long long rows, const Geometry& g, cudaStream_t stream) {
  auto kernel = swin_to_windows_kernel<T, C>;
  static int resident = 0;
  int blocks = 0;
  using P = RowPlan<T, C>;
  const cudaError_t err =
      grid_for(kernel, resident, rows, kThreads / 32 * P::G * P::U, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                          static_cast<const float*>(scale),
                                          static_cast<const float*>(bias),
                                          static_cast<T*>(out), rows, g);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch_from(const void* y, const void* shortcut, void* out, long long rows,
                        const Geometry& g, cudaStream_t stream) {
  auto kernel = swin_from_windows_kernel<T, C>;
  static int resident = 0;
  int blocks = 0;
  using P = RowPlan<T, C>;
  const cudaError_t err =
      grid_for(kernel, resident, rows, kThreads / 32 * P::G * P::U, &blocks);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(y),
                                          static_cast<const T*>(shortcut),
                                          static_cast<T*>(out), rows, g);
  return cudaGetLastError();
}

}  // namespace

// x [batch, h, w, c] and out [batch * nW, window^2, c] in bf16 (bf16 = 1) or
// float32; scale and bias [c] float32. c in 96 / 192 / 384 / 768 / 1536.
extern "C" int swin_glue_to_windows(const void* x, const void* scale, const void* bias,
                                    void* out, int batch, int h, int w, int c, int window,
                                    int shift, int is_bf16, void* stream) {
  const Geometry g = geometry(h, w, window, shift);
  const long long rows = static_cast<long long>(batch) * g.hp * g.wp;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWIN_GLUE_TO(C)                                                              \
  case C:                                                                            \
    return static_cast<int>(is_bf16 ? launch_to<bf16, C>(x, scale, bias, out, rows, g, s) \
                                    : launch_to<float, C>(x, scale, bias, out, rows, g, s));
  switch (c) {
    SWIN_GLUE_TO(96)
    SWIN_GLUE_TO(192)
    SWIN_GLUE_TO(384)
    SWIN_GLUE_TO(768)
    SWIN_GLUE_TO(1536)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_GLUE_TO
}

// y [batch * nW, window^2, c], shortcut and out [batch, h, w, c], all bf16
// (bf16 = 1) or float32. c in 96 / 192 / 384 / 768 / 1536.
extern "C" int swin_glue_from_windows(const void* y, const void* shortcut, void* out,
                                      int batch, int h, int w, int c, int window, int shift,
                                      int is_bf16, void* stream) {
  const Geometry g = geometry(h, w, window, shift);
  const long long rows = static_cast<long long>(batch) * h * w;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SWIN_GLUE_FROM(C)                                                               \
  case C:                                                                               \
    return static_cast<int>(is_bf16 ? launch_from<bf16, C>(y, shortcut, out, rows, g, s) \
                                    : launch_from<float, C>(y, shortcut, out, rows, g, s));
  switch (c) {
    SWIN_GLUE_FROM(96)
    SWIN_GLUE_FROM(192)
    SWIN_GLUE_FROM(384)
    SWIN_GLUE_FROM(768)
    SWIN_GLUE_FROM(1536)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SWIN_GLUE_FROM
}
