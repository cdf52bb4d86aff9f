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
// proto read, ~0.15 ms at 3.35 TB/s. Nearly all of those bytes are zeros:
// an output pixel can only be true if one of its taps is a proto pixel that
// the crop keeps, and a detection's crop box covers a few percent of the
// plane. So the kernel finds each slot's output window [oy0, oy1) x
// [ox0, ox1) in O(1) from its crop box and the first/last tables
// (ops/mask_finalize.py::_tables: for each proto row and column, the first
// output whose taps reach it or beyond and the last whose taps reach it or
// before) and splits each (slot, band of band_rows output rows) work item:
//
//   - the zero region, every byte outside the window and all of an invalid
//     slot, is written with 16-byte stores of zeros (byte stores only where a
//     band's ends are not 16-byte aligned), with no table load and no
//     arithmetic; in a band that meets the window these stores go first and
//     hide the latency of the window's loads;
//   - inside the window the block computes the lincomb only on the proto
//     pixels of crop box x the band rows' taps (8 x 16-byte loads a pixel,
//     the fmaf order over k and the sigmoid of the kernel this one
//     replaced), loads the row taps once a row and mixes each window row's
//     two proto rows once a tile column, all in shared memory, with the
//     column taps loaded once a block. Each thread then produces 16
//     consecutive output bytes (two shared loads and one mix a byte, lanes
//     staggered so that a step's loads meet no bank conflict) and stores
//     them at once. No integer division runs per output byte.
//
// Grid: as many persistent blocks as stay resident (6 of 256 threads a
// multiprocessor, ops/mask_finalize.py::kernel_geometry). A block takes the
// next untaken item when it is done with its own, so the few window items
// spread over the blocks and no block is left with a tail of them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 6;        // resident a multiprocessor: 40 registers a thread
constexpr int kChunk = 16;           // bytes of one vector store

__device__ __forceinline__ void sanitize(float a, float b, int size,
                                         float* lo, float* hi) {
  // ops/boxes.py::sanitize_coordinates with padding=1, in the same order.
  a = __fmul_rn(a, static_cast<float>(size));
  b = __fmul_rn(b, static_cast<float>(size));
  *lo = fmaxf(__fsub_rn(fminf(a, b), 1.0f), 0.0f);
  *hi = fminf(__fadd_rn(fmaxf(a, b), 1.0f), static_cast<float>(size));
}

struct Tables {
  const int *lo_h, *hi_h;
  const float* fh;
  const int *lo_w, *hi_w;
  const float* fw;
  // first output row (column) whose taps reach proto row (column) r or
  // beyond, and last whose taps reach r or before
  const int *first_h, *last_h, *first_w, *last_w;
};

// One slot's output window [oy0, oy1) x [ox0, ox1) and the proto rectangle
// [r0, r1) x [c0, c1) that its crop keeps; empty (oy0 >= oy1) for a slot
// with nothing to compute.
struct Window {
  int oy0, oy1, ox0, ox1, r0, r1, c0, c1;
};

__device__ __forceinline__ Window slot_window(const Tables& t, const float* boxes,
                                              const uint8_t* valid, int slot, int ph,
                                              int pw, int do_crop) {
  Window w{0, 0, 0, 0, 0, ph, 0, pw};
  // valid and the box in one round of loads, the tables in the next
  const bool ok = valid[slot] != 0;
  const float* bx = boxes + static_cast<size_t>(slot) * 4;
  const float bx0 = bx[0], by0 = bx[1], bx1 = bx[2], by1 = bx[3];
  if (!ok) return w;
  if (do_crop) {
    float x1, x2, y1, y2;
    sanitize(bx0, bx1, pw, &x1, &x2);
    sanitize(by0, by1, ph, &y1, &y2);
    // the integers c with x1 <= c < x2: [ceil(x1), ceil(x2)); x1, y1 lie in
    // [0, size], x2, y2 at most size
    w.c0 = static_cast<int>(ceilf(x1));
    w.c1 = static_cast<int>(ceilf(x2));
    w.r0 = static_cast<int>(ceilf(y1));
    w.r1 = static_cast<int>(ceilf(y2));
    if (w.c0 >= w.c1 || w.r0 >= w.r1) return w;
  }
  w.oy0 = t.first_h[w.r0];
  w.oy1 = t.last_h[w.r1 - 1] + 1;
  w.ox0 = t.first_w[w.c0];
  w.ox1 = t.last_w[w.c1 - 1] + 1;
  if (w.ox0 >= w.ox1) w.oy1 = w.oy0;
  return w;
}

// The 16-byte aligned middle [a, e) of the bytes [f0, f1): a is f0 rounded
// up, e is f1 rounded down, and a == e where no whole chunk fits.
__device__ __forceinline__ void aligned_middle(size_t f0, size_t f1, size_t* a, size_t* e) {
  const size_t mask = ~static_cast<size_t>(kChunk - 1);
  const size_t up = (f0 + kChunk - 1) & mask, down = f1 & mask;
  *a = up < f1 ? up : f1;
  *e = down > *a ? down : *a;
}

// Zeros over the bytes [f0, f1) of out: 16-byte stores on the aligned middle,
// byte stores on the ends.
__device__ __forceinline__ void zero_range(uint8_t* __restrict__ out, size_t f0, size_t f1) {
  size_t a, e;
  aligned_middle(f0, f1, &a, &e);
  const uint4 z = make_uint4(0, 0, 0, 0);
  for (size_t p = a + static_cast<size_t>(threadIdx.x) * kChunk; p < e;
       p += static_cast<size_t>(blockDim.x) * kChunk)
    *reinterpret_cast<uint4*>(out + p) = z;
  const int head = static_cast<int>(a - f0), tail = static_cast<int>(f1 - e);
  if (static_cast<int>(threadIdx.x) < head) out[f0 + threadIdx.x] = 0;
  else if (static_cast<int>(threadIdx.x) < head + tail) out[e + threadIdx.x - head] = 0;
}

// A walk over the cells of a grid `cols` wide, cell first, first + stride,
// ...: the first cell's row and column by one division, then stepped
// without one.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int first, int stride, int cols_)
      : r(first / cols_), c(first % cols_), dr(stride / cols_), dc(stride % cols_),
        cols(cols_) {}
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) { c -= cols; ++r; }
  }
};

// What the second pass of a window item reads: the rows' mix of the m tile
// in shared memory, the column taps, and the window.
struct Band {
  const float* rm;       // [wy1 - wy0, tw]: each window row's mix of its two proto rows
  const uint32_t* col;   // per output column: lo_w | hi_w << 16
  const float* wx;       // per output column: fw
  int y0, y1, wy0, wy1, ox0, ox1, tw, tc0;
};

__device__ __forceinline__ bool row_in(const Band& bd, int y) {
  return y >= bd.wy0 && y < bd.wy1;
}

// The index into rm of row y's proto column 0 (meaningful inside the window).
__device__ __forceinline__ int rm_base(const Band& bd, int y) {
  return (y - bd.wy0) * bd.tw - bd.tc0;
}

// The output byte at column x of a row whose mix starts at rm[base]: 0
// outside the window, else the columns' mix > 0.5, as (1 - w) * a + w * b
// with one explicit rounding per operation.
__device__ __forceinline__ uint32_t interp(const Band& bd, bool in, int base, int x) {
  if (!in || x < bd.ox0 || x >= bd.ox1) return 0u;
  const uint32_t c = bd.col[x];
  const float wx = bd.wx[x];
  const float left = bd.rm[base + static_cast<int>(c & 0xffffu)];
  const float right = bd.rm[base + static_cast<int>(c >> 16)];
  return __fmaf_rn(__fsub_rn(1.0f, wx), left, __fmul_rn(wx, right)) > 0.5f ? 1u : 0u;
}

// The byte at row y, column x of the band's slot plane.
__device__ __forceinline__ uint32_t band_byte(const Band& bd, int y, int x) {
  return interp(bd, row_in(bd, y), rm_base(bd, y), x);
}

// 16 bits, bit j for byte j, as 16 bytes of 0 or 1: a nibble times
// 0x204081 puts its bits 0-3 at bits 0, 8, 16 and 24, without carries.
__device__ __forceinline__ uint4 bits_to_bytes(uint32_t bits) {
  return make_uint4(((bits & 15u) * 0x204081u) & 0x01010101u,
                    (((bits >> 4) & 15u) * 0x204081u) & 0x01010101u,
                    (((bits >> 8) & 15u) * 0x204081u) & 0x01010101u,
                    (((bits >> 12) & 15u) * 0x204081u) & 0x01010101u);
}

// The bytes [f0, f1) of a window band whose first byte is row y0, column 0,
// in two passes: kHits false writes the aligned 16-byte chunks that miss the
// window, zeros without any load, and needs no shared memory; kHits true
// computes the chunks that meet it and the unaligned ends byte by byte.
template <bool kHits>
__device__ __forceinline__ void window_range(uint8_t* __restrict__ out, const Band& bd,
                                             size_t f0, size_t f1, int s) {
  size_t a, e;
  aligned_middle(f0, f1, &a, &e);
  Walk cell(static_cast<int>(a - f0) + static_cast<int>(threadIdx.x) * kChunk,
            static_cast<int>(blockDim.x) * kChunk, s);
  for (size_t p = a + static_cast<size_t>(threadIdx.x) * kChunk; p < e;
       p += static_cast<size_t>(blockDim.x) * kChunk, cell.next()) {
    const int y = bd.y0 + cell.r, x = cell.c;
    bool hit;
    if (s < kChunk) {
      hit = true;
    } else if (x + kChunk <= s) {
      hit = row_in(bd, y) && x < bd.ox1 && x + kChunk > bd.ox0;
    } else {         // the chunk ends in the next row
      hit = (row_in(bd, y) && x < bd.ox1) || (row_in(bd, y + 1) && x + kChunk - s > bd.ox0);
    }
    if (hit != kHits) continue;      // the other pass writes this chunk
    uint32_t bits = 0;
    if (!kHits) {
      // zeros
    } else if (s >= kChunk) {
      // the chunk's rows: y, and y + 1 where it ends in the next row
      const bool in_a = row_in(bd, y), in_b = row_in(bd, y + 1);
      const int base_a = rm_base(bd, y), base_b = base_a + bd.tw;
      const int lane = static_cast<int>(threadIdx.x) & 31;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        // each lane starts at another byte of its chunk, so that at one step
        // the lanes' column taps lie in 32 banks of shared memory, not in 2
        const int jj = (j + lane) & (kChunk - 1);
        const bool next = x + jj >= s;
        bits |= interp(bd, next ? in_b : in_a, next ? base_b : base_a,
                       next ? x + jj - s : x + jj) << jj;
      }
    } else {         // rows shorter than a chunk
      int yy = y, xx = x;
      for (int j = 0; j < kChunk; ++j, ++xx) {
        while (xx >= s) { xx -= s; ++yy; }
        bits |= band_byte(bd, yy, xx) << j;
      }
    }
    *reinterpret_cast<uint4*>(out + p) = bits_to_bytes(bits);
  }
  if (!kHits) return;
  // unaligned ends: at most 15 bytes after f0 and 15 before f1
  const int head = static_cast<int>(a - f0), tail = static_cast<int>(f1 - e);
  const int t = static_cast<int>(threadIdx.x);
  if (t < head) {
    int yy = bd.y0, xx = t;
    while (xx >= s) { xx -= s; ++yy; }
    out[f0 + t] = static_cast<uint8_t>(band_byte(bd, yy, xx));
  } else if (t < head + tail) {
    // f1 is the first byte of row y1, the band's end; walk back
    const int back = tail - (t - head);
    int yy = bd.y1, xx = -back;
    while (xx < 0) { xx += s; --yy; }
    out[f1 - back] = static_cast<uint8_t>(band_byte(bd, yy, xx));
  }
}

// sigmoid(coef . px) over nc channels, fmaf in the order k = 0..nc-1.
__device__ __forceinline__ float lincomb(const float* __restrict__ px,
                                         const float* __restrict__ coef, int nc) {
  float acc = 0.0f;
  if (nc == 32) {        // all eight 16-byte loads in flight at once
    const float4* px4 = reinterpret_cast<const float4*>(px);
    float4 q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) q[i] = __ldg(px4 + i);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc = fmaf(coef[4 * i + 0], q[i].x, acc);
      acc = fmaf(coef[4 * i + 1], q[i].y, acc);
      acc = fmaf(coef[4 * i + 2], q[i].z, acc);
      acc = fmaf(coef[4 * i + 3], q[i].w, acc);
    }
  } else {
    for (int k = 0; k < nc; ++k) acc = fmaf(coef[k], __ldg(px + k), acc);
  }
  return 1.0f / (1.0f + expf(-acc));
}

// The next work item of a block: the first is blockIdx.x, then each block
// takes the next untaken one from work[0] when it is done with its own, so
// that blocks that drew many window items take fewer items in all. The
// block that finishes last sets work[0] and work[1] back to 0 for the next
// launch on the stream.
__device__ __forceinline__ long long next_item(unsigned int* work, long long* s_item) {
  __syncthreads();
  if (threadIdx.x == 0) *s_item = static_cast<long long>(gridDim.x) + atomicAdd(work, 1u);
  __syncthreads();
  return *s_item;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
mask_finalize_kernel(const float* __restrict__ proto, const float* __restrict__ coefs,
                     const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                     Tables t, uint8_t* __restrict__ out, unsigned int* __restrict__ work,
                     int ph, int pw, int nc, int n_slots, int d_slots, int s, int band_rows,
                     int tile_rows, int do_crop) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* s_col = reinterpret_cast<uint32_t*>(smem_raw);            // [s]
  float* s_wx = reinterpret_cast<float*>(s_col + s);                  // [s]
  float* s_coef = s_wx + s;                                           // [nc]
  int* s_top = reinterpret_cast<int*>(s_coef + nc);                   // [band_rows]
  int* s_bot = s_top + band_rows;                                     // [band_rows]
  float* s_wy = reinterpret_cast<float*>(s_bot + band_rows);          // [band_rows]
  float* s_m = s_wy + band_rows;                                      // [tile_rows, pw]
  float* s_rm = s_m + static_cast<size_t>(tile_rows) * pw;            // [band_rows, pw]

  // column taps, once a block
  for (int x = threadIdx.x; x < s; x += blockDim.x) {
    s_col[x] = static_cast<uint32_t>(t.lo_w[x]) | (static_cast<uint32_t>(t.hi_w[x]) << 16);
    s_wx[x] = t.fw[x];
  }
  __syncthreads();

  const int n_bands = (s + band_rows - 1) / band_rows;
  const long long n_items = static_cast<long long>(n_slots) * n_bands;
  __shared__ long long s_item;
  for (long long item = blockIdx.x; item < n_items; item = next_item(work, &s_item)) {
    const int slot = static_cast<int>(item / n_bands);
    const int band = static_cast<int>(item - static_cast<long long>(slot) * n_bands);
    const int y0 = band * band_rows, y1 = min(y0 + band_rows, s);
    const size_t f0 = (static_cast<size_t>(slot) * s + y0) * s;
    const size_t f1 = (static_cast<size_t>(slot) * s + y1) * s;
    const Window w = slot_window(t, boxes, valid, slot, ph, pw, do_crop);
    const int wy0 = max(y0, w.oy0), wy1 = min(y1, w.oy1);
    if (wy0 >= wy1) {                // nothing of the window in this band
      zero_range(out, f0, f1);
      continue;
    }
    // the m tile: proto rows of the window rows' taps x proto columns of the
    // window columns' taps, 0 outside the crop
    const int tr0 = t.lo_h[wy0], tr1 = t.hi_h[wy1 - 1] + 1;
    const int tc0 = t.lo_w[w.ox0], tc1 = t.hi_w[w.ox1 - 1] + 1;
    const int tw = tc1 - tc0, rows = wy1 - wy0;
    const Band bd{s_rm, s_col, s_wx, y0, y1, wy0, wy1, w.ox0, w.ox1, tw, tc0};
    // the slot's coefficients and the window rows' taps (once a row; rows <=
    // band_rows <= blockDim.x) are loaded now and stored to shared memory
    // after the zero chunks, whose stores need no shared memory and hide
    // the loads' latency
    const int tid = threadIdx.x;
    const float coef = tid < nc ? coefs[static_cast<size_t>(slot) * nc + tid] : 0.0f;
    const int lo = tid < rows ? t.lo_h[wy0 + tid] : 0, hi = tid < rows ? t.hi_h[wy0 + tid] : 0;
    const float fy = tid < rows ? t.fh[wy0 + tid] : 0.0f;
    window_range<false>(out, bd, f0, f1, s);
    __syncthreads();                 // the previous window item is done with shared memory
    for (int k = tid; k < nc; k += blockDim.x)
      s_coef[k] = k == tid ? coef : coefs[static_cast<size_t>(slot) * nc + k];
    if (tid < rows) {
      s_top[tid] = (lo - tr0) * tw;
      s_bot[tid] = (hi - tr0) * tw;
      s_wy[tid] = fy;
    }
    __syncthreads();
    const float* img = proto + static_cast<size_t>(slot / d_slots) * ph * pw * nc;
    const int kr0 = max(tr0, w.r0) - tr0, kr1 = min(tr1, w.r1) - tr0;
    const int kc0 = max(tc0, w.c0) - tc0, kc1 = min(tc1, w.c1) - tc0;
    const int n_px = (tr1 - tr0) * tw;
    Walk px(threadIdx.x, blockDim.x, tw);
    for (int p = threadIdx.x; p < n_px; p += blockDim.x, px.next()) {
      const bool kept = px.r >= kr0 && px.r < kr1 && px.c >= kc0 && px.c < kc1;
      s_m[p] = kept ? lincomb(img + (static_cast<size_t>(tr0 + px.r) * pw + tc0 + px.c) * nc,
                              s_coef, nc)
                    : 0.0f;
    }
    __syncthreads();
    // each window row's mix of its two proto rows, at every tile column:
    // (1 - wy) * top + wy * bot, as the bilinear sample mixes rows first
    Walk rc(threadIdx.x, blockDim.x, tw);
    for (int i = threadIdx.x; i < rows * tw; i += blockDim.x, rc.next()) {
      const float wy = s_wy[rc.r];
      s_rm[i] = __fmaf_rn(__fsub_rn(1.0f, wy), s_m[s_top[rc.r] + rc.c],
                          __fmul_rn(wy, s_m[s_bot[rc.r] + rc.c]));
    }
    __syncthreads();
    window_range<true>(out, bd, f0, f1, s);
  }
  if (threadIdx.x == 0 && atomicAdd(work + 1, 1u) == gridDim.x - 1) {
    work[0] = 0;
    work[1] = 0;
  }
}

size_t smem_bytes(int s, int nc, int band_rows, int tile_rows, int pw) {
  return (2 * static_cast<size_t>(s) + nc + 3 * static_cast<size_t>(band_rows) +
          static_cast<size_t>(tile_rows + band_rows) * pw) * 4;
}

}  // namespace

// proto [b, ph, pw, nc] float32 (16-byte aligned), coefs [b, d, nc],
// boxes [b, d, 4] float32, valid [b, d] bool, the ten int32/float32 tables
// of ops/mask_finalize.py::_tables (lo_h, hi_h, fh [s]; lo_w, hi_w, fw [s];
// first_h, last_h [ph]; first_w, last_w [pw]), out [b, d, s, s] bool.
// work is two uint32 counters, 0 before the launch and left 0 after it (one
// pair a stream: launches on one stream never overlap). tile_rows is the
// most proto rows the taps of one band of band_rows output rows reach;
// blocks is kernel_geometry's grid.
extern "C" int mask_finalize(const void* proto, const void* coefs, const void* boxes,
                             const void* valid, const void* const* tables, void* out,
                             void* work, int b, int ph, int pw, int nc, int d_slots, int s,
                             int band_rows, int tile_rows, int do_crop, int blocks,
                             void* stream) {
  if (b <= 0 || d_slots <= 0 || s <= 0) return 0;
  if (blocks <= 0 || band_rows > kThreads)   // a window item loads its row taps one a thread
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = smem_bytes(s, nc, band_rows, tile_rows, pw);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mask_finalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Tables t{static_cast<const int*>(tables[0]),   static_cast<const int*>(tables[1]),
                 static_cast<const float*>(tables[2]), static_cast<const int*>(tables[3]),
                 static_cast<const int*>(tables[4]),   static_cast<const float*>(tables[5]),
                 static_cast<const int*>(tables[6]),   static_cast<const int*>(tables[7]),
                 static_cast<const int*>(tables[8]),   static_cast<const int*>(tables[9])};
  mask_finalize_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proto), static_cast<const float*>(coefs),
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid), t,
      static_cast<uint8_t*>(out), static_cast<unsigned int*>(work), ph, pw, nc, b * d_slots,
      d_slots, s, band_rows, tile_rows, do_crop);
  return static_cast<int>(cudaGetLastError());
}

// The launch geometry into g[0..8): blocks, threads a block, blocks
// resident a multiprocessor, multiprocessors, dynamic shared memory bytes a
// block, registers a thread, local (spill) bytes a thread, work items
// (slots x bands). blocks is the resident count on the current card, at most
// one a work item.
extern "C" int mask_finalize_geometry(int n_slots, int s, int nc, int band_rows,
                                      int tile_rows, int pw, int* g) {
  const size_t smem = smem_bytes(s, nc, band_rows, tile_rows, pw);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(mask_finalize_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mask_finalize_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, mask_finalize_kernel)) != cudaSuccess)
    return static_cast<int>(err);
  const long long items = static_cast<long long>(n_slots) * ((s + band_rows - 1) / band_rows);
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long blocks = items < resident ? items : resident;
  const int v[8] = {static_cast<int>(blocks), kThreads, per_sm, sms, static_cast<int>(smem),
                    attr.numRegs, static_cast<int>(attr.localSizeBytes),
                    static_cast<int>(items < 0x7fffffff ? items : 0x7fffffff)};
  for (int i = 0; i < 8; ++i) g[i] = v[i];
  return 0;
}
