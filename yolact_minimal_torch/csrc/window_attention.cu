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
// Rounding places, as in the JAX kernel. bf16: q * scale is rounded to bf16
// (the scale rounded to bf16 first); scores, bias and the additive -100 add in
// float32; the softmax output is rounded to bf16; p v accumulates in float32
// and is rounded to bf16 once. float32: every step in float32, nothing
// rounded beyond float32's own arithmetic.
//
// What bounds it on an H100: bytes. qkv is read once and out written once
// (241 MB in bf16 at 6400 windows of C = 96, 0.072 ms at 3.35 TB/s) against
// 5.9 GFLOP of products (6 us on the tensor cores).
//
// bf16, for Hopper (sm_90a):
// - Work unit: one (window, head). A group of four warps takes a unit; warp
//   r owns query rows 16 r .. 16 r + 15 (49 rows padded to 64) against all 64
//   key columns (49 live, the rest -inf), so a row's max and sum need only
//   shuffles among the four lanes that hold it.
// - Loads: persistent blocks of two groups, two blocks a multiprocessor. A
//   group walks the windows of one head (kernel_geometry in
//   ops/window_attention.py fixes which); its unit's q, k and v tiles arrive by
//   TMA ([49, 32] boxes of qkv seen as a 2-D [B*nW*49, 3C] tensor, 64-byte
//   swizzle, so that ldmatrix reads them without bank conflicts) in a ring of
//   four slots with full and empty mbarriers. Lane 0 of the group's first
//   warp keeps the next two units in flight, so a window's loads run under
//   the products of the one before. Rows 49-63 of every slot are zeroed once
//   and never written by TMA, so p (0 there) never meets a stale inf.
// - Products on the tensor cores: q k^T and p v on mma.sync m16n8k16 (bf16
//   in, float32 accumulators); q is scaled and rounded in registers after
//   ldmatrix, p stays in registers as the A operand of p v, and v is read
//   through ldmatrix.trans. The kernel is byte-bound, so the product
//   instruction does not set its pace; mma.sync keeps a warp's 16 rows
//   independent of the other three.
// - The head's bias is read once a warp, for the whole walk, into registers
//   as packed bf16 pairs (14 of them: keys 56-63 are never computed); the
//   region ids of a window (196 bytes) are loaded per unit, before its tiles
//   are waited for, and compared through shuffles.
// - Stores: a warp stages its [16, 32] output tile in shared memory and
//   writes it with coalesced 16-byte stores.
// - Deterministic: a fixed unit order and no atomics.
// float32: one block of 64 threads per (window, head), the products on the
// CUDA cores summing in index order, so that a float32 run on the card can be
// held to a CPU run. q, k, v and the bias go to shared memory as float32;
// thread i < 49 owns query row i: its 49 scores overwrite its bias row in
// shared memory, the row softmax runs in its registers, and p v reads v rows
// as broadcasts.
#include "sm90.cuh"
#include "swin_common.cuh"

namespace {

using swin::bf16;
using swin::HD;
using swin::N;
using swin::round_to;
using swin::to_f;

// ------------------------------------------------------- bf16, Hopper -----

constexpr int GROUPS = 2;                   // groups of four warps a block
constexpr int MINB = 2;                     // blocks a multiprocessor
constexpr int BF_THREADS = GROUPS * 128;
constexpr int STAGES = 4;                   // ring slots a group
constexpr int LEAD = STAGES - 1;            // units in flight, the current one included
constexpr int TILE = 64 * 64;               // 64 rows of 64 bytes
constexpr int SLOT = 3 * TILE;              // q, k, v of one unit
constexpr int UNIT_BYTES = 3 * N * HD * 2;  // what TMA writes into a slot
constexpr int OUT_STAGE = 4 * 16 * 64;      // a group's output tiles, 16 rows a warp
constexpr int GROUP_SMEM = STAGES * SLOT + OUT_STAGE;
constexpr int BAR = GROUPS * GROUP_SMEM;    // per group full[STAGES], empty[STAGES]
constexpr int SMEM = BAR + GROUPS * 2 * STAGES * 8 + 1024;   // + room to align the base
static_assert(GROUP_SMEM % 1024 == 0, "tiles on 1024-byte boundaries");
static_assert(SMEM * MINB <= 232448, "shared memory");

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// A bf16 pair times the (bf16) scale, each product rounded to bf16.
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float scale) {
  const float2 f = unpack_bf16(v);
  return swin::pack_bf16(f.x * scale, f.y * scale);
}

// Group gid (of `groups`, a multiple of heads) takes head gid % heads and
// windows gid / heads, + per_head, ... below bnw.
__global__ void __launch_bounds__(BF_THREADS, MINB)
window_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm, const bf16* __restrict__ bias,
                             const int* __restrict__ region, bf16* __restrict__ out, int bnw,
                             int heads, int nw, int groups, int per_head) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int grp = threadIdx.x / 128, gtid = threadIdx.x % 128;
  const int warp = gtid / 32, lane = threadIdx.x % 32;
  unsigned char* gsm = smem + grp * GROUP_SMEM;
  const uint32_t ring = sm90::smem_addr(gsm);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR) + grp * 2 * STAGES;
  uint64_t* empty = full + STAGES;

  // rows N..63 of every tile of the ring are zero for good
  for (int e = gtid; e < STAGES * 3 * (64 - N) * 4; e += 128) {
    const int tile = e / ((64 - N) * 4), rest = e % ((64 - N) * 4);
    *reinterpret_cast<uint4*>(gsm + tile * TILE + (N + rest / 4) * 64 + (rest % 4) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (gtid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);            // every warp of the group releases every slot
    }
    sm90::fence_mbar_init();
  }
  sm90::fence_proxy_async();
  __syncthreads();
  const int gid = blockIdx.x * GROUPS + grp;
  if (gid >= groups) return;

  const int c = heads * HD;
  const int h = gid % heads, w0 = gid / heads;
  const int units = (bnw - 1 - w0) / per_head + 1;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;                // this thread's rows: row0, row0 + 8

  // The head's bias for this thread's scores: bz[nt][hi] = (row row0 + 8 hi;
  // keys 8 nt + 2 t, + 1), zero past the window.
  uint32_t bz[7][2];
  {
    const bf16* hb = bias + static_cast<size_t>(h) * N * N;
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = row0 + 8 * hi, key = 8 * nt + 2 * t;
        const float b0 = row < N && key < N ? to_f<bf16>(hb[row * N + key]) : 0.0f;
        const float b1 = row < N && key + 1 < N ? to_f<bf16>(hb[row * N + key + 1]) : 0.0f;
        bz[nt][hi] = swin::pack_bf16(b0, b1);
      }
  }
  const float scale = round_to<bf16>(swin::QK_SCALE);

  // Lane 0 of warp 0: start the copies of every unit before `upto`; unit v
  // waits for the release of unit v - STAGES.
  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto && issued < units; ++issued) {
      const int s = issued % STAGES;
      sm90::mbar_wait(empty + s, ((issued / STAGES) & 1) ^ 1);
      const int row = (w0 + issued * per_head) * N;
      const uint32_t dst = ring + s * SLOT;
      sm90::mbar_expect_tx(full + s, UNIT_BYTES);
      sm90::tma_load_2d(dst, &tm, h * HD, row, full + s);
      sm90::tma_load_2d(dst + TILE, &tm, c + h * HD, row, full + s);
      sm90::tma_load_2d(dst + 2 * TILE, &tm, 2 * c + h * HD, row, full + s);
    }
  };

  unsigned char* so = gsm + STAGES * SLOT + warp * 1024;    // this warp's output tile
  for (int u = 0; u < units; ++u) {
    if (gtid == 0) issue_upto(u + LEAD);
    __syncwarp();
    const int w = w0 + u * per_head;
    // the window's region ids: token j's in lane j % 32 of rl (j < 32) or rh
    int rl = 0, rh = 0;
    if (region != nullptr) {
      const int* rr = region + static_cast<size_t>(w % nw) * N;
      rl = rr[lane];
      rh = lane < N - 32 ? rr[32 + lane] : 0;
    }
    const int s = u % STAGES;
    sm90::mbar_wait(full + s, (u / STAGES) & 1);
    const unsigned char* tq = gsm + s * SLOT;
    const unsigned char* tk = tq + TILE;
    const unsigned char* tv = tq + 2 * TILE;

    // q: the A fragments of k-steps 0 and 16, scaled and rounded
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      swin::ldmatrix_x4(qa[ks], reinterpret_cast<const bf16*>(
                                    tq + sm90::sw64_offset(warp * 16 + lane % 16,
                                                           16 * ks + 8 * (lane / 16))));
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = scale_pair(qa[ks][i], scale);
    }
    // q k^T over keys 0..55 (n-tiles 0..6; keys 56..63 are dead)
    float sacc[7][4];
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b[4];
        swin::ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                                 tk + sm90::sw64_offset(kt * 16 + lane % 8 + 8 * (lane / 16),
                                                        16 * ks + 8 * ((lane / 8) % 2))));
        swin::mma_bf16(sacc[2 * kt], qa[ks], b[0], b[1]);
        if (2 * kt + 1 < 7) swin::mma_bf16(sacc[2 * kt + 1], qa[ks], b[2], b[3]);
      }

    // Which scores pair tokens of different regions: bit nt * 4 + i for
    // accumulator element i (row row0 + 8 (i / 2), key 8 nt + 2 t + i % 2).
    uint32_t differ = 0;
    if (region != nullptr) {
      int rrow[2];
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        rrow[hi] = __shfl_sync(0xffffffffu, warp < 2 ? rl : rh, min(row0 + 8 * hi, N - 1) % 32);
#pragma unroll
      for (int nt = 0; nt < 7; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kr = __shfl_sync(0xffffffffu, nt < 4 ? rl : rh,
                                     min(8 * nt + 2 * t + j, N - 1) % 32);
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            if (kr != rrow[hi]) differ |= 1u << (nt * 4 + hi * 2 + j);
        }
    }

    // + bias + mask, -inf past the window; row softmax over the four lanes
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 b = unpack_bf16(bz[nt][i / 2]);
        float sc = sacc[nt][i] + (i % 2 ? b.y : b.x);
        sc += (differ >> (nt * 4 + i)) & 1u ? swin::NEG : 0.0f;
        sc = 8 * nt + 2 * t + i % 2 < N ? sc : -INFINITY;
        sacc[nt][i] = sc;
        m[i / 2] = fmaxf(m[i / 2], sc);
      }
    float l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      m[hi] = fmaxf(m[hi], __shfl_xor_sync(0xffffffffu, m[hi], 1));
      m[hi] = fmaxf(m[hi], __shfl_xor_sync(0xffffffffu, m[hi], 2));
    }
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sacc[nt][i] = __expf(sacc[nt][i] - m[i / 2]);
        l[i / 2] += sacc[nt][i];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
      l[hi] = 1.0f / l[hi];
    }

    // p v: p (rounded to bf16) as the A operand, keys in k-steps of 16
    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4];
      a[0] = swin::pack_bf16(sacc[2 * ks][0] * l[0], sacc[2 * ks][1] * l[0]);
      a[1] = swin::pack_bf16(sacc[2 * ks][2] * l[1], sacc[2 * ks][3] * l[1]);
      if (2 * ks + 1 < 7) {
        a[2] = swin::pack_bf16(sacc[2 * ks + 1][0] * l[0], sacc[2 * ks + 1][1] * l[0]);
        a[3] = swin::pack_bf16(sacc[2 * ks + 1][2] * l[1], sacc[2 * ks + 1][3] * l[1]);
      } else {
        a[2] = a[3] = 0u;
      }
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t b[4];
        swin::ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(
                                       tv + sm90::sw64_offset(16 * ks + lane % 16,
                                                              16 * dp + 8 * (lane / 16))));
        swin::mma_bf16(o[2 * dp], a, b[0], b[1]);
        swin::mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);    // this warp is done with the slot

    // out: rounded once, staged, then 16 bytes a lane; rows past the window stay
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        *reinterpret_cast<uint32_t*>(so + sm90::sw64_offset(g + 8 * hi, 8 * nt + 2 * t)) =
            swin::pack_bf16(o[nt][2 * hi], o[nt][2 * hi + 1]);
    __syncwarp();
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int r = pass * 8 + lane / 4, row = warp * 16 + r;
      const uint4 v = *reinterpret_cast<const uint4*>(so + sm90::sw64_offset(r, 8 * (lane % 4)));
      if (row < N)
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(w) * N + row) * c + h * HD +
                                  8 * (lane % 4)) = v;
    }
    __syncwarp();                                   // so is rewritten by the next unit
  }
}

// qkv [rows, c3] bf16 in [N, 32] boxes, 64-byte swizzled.
bool qkv_map(CUtensorMap* map, const void* qkv, int rows, int c3) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(qkv) % 16 != 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c3), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c3) * sizeof(bf16)};
  const cuuint32_t box[2] = {HD, N};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(qkv), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const void* qkv, const void* bias, const int* region, void* out, int bnw,
                int heads, int nw, int blocks, int groups, int per_head, cudaStream_t stream) {
  if (blocks <= 0 || groups <= 0 || groups % heads != 0 || groups > blocks * GROUPS ||
      per_head <= 0 || groups / heads > bnw)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  if (!qkv_map(&tm, qkv, bnw * N, 3 * heads * HD) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(window_attention_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bf16_kernel<<<blocks, BF_THREADS, SMEM, stream>>>(
      tm, static_cast<const bf16*>(bias), region, static_cast<bf16*>(out), bnw, heads, nw, groups,
      per_head);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------- float32 -----

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
window_attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                            const int* __restrict__ region, float* __restrict__ out,
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
  const float* base = qkv + static_cast<size_t>(w) * N * 3 * c + h * HD;

  for (int e = tid; e < N * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const float* row = base + static_cast<size_t>(r) * 3 * c + d;
    sq[r][d] = row[0] * swin::QK_SCALE;
    sk[r][d] = row[c];
    sv[r][d] = row[2 * c];
  }
  const float* hbias = bias + static_cast<size_t>(h) * N * N;
  for (int e = tid; e < N * N; e += THREADS) ss[e] = hbias[e];
  const bool masked = region != nullptr;
  if (masked && tid < N) sreg[tid] = region[static_cast<size_t>(w % nw) * N + tid];
  __syncthreads();

  // Thread i < 49 owns query row i; its result replaces its row of sq.
  if (tid < N)
    swin::attention_row<float>(sq[tid], &sk[0][0], &sv[0][0], ss + tid * N,
                           masked ? sreg : nullptr, tid);
  __syncthreads();

  float* obase = out + static_cast<size_t>(w) * N * c + h * HD;
  for (int e = tid; e < N * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    obase[static_cast<size_t>(r) * c + d] = sq[r][d];
  }
}

}  // namespace

// qkv [bnw, 49, 3 * heads * 32], bias [heads, 49, 49], region [nw, 49] int32
// or null, out [bnw, 49, heads * 32]; qkv, bias and out are bf16 when is_bf16
// is nonzero, else float32. blocks, groups and per_head are the bf16
// launch's geometry (ops/window_attention.py::kernel_geometry); the float32
// launch ignores them.
extern "C" int window_attention(const void* qkv, const void* bias, const void* region, void* out,
                                int bnw, int heads, int nw, int is_bf16, int blocks, int groups,
                                int per_head, void* stream) {
  if (bnw <= 0 || heads <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* reg = static_cast<const int*>(region);
  if (is_bf16)
    return launch_bf16(qkv, bias, reg, out, bnw, heads, nw, blocks, groups, per_head, s);
  window_attention_f32_kernel<<<dim3(bnw, heads), THREADS, 0, s>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias), reg,
      static_cast<float*>(out), heads, nw);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel's compiled shape into g[0..7): groups a block, blocks a
// multiprocessor, ring slots a group, threads a block, dynamic shared memory
// bytes a block, registers a thread, local (spill) bytes a thread.
extern "C" int window_attention_attributes(int* g) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, window_attention_bf16_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[7] = {GROUPS, MINB, STAGES, BF_THREADS, SMEM, attr.numRegs,
                    static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 7; ++i) g[i] = v[i];
  return 0;
}
