// Shifted-window attention on packed qkv, one launch for all windows and heads.
//
// Replaces the Pallas TPU kernel yolact_minimal_tpu/ops/window_attention.py::
// window_attention_fused (_kernel). For window w and head h:
//
//     out[w, :, h*32:(h+1)*32] =
//         softmax(q k^T * 32^-0.5 + bias[h] + (-100 where region ids differ)) v
//
// with q, k, v the head's [49, 32] slices of qkv[w] = [49, q | k | v] (Swin-L's
// 12x12 windows: [144, 32], in window_attention_n144_bf16_kernel below). The
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
//
// The backward, bf16 (window_attention_bwd_bf16_kernel, then
// window_attention_bwd_bias_kernel), is a design for the card with no TPU
// counterpart: the JAX package's custom_vjp (_fused_bwd) recomputes the
// attention plainly through XLA, as the float32 path and the CPU do here
// (ops/window_attention.py::window_attention_backward_plain). For window w,
// head h and the incoming gradient dO of out[w, :, h*32:(h+1)*32]:
//
//     S = q_s k^T + bias[h] + mask,  P = softmax(S),  dV = bf16(P)^T dO,
//     dP = dO v^T,  dS = P (dP - rowsum(P dP)),  dq_s = dS k,  dk = dS^T q_s,
//     d_bias[h] = the sum over windows of dS
//
// with q_s = bf16(q * bf16(scale)) as the forward rounds it. Rounding places,
// the plain backward's: q_s, k, v, dO and bf16(P) are bf16 operands; every
// product and sum accumulates in float32; dP is rounded to bf16 where the
// plain backward's cast of P rounds its gradient; P stays float32 for dS;
// dS is never rounded to bf16 (its products take it as a hi / lo pair of
// bf16 operands, hi = bf16(dS), lo = bf16(dS - hi)); dq_s, dk, dv and
// d_bias are rounded to bf16 once, and dq = bf16(bf16(dq_s) * bf16(scale)),
// as the plain backward's product with the scale rounds it.
//
// What bounds it on an H100: bytes. qkv and dO are read once and d_qkv written
// once, 14 C bytes a padded row (1.69 GB at 25600 windows of C = 96, 0.50 ms at
// 3.35 TB/s), against five products of 2 * 49 * 49 * 32 operations a (window,
// head), 0.06 ms on the tensor cores there. The plain recompute instead passes
// [B*nW, heads, 49, 49] float32 tensors through device memory a dozen times.
//
// - A 49-token window is one tile: a (window, head) unit recomputes S and the
//   whole softmax P inside it, so nothing of the forward is saved beyond qkv
//   and the bias, and no online softmax is needed.
// - Work and loads as the forward's: a group of four warps walks the windows
//   of one head (backward_geometry in ops/window_attention.py deals them as
//   kernel_geometry does); q, k, v and dO arrive by TMA into a ring of three
//   slots, the next unit's under the current one's products. One group a
//   block, three blocks a multiprocessor: the unit's P and dS tiles take 24 KB
//   of shared memory beside the ring, and a thread's 168 registers keep P, dP
//   and the head's d_bias partial live at once.
// - Warp r first owns query rows 16 r .. 16 r + 15 against all keys: S and P
//   (mma.sync, as the forward), dP = dO v^T, D and dS in registers, then
//   dq_s = dS k with dS as the A operand. It writes bf16(P) and dS hi / lo
//   into shared memory; after a block barrier it owns keys 16 r .. 16 r + 15
//   and reads them back transposed (ldmatrix.trans) as the A operand of
//   dv = P^T dO and dk = dS^T q_s.
// - Stores: the four lanes of a quad trade their accumulator pairs through
//   shuffles so that each lane holds 8 consecutive columns of a row; every row
//   of dq, dk and dv is one 64-byte segment, written straight into d_qkv's
//   [B*nW, 49, 3C] layout.
// - d_bias: each thread keeps its scores' float32 partial over the group's
//   walk in registers and writes it once to a [groups, 49, 49] buffer; a
//   second launch sums a head's partials in a fixed order. Deterministic: no
//   atomics anywhere.
#include "sm90.cuh"
#include "swin_common.cuh"
#include "swin_tiled.cuh"

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

// qkv [rows, c3] bf16 in [box_rows, 32] boxes, 64-byte swizzled.
bool qkv_map(CUtensorMap* map, const void* qkv, int rows, int c3, int box_rows = N) {
  sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(qkv) % 16 != 0) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c3), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c3) * sizeof(bf16)};
  const cuuint32_t box[2] = {HD, static_cast<cuuint32_t>(box_rows)};
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

// ------------------------------------------------ bf16, 144 tokens, Hopper -----
//
// Swin-L's 12x12 windows: the same function and rounding places as the
// 49-token kernel above, tiled for N = 144 = 9 tiles of 16 rows.
// - Work unit: one (window, head). A group of three warps takes a unit; warp
//   r owns row tiles r, r + 3 and r + 6 in turn, each against all 144 keys
//   (18 n8 tiles, 72 scores a thread): a row's whole score vector stays in
//   the registers of the four lanes that hold it, so, as at 49 tokens, the
//   softmax needs no running max and nothing is saved. No row or key is
//   padding.
// - Loads: a block holds three groups, all on one head (wide_geometry in
//   ops/window_attention.py deals each head's windows to per_head blocks and
//   inside a block round-robin to its groups); one block a multiprocessor.
//   The head's [144, 144] bias is copied once a block into shared memory,
//   rows padded to 152 elements so that a quad's reads hit distinct banks. A
//   unit's q, k and v tiles ([144, 32] TMA boxes of qkv, 64-byte swizzle)
//   arrive in a group's ring of two slots; lane 0 of the group's first warp
//   issues the next unit while the current one is computed.
// - Region ids: a thread keeps those of its 36 keys packed four bits each
//   (ids of the shifted partition are 0..8), read once a unit.
// - Products, softmax and stores as in the 49-token kernel.
namespace n144 {
constexpr int N = 144;                       // tokens of a 12x12 window
constexpr int KT = N / 16;                   // 16-key tiles (k-steps of p v)
constexpr int NT = N / 8;                    // 8-key tiles of the scores
constexpr int WARPS = 3;                     // warps of a group
constexpr int TILES = KT / WARPS;            // row tiles a warp
constexpr int GROUPS = 3;                    // groups a block, all on one head
constexpr int THREADS = GROUPS * WARPS * 32;
constexpr int STAGES = 2;                    // ring slots a group
constexpr int LEAD = STAGES;                 // units in flight, the current one included
constexpr int TILE = N * 64;                 // 144 rows of 64 bytes
constexpr int SLOT = 3 * TILE;               // q, k, v of one unit
constexpr int UNIT_BYTES = 3 * N * HD * 2;   // what TMA writes into a slot
constexpr int BIAS_LD = N + 8;               // elements a bias row in shared memory
constexpr int BIAS = GROUPS * STAGES * SLOT; // offset of the bias
constexpr int OUT = BIAS + N * BIAS_LD * 2;  // offset of the warps' output tiles
constexpr int BAR = OUT + GROUPS * WARPS * 1024;   // per group full[STAGES], empty[STAGES]
constexpr int SMEM = BAR + GROUPS * 2 * STAGES * 8 + 1024;   // + room to align the base
static_assert(SLOT % 1024 == 0 && BIAS % 1024 == 0, "tiles on 1024-byte boundaries");
static_assert(KT % WARPS == 0, "whole row tiles a warp");
static_assert(SMEM <= 232448, "shared memory");
}  // namespace n144

// Block b takes head b % heads; its group gi walks windows (b / heads) *
// GROUPS + gi, + per_head * GROUPS, ... below bnw.
__global__ void __launch_bounds__(n144::THREADS, 1)
window_attention_n144_bf16_kernel(const __grid_constant__ CUtensorMap tm,
                                  const bf16* __restrict__ bias, const int* __restrict__ region,
                                  bf16* __restrict__ out, int bnw, int heads, int nw,
                                  int per_head) {
  // n144's sizes, over the anonymous namespace's 49-token ones
  constexpr int N = n144::N, KT = n144::KT, NT = n144::NT, WARPS = n144::WARPS;
  constexpr int TILES = n144::TILES, GROUPS = n144::GROUPS, THREADS = n144::THREADS;
  constexpr int STAGES = n144::STAGES, LEAD = n144::LEAD, TILE = n144::TILE;
  constexpr int SLOT = n144::SLOT, UNIT_BYTES = n144::UNIT_BYTES, BIAS_LD = n144::BIAS_LD;
  constexpr int BIAS = n144::BIAS, OUT = n144::OUT, BAR = n144::BAR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int grp = threadIdx.x / (WARPS * 32), gtid = threadIdx.x % (WARPS * 32);
  const int warp = gtid / 32, lane = threadIdx.x % 32;
  unsigned char* gsm = smem + grp * STAGES * SLOT;
  const uint32_t ring = sm90::smem_addr(gsm);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BAR) + grp * 2 * STAGES;
  uint64_t* empty = full + STAGES;
  const int h = blockIdx.x % heads;
  const int c = heads * HD;

  // the head's bias, rows padded to BIAS_LD elements, 16 bytes a copy
  unsigned char* sb = smem + BIAS;
  {
    const uint4* hb = reinterpret_cast<const uint4*>(bias + static_cast<size_t>(h) * N * N);
    for (int e = threadIdx.x; e < N * (N / 8); e += THREADS)
      *reinterpret_cast<uint4*>(sb + (e / (N / 8)) * BIAS_LD * 2 + (e % (N / 8)) * 16) = hb[e];
  }
  if (gtid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, WARPS);        // every warp of the group releases every slot
    }
    sm90::fence_mbar_init();
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const int stride = per_head * GROUPS;
  const int w0 = (blockIdx.x / heads) * GROUPS + grp;
  const int units = w0 < bnw ? (bnw - 1 - w0) / stride + 1 : 0;
  const int g = lane / 4, t = lane % 4;
  const float scale = round_to<bf16>(swin::QK_SCALE);

  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto && issued < units; ++issued) {
      const int s = issued % STAGES;
      sm90::mbar_wait(empty + s, ((issued / STAGES) & 1) ^ 1);
      const int row = (w0 + issued * stride) * N;
      const uint32_t dst = ring + s * SLOT;
      sm90::mbar_expect_tx(full + s, UNIT_BYTES);
      sm90::tma_load_2d(dst, &tm, h * HD, row, full + s);
      sm90::tma_load_2d(dst + TILE, &tm, c + h * HD, row, full + s);
      sm90::tma_load_2d(dst + 2 * TILE, &tm, 2 * c + h * HD, row, full + s);
    }
  };

  unsigned char* so = smem + OUT + (grp * WARPS + warp) * 1024;   // this warp's output tile
  for (int u = 0; u < units; ++u) {
    if (gtid == 0) issue_upto(u + LEAD);
    __syncwarp();
    const int w = w0 + u * stride;
    // the region ids of this thread's keys 8 nt + 2 t + j, four bits each at
    // position 2 nt + j
    const int* rr = region != nullptr ? region + static_cast<size_t>(w % nw) * N : nullptr;
    uint32_t kid[(2 * NT + 7) / 8] = {};
    if (rr != nullptr) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = 2 * nt + j;
          kid[p / 8] |= static_cast<uint32_t>(__ldg(rr + 8 * nt + 2 * t + j) & 15) << (4 * (p % 8));
        }
    }
    const int s = u % STAGES;
    sm90::mbar_wait(full + s, (u / STAGES) & 1);
    const unsigned char* tq = gsm + s * SLOT;
    const unsigned char* tk = tq + TILE;
    const unsigned char* tv = tq + 2 * TILE;

#pragma unroll 1
    for (int i_tile = 0; i_tile < TILES; ++i_tile) {
      const int rt = warp + WARPS * i_tile;
      const int row0 = rt * 16 + g;              // this thread's rows: row0, row0 + 8
      uint32_t qa[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        swin::ldmatrix_x4(qa[ks], reinterpret_cast<const bf16*>(
                                      tq + sm90::sw64_offset(rt * 16 + lane % 16,
                                                             16 * ks + 8 * (lane / 16))));
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[ks][i] = scale_pair(qa[ks][i], scale);
      }
      float sacc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) sacc[nt][i] = 0.0f;
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t b[4];
          swin::ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                                   tk + sm90::sw64_offset(kt * 16 + lane % 8 + 8 * (lane / 16),
                                                          16 * ks + 8 * ((lane / 8) % 2))));
          swin::mma_bf16(sacc[2 * kt], qa[ks], b[0], b[1]);
          swin::mma_bf16(sacc[2 * kt + 1], qa[ks], b[2], b[3]);
        }

      // + bias + mask; row softmax over the four lanes
      int rid[2] = {0, 0};
      if (rr != nullptr) {
        rid[0] = __ldg(rr + row0);
        rid[1] = __ldg(rr + row0 + 8);
      }
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const float2 b = unpack_bf16(*reinterpret_cast<const uint32_t*>(
              sb + ((row0 + 8 * hi) * BIAS_LD + 8 * nt + 2 * t) * 2));
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int p = 2 * nt + j;
            float sc = sacc[nt][2 * hi + j] + (j ? b.y : b.x);
            const bool differ = rr != nullptr &&
                static_cast<int>((kid[p / 8] >> (4 * (p % 8))) & 15u) != rid[hi];
            sc += differ ? swin::NEG : 0.0f;
            sacc[nt][2 * hi + j] = sc;
            m[hi] = fmaxf(m[hi], sc);
          }
        }
      float l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        m[hi] = fmaxf(m[hi], __shfl_xor_sync(0xffffffffu, m[hi], 1));
        m[hi] = fmaxf(m[hi], __shfl_xor_sync(0xffffffffu, m[hi], 2));
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
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
      for (int ks = 0; ks < KT; ++ks) {
        uint32_t a[4];
        a[0] = swin::pack_bf16(sacc[2 * ks][0] * l[0], sacc[2 * ks][1] * l[0]);
        a[1] = swin::pack_bf16(sacc[2 * ks][2] * l[1], sacc[2 * ks][3] * l[1]);
        a[2] = swin::pack_bf16(sacc[2 * ks + 1][0] * l[0], sacc[2 * ks + 1][1] * l[0]);
        a[3] = swin::pack_bf16(sacc[2 * ks + 1][2] * l[1], sacc[2 * ks + 1][3] * l[1]);
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

      // out: rounded once, staged, then 16 bytes a lane
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          *reinterpret_cast<uint32_t*>(so + sm90::sw64_offset(g + 8 * hi, 8 * nt + 2 * t)) =
              swin::pack_bf16(o[nt][2 * hi], o[nt][2 * hi + 1]);
      __syncwarp();
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
        const int r = pass * 8 + lane / 4, row = rt * 16 + r;
        const uint4 v = *reinterpret_cast<const uint4*>(so + sm90::sw64_offset(r, 8 * (lane % 4)));
        *reinterpret_cast<uint4*>(out + (static_cast<size_t>(w) * N + row) * c + h * HD +
                                  8 * (lane % 4)) = v;
      }
      __syncwarp();                                 // so is rewritten by the next tile
    }
    if (lane == 0) sm90::mbar_arrive(empty + s);    // this warp is done with the slot
  }
}

int launch_n144_bf16(const void* qkv, const void* bias, const int* region, void* out, int bnw,
                     int heads, int nw, int blocks, int per_head, cudaStream_t stream) {
  if (blocks <= 0 || per_head <= 0 || blocks != per_head * heads ||
      reinterpret_cast<uintptr_t>(bias) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  if (!qkv_map(&tm, qkv, bnw * n144::N, 3 * heads * HD, n144::N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(window_attention_n144_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, n144::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_n144_bf16_kernel<<<blocks, n144::THREADS, n144::SMEM, stream>>>(
      tm, static_cast<const bf16*>(bias), region, static_cast<bf16*>(out), bnw, heads, nw,
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

// 12x12 windows in float32, as the 49-token kernel: one block a (window,
// head), thread i < 144 on query row i. The [144, 144] scores and the head's
// q, k and v (136 KB) take dynamic shared memory, so one block a
// multiprocessor; float32 is the precise path, not the fast one.
namespace n144f {
constexpr int N = n144::N;
constexpr int THREADS = 160;                 // 144 rows in whole warps
constexpr int LD = HD + 1;                   // a q row: thread i reading row i hits bank (i + d) % 32
constexpr int SK = N * LD * 4;               // offsets in bytes: sq [N][LD], then
constexpr int SV = SK + N * HD * 4;          // sk [N][HD], sv [N][HD],
constexpr int SS = SV + N * HD * 4;          // ss [N][N] (bias[h], then the scores),
constexpr int SREG = SS + N * N * 4;         // sreg [N]
constexpr int SMEM = SREG + N * 4;
static_assert(SK % 16 == 0 && SV % 16 == 0 && SMEM <= 232448, "shared memory");
}  // namespace n144f

__global__ void __launch_bounds__(n144f::THREADS)
window_attention_n144_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                                 const int* __restrict__ region, float* __restrict__ out,
                                 int heads, int nw) {
  constexpr int NW = n144f::N, LD = n144f::LD, T = n144f::THREADS;
  extern __shared__ __align__(16) unsigned char smem_f32[];
  float* sq = reinterpret_cast<float*>(smem_f32);
  float* sk = reinterpret_cast<float*>(smem_f32 + n144f::SK);
  float* sv = reinterpret_cast<float*>(smem_f32 + n144f::SV);
  float* ss = reinterpret_cast<float*>(smem_f32 + n144f::SS);
  int* sreg = reinterpret_cast<int*>(smem_f32 + n144f::SREG);

  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int c = heads * HD;
  const float* base = qkv + static_cast<size_t>(w) * NW * 3 * c + h * HD;
  for (int e = tid; e < NW * HD; e += T) {
    const int r = e / HD, d = e % HD;
    const float* row = base + static_cast<size_t>(r) * 3 * c + d;
    sq[r * LD + d] = row[0] * swin::QK_SCALE;
    sk[e] = row[c];
    sv[e] = row[2 * c];
  }
  const float* hbias = bias + static_cast<size_t>(h) * NW * NW;
  for (int e = tid; e < NW * NW; e += T) ss[e] = hbias[e];
  const bool masked = region != nullptr;
  if (masked && tid < NW) sreg[tid] = region[static_cast<size_t>(w % nw) * NW + tid];
  __syncthreads();

  if (tid < NW)
    swin::attention_row<float, NW>(sq + tid * LD, sk, sv, ss + tid * NW,
                                   masked ? sreg : nullptr, tid);
  __syncthreads();

  float* obase = out + static_cast<size_t>(w) * NW * c + h * HD;
  for (int e = tid; e < NW * HD; e += T) {
    const int r = e / HD, d = e % HD;
    obase[static_cast<size_t>(r) * c + d] = sq[r * LD + d];
  }
}

int launch_n144_f32(const void* qkv, const void* bias, const int* region, void* out, int bnw,
                    int heads, int nw, cudaStream_t stream) {
  if (heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(window_attention_n144_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         n144f::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_n144_f32_kernel<<<dim3(bnw, heads), n144f::THREADS, n144f::SMEM, stream>>>(
      static_cast<const float*>(qkv), static_cast<const float*>(bias), region,
      static_cast<float*>(out), heads, nw);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ backward, bf16, Hopper -----

namespace bwd {
constexpr int THREADS = 128;                // one group of four warps a block
constexpr int MINB = 3;                     // blocks a multiprocessor
constexpr int STAGES = 3;                   // ring slots
constexpr int LEAD = STAGES - 1;            // units in flight, the current one included
constexpr int TILE = 64 * 64;               // q, k, v, dO: 64 rows of 64 bytes
constexpr int SLOT = 4 * TILE;
constexpr int UNIT_BYTES = 4 * N * HD * 2;  // what TMA writes into a slot
constexpr int PTILE = 64 * 128;             // P, dS hi, dS lo: 64 query rows of 64 keys
constexpr int PS = STAGES * SLOT;           // offset of the three P / dS tiles
constexpr int BAR = PS + 3 * PTILE;         // full[STAGES], empty[STAGES]
constexpr int SMEM = BAR + 2 * STAGES * 8 + 512;    // + room to align the base
static_assert(MINB * (SMEM + 1024) <= 233472, "shared memory of a multiprocessor");
}  // namespace bwd

// Rows row0 + lane / 4 and + 8 of a warp's [16, 32] tile, as bf16 pairs
// v[hi][nt] = (row lane / 4 + 8 hi; columns 8 nt + 2 (lane % 4), + 1), into dst
// (row stride ld elements), rows at or past N left alone: two rounds of
// shuffles within each quad transpose the 4 x 4 pairs, so that lane t holds
// columns 8 t .. 8 t + 7 of its rows and writes each row's 64 bytes with its
// three neighbours in one 16-byte store.
__device__ __forceinline__ void store_rows(uint32_t (&v)[2][4], bf16* dst, size_t ld, int row0) {
  const int lane = threadIdx.x % 32, t = lane % 4;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
    for (int d = 1; d < 4; d <<= 1) {
      const bool up = (t & d) != 0;
#pragma unroll
      for (int i0 = 0; i0 < 4; ++i0) {
        if (i0 & d) continue;
        const uint32_t got = __shfl_xor_sync(0xffffffffu, up ? v[hi][i0] : v[hi][i0 | d], d);
        if (up) v[hi][i0] = got;
        else v[hi][i0 | d] = got;
      }
    }
    const int row = row0 + lane / 4 + 8 * hi;
    if (row < N)
      *reinterpret_cast<uint4*>(dst + row * ld + 8 * t) =
          make_uint4(v[hi][0], v[hi][1], v[hi][2], v[hi][3]);
  }
}

// A float32 accumulator tile acc[nt][i] (as mma_bf16 leaves it) as the bf16
// pairs of store_rows, each value times `mul` first.
__device__ __forceinline__ void pack_tile(const float (&acc)[4][4], float mul,
                                          uint32_t (&v)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      v[hi][nt] = swin::pack_bf16(acc[nt][2 * hi] * mul, acc[nt][2 * hi + 1] * mul);
}

// Group gid (= block; per_head * heads of them) takes head gid % heads and
// windows gid / heads, + per_head, ... below bnw, as the forward's groups.
// tm: qkv [bnw * 49, 3C]; tg: the incoming gradient [bnw * 49, C]; dqkv as
// qkv; part [groups, 49, 49] float32, each group's d_bias partial.
__global__ void __launch_bounds__(bwd::THREADS, bwd::MINB)
window_attention_bwd_bf16_kernel(const __grid_constant__ CUtensorMap tm,
                                 const __grid_constant__ CUtensorMap tg,
                                 const bf16* __restrict__ bias, const int* __restrict__ region,
                                 bf16* __restrict__ dqkv, float* __restrict__ part, int bnw,
                                 int heads, int nw, int per_head) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 511) & ~static_cast<uintptr_t>(511));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t ring = sm90::smem_addr(smem);
  unsigned char* sp = smem + bwd::PS;         // bf16(P)
  unsigned char* sh = sp + bwd::PTILE;        // bf16(dS)
  unsigned char* sl = sh + bwd::PTILE;        // bf16(dS - bf16(dS))
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bwd::BAR);
  uint64_t* empty = full + bwd::STAGES;

  // rows N..63 of every tile of the ring, and keys 56..63 of the P / dS
  // tiles, are zero for good
  for (int e = tid; e < bwd::STAGES * 4 * (64 - N) * 4; e += bwd::THREADS) {
    const int tile = e / ((64 - N) * 4), rest = e % ((64 - N) * 4);
    *reinterpret_cast<uint4*>(smem + tile * bwd::TILE + (N + rest / 4) * 64 +
                              (rest % 4) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int e = tid; e < 3 * 64; e += bwd::THREADS)
    *reinterpret_cast<uint4*>(sp + (e / 64) * bwd::PTILE + sm90::sw128_offset(e % 64, 56)) =
        make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < bwd::STAGES; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 4);            // every warp releases every slot
    }
    sm90::fence_mbar_init();
  }
  sm90::fence_proxy_async();
  __syncthreads();

  const int c = heads * HD;
  const int gid = blockIdx.x, h = gid % heads, w0 = gid / heads;
  const int units = (bnw - 1 - w0) / per_head + 1;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;                // this thread's rows: row0, row0 + 8
  uint32_t bz[7][2];
  swin::head_bias(bias + static_cast<size_t>(h) * N * N, warp, bz);
  const float scale = round_to<bf16>(swin::QK_SCALE);
  float db[7][4];                                // d_bias of this thread's scores, float32
#pragma unroll
  for (int nt = 0; nt < 7; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) db[nt][i] = 0.0f;

  // Thread 0: start the copies of every unit before `upto`; unit v waits for
  // the release of unit v - STAGES.
  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto && issued < units; ++issued) {
      const int s = issued % bwd::STAGES;
      sm90::mbar_wait(empty + s, ((issued / bwd::STAGES) & 1) ^ 1);
      const int row = (w0 + issued * per_head) * N;
      const uint32_t dst = ring + s * bwd::SLOT;
      sm90::mbar_expect_tx(full + s, bwd::UNIT_BYTES);
      sm90::tma_load_2d(dst, &tm, h * HD, row, full + s);
      sm90::tma_load_2d(dst + bwd::TILE, &tm, c + h * HD, row, full + s);
      sm90::tma_load_2d(dst + 2 * bwd::TILE, &tm, 2 * c + h * HD, row, full + s);
      sm90::tma_load_2d(dst + 3 * bwd::TILE, &tg, h * HD, row, full + s);
    }
  };

  for (int u = 0; u < units; ++u) {
    if (tid == 0) issue_upto(u + bwd::LEAD);
    __syncwarp();
    const int w = w0 + u * per_head;
    int rl = 0, rh = 0;
    if (region != nullptr) {
      const int* rr = region + static_cast<size_t>(w % nw) * N;
      rl = rr[lane];
      rh = lane < N - 32 ? rr[32 + lane] : 0;
    }
    const int s = u % bwd::STAGES;
    sm90::mbar_wait(full + s, (u / bwd::STAGES) & 1);
    const unsigned char* tq = smem + s * bwd::SLOT;
    const unsigned char* tk = tq + bwd::TILE;
    const unsigned char* tv = tq + 2 * bwd::TILE;
    const unsigned char* tdo = tq + 3 * bwd::TILE;

    // S = q_s k^T over keys 0..55 for this warp's query rows (as the forward)
    uint32_t qa[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      swin::ldmatrix_x4(qa[ks], reinterpret_cast<const bf16*>(
                                    tq + sm90::sw64_offset(warp * 16 + lane % 16,
                                                           16 * ks + 8 * (lane / 16))));
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[ks][i] = scale_pair(qa[ks][i], scale);
    }
    float p[7][4];
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[nt][i] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b[4];
        swin::ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                                 tk + sm90::sw64_offset(kt * 16 + lane % 8 + 8 * (lane / 16),
                                                        16 * ks + 8 * ((lane / 8) % 2))));
        swin::mma_bf16(p[2 * kt], qa[ks], b[0], b[1]);
        if (2 * kt + 1 < 7) swin::mma_bf16(p[2 * kt + 1], qa[ks], b[2], b[3]);
      }

    // P = softmax(S + bias + mask), -inf past the window, float32
    const uint32_t differ = region != nullptr ? swin::region_differ(warp, rl, rh) : 0u;
    float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 b = unpack_bf16(bz[nt][i / 2]);
        float sc = p[nt][i] + (i % 2 ? b.y : b.x);
        sc += (differ >> (nt * 4 + i)) & 1u ? swin::NEG : 0.0f;
        sc = 8 * nt + 2 * t + i % 2 < N ? sc : -INFINITY;
        p[nt][i] = sc;
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
        p[nt][i] = expf(p[nt][i] - m[i / 2]);
        l[i / 2] += p[nt][i];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
      l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
      // rows past the window get P = 0 (their dO rows are zero: dS is 0 there anyway)
      l[hi] = row0 + 8 * hi < N ? 1.0f / l[hi] : 0.0f;
    }
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) p[nt][i] *= l[i / 2];

    // dP = dO v^T, rounded to bf16; D = rowsum(P dP); dS = P (dP - D), into dp
    uint32_t ga[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      swin::ldmatrix_x4(ga[ks], reinterpret_cast<const bf16*>(
                                    tdo + sm90::sw64_offset(warp * 16 + lane % 16,
                                                            16 * ks + 8 * (lane / 16))));
    float dp[7][4];
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dp[nt][i] = 0.0f;
#pragma unroll
    for (int kt = 0; kt < 4; ++kt)
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t b[4];
        swin::ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                                 tv + sm90::sw64_offset(kt * 16 + lane % 8 + 8 * (lane / 16),
                                                        16 * ks + 8 * ((lane / 8) % 2))));
        swin::mma_bf16(dp[2 * kt], ga[ks], b[0], b[1]);
        if (2 * kt + 1 < 7) swin::mma_bf16(dp[2 * kt + 1], ga[ks], b[2], b[3]);
      }
    float dd[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dp[nt][i] = round_to<bf16>(dp[nt][i]);
        dd[i / 2] += p[nt][i] * dp[nt][i];
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      dd[hi] += __shfl_xor_sync(0xffffffffu, dd[hi], 1);
      dd[hi] += __shfl_xor_sync(0xffffffffu, dd[hi], 2);
    }
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dp[nt][i] = p[nt][i] * (dp[nt][i] - dd[i / 2]);
        db[nt][i] += dp[nt][i];
      }

    // dq_s = dS k: dS as the A operand, hi and lo; keys 56..63 are zero
    float dq[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nt = 2 * ks + j / 2;
        if (nt < 7) {
          const float x0 = dp[nt][2 * (j % 2)], x1 = dp[nt][2 * (j % 2) + 1];
          const float h0 = round_to<bf16>(x0), h1 = round_to<bf16>(x1);
          ah[j] = swin::pack_bf16(h0, h1);
          al[j] = swin::pack_bf16(x0 - h0, x1 - h1);
        } else {
          ah[j] = al[j] = 0u;
        }
      }
#pragma unroll
      for (int dp2 = 0; dp2 < 2; ++dp2) {
        uint32_t b[4];
        swin::ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(
                                       tk + sm90::sw64_offset(16 * ks + lane % 16,
                                                              16 * dp2 + 8 * (lane / 16))));
        swin::mma_bf16(dq[2 * dp2], ah, b[0], b[1]);
        swin::mma_bf16(dq[2 * dp2], al, b[0], b[1]);
        swin::mma_bf16(dq[2 * dp2 + 1], ah, b[2], b[3]);
        swin::mma_bf16(dq[2 * dp2 + 1], al, b[2], b[3]);
      }
    }

    // bf16(P), dS hi and lo into shared memory, once every warp is done with
    // the last unit's
    __syncthreads();
#pragma unroll
    for (int nt = 0; nt < 7; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const uint32_t off = sm90::sw128_offset(row0 + 8 * hi, 8 * nt + 2 * t);
        const float x0 = dp[nt][2 * hi], x1 = dp[nt][2 * hi + 1];
        const float h0 = round_to<bf16>(x0), h1 = round_to<bf16>(x1);
        *reinterpret_cast<uint32_t*>(sp + off) = swin::pack_bf16(p[nt][2 * hi], p[nt][2 * hi + 1]);
        *reinterpret_cast<uint32_t*>(sh + off) = swin::pack_bf16(h0, h1);
        *reinterpret_cast<uint32_t*>(sl + off) = swin::pack_bf16(x0 - h0, x1 - h1);
      }
    __syncthreads();

    // this warp's keys kb .. kb + 15: dv = P^T dO, dk = dS^T q_s, over query
    // k-steps of 16 (rows past the window are zero in every operand)
    const int kb = warp * 16;
    float dv[4][4], dk[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dv[nt][i] = dk[nt][i] = 0.0f;
#pragma unroll
    for (int qs = 0; qs < 4; ++qs) {
      const uint32_t off = sm90::sw128_offset(16 * qs + lane % 8 + 8 * (lane / 16),
                                              kb + 8 * ((lane / 8) % 2));
      uint32_t pa[4], ha[4], la[4];
      swin::ldmatrix_x4_trans(pa, reinterpret_cast<const bf16*>(sp + off));
      swin::ldmatrix_x4_trans(ha, reinterpret_cast<const bf16*>(sh + off));
      swin::ldmatrix_x4_trans(la, reinterpret_cast<const bf16*>(sl + off));
#pragma unroll
      for (int dp2 = 0; dp2 < 2; ++dp2) {
        const uint32_t boff = sm90::sw64_offset(16 * qs + lane % 16, 16 * dp2 + 8 * (lane / 16));
        uint32_t b[4];
        swin::ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(tdo + boff));
        swin::mma_bf16(dv[2 * dp2], pa, b[0], b[1]);
        swin::mma_bf16(dv[2 * dp2 + 1], pa, b[2], b[3]);
        swin::ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(tq + boff));
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = scale_pair(b[i], scale);
        swin::mma_bf16(dk[2 * dp2], ha, b[0], b[1]);
        swin::mma_bf16(dk[2 * dp2], la, b[0], b[1]);
        swin::mma_bf16(dk[2 * dp2 + 1], ha, b[2], b[3]);
        swin::mma_bf16(dk[2 * dp2 + 1], la, b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(empty + s);    // this warp is done with the slot

    // dq = bf16(bf16(dq_s) * scale); dk, dv rounded once
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) dq[nt][i] = round_to<bf16>(dq[nt][i]);
    bf16* base = dqkv + static_cast<size_t>(w) * N * 3 * c + h * HD;
    uint32_t v[2][4];
    pack_tile(dq, scale, v);
    store_rows(v, base, 3 * c, warp * 16);
    pack_tile(dk, 1.0f, v);
    store_rows(v, base + c, 3 * c, kb);
    pack_tile(dv, 1.0f, v);
    store_rows(v, base + 2 * c, 3 * c, kb);
  }

  float* gp = part + static_cast<size_t>(gid) * N * N;
#pragma unroll
  for (int nt = 0; nt < 7; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 8 * (i / 2), key = 8 * nt + 2 * t + i % 2;
      if (row < N && key < N) gp[row * N + key] = db[nt][i];
    }
}

// d_bias[h] = bf16 of the sum of the partials of head h's groups
// (h, h + heads, ...), in that order.
__global__ void window_attention_bwd_bias_kernel(const float* __restrict__ part,
                                                 bf16* __restrict__ dbias, int heads,
                                                 int per_head) {
  const int h = blockIdx.y, e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N * N) return;
  float sum = 0.0f;
  for (int k = 0; k < per_head; ++k)
    sum += part[(static_cast<size_t>(k) * heads + h) * N * N + e];
  dbias[static_cast<size_t>(h) * N * N + e] = __float2bfloat16_rn(sum);
}

int launch_bwd_bf16(const void* qkv, const void* bias, const int* region, const void* dout,
                    void* dqkv, void* dbias, void* part, int bnw, int heads, int nw, int blocks,
                    int groups, int per_head, cudaStream_t stream) {
  if (groups <= 0 || blocks != groups || groups % heads != 0 || per_head != groups / heads ||
      per_head > bnw)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm, tg;
  if (!qkv_map(&tm, qkv, bnw * N, 3 * heads * HD) || !qkv_map(&tg, dout, bnw * N, heads * HD) ||
      reinterpret_cast<uintptr_t>(dqkv) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bwd::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_bf16_kernel<<<blocks, bwd::THREADS, bwd::SMEM, stream>>>(
      tm, tg, static_cast<const bf16*>(bias), region, static_cast<bf16*>(dqkv),
      static_cast<float*>(part), bnw, heads, nw, per_head);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_bwd_bias_kernel<<<dim3((N * N + 255) / 256, heads), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dbias), heads, per_head);
  return static_cast<int>(cudaGetLastError());
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

// Swin-L's 12x12 windows: qkv [bnw, 144, 3 * heads * 32], bias [heads, 144,
// 144], region [nw, 144] int32 or null, out [bnw, 144, heads * 32]; qkv,
// bias and out are bf16 when is_bf16 is nonzero, else float32. blocks and
// per_head are the bf16 launch's geometry (ops/window_attention.py::
// wide_geometry); the float32 launch ignores them.
extern "C" int window_attention_n144(const void* qkv, const void* bias, const void* region,
                                     void* out, int bnw, int heads, int nw, int is_bf16,
                                     int blocks, int per_head, void* stream) {
  if (bnw <= 0 || heads <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* reg = static_cast<const int*>(region);
  if (is_bf16)
    return launch_n144_bf16(qkv, bias, reg, out, bnw, heads, nw, blocks, per_head, s);
  return launch_n144_f32(qkv, bias, reg, out, bnw, heads, nw, s);
}

// The 144-token kernel's compiled shape into g[0..7), in the order of
// window_attention_attributes.
extern "C" int window_attention_n144_attributes(int* g) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, window_attention_n144_bf16_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[7] = {n144::GROUPS, 1, n144::STAGES, n144::THREADS, n144::SMEM, attr.numRegs,
                    static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 7; ++i) g[i] = v[i];
  return 0;
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

// The backward of the bf16 launch. qkv, bias, region as window_attention's;
// dout, the incoming gradient [bnw, 49, heads * 32]; dqkv [bnw, 49, 3 * heads
// * 32] and dbias [heads, 49, 49] receive the gradients (every element
// written), bf16; part is float32 scratch of groups * 49 * 49. blocks, groups
// and per_head are ops/window_attention.py::backward_geometry's (blocks ==
// groups).
extern "C" int window_attention_backward(const void* qkv, const void* bias, const void* region,
                                         const void* dout, void* dqkv, void* dbias, void* part,
                                         int bnw, int heads, int nw, int blocks, int groups,
                                         int per_head, void* stream) {
  if (bnw <= 0 || heads <= 0) return 0;
  return launch_bwd_bf16(qkv, bias, static_cast<const int*>(region), dout, dqkv, dbias, part,
                         bnw, heads, nw, blocks, groups, per_head,
                         static_cast<cudaStream_t>(stream));
}

// The backward kernel's compiled shape into g[0..7), in the order of
// window_attention_attributes.
extern "C" int window_attention_backward_attributes(int* g) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, window_attention_bwd_bf16_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int v[7] = {1, bwd::MINB, bwd::STAGES, bwd::THREADS, bwd::SMEM, attr.numRegs,
                    static_cast<int>(attr.localSizeBytes)};
  for (int i = 0; i < 7; ++i) g[i] = v[i];
  return 0;
}
