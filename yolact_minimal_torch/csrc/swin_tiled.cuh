// Device code shared by the bf16 bodies for the H100 (sm_90a) of
// swin_block.cu (a whole Swin block) and attn_block.cu (its attention half).
// Their tiled forms walk tiles of windows on persistent blocks, run qkv head
// by head and proj on wgmma from 128-byte swizzled tiles (sm90.cuh), feed
// weight slices through a ring of TMA loads, and attend per (window, head)
// on mma.sync.
//
// Here: the per-head pieces (the head's bias in registers, the attention of
// a warp's 16 query rows, the qkv epilogue into the q / k / v tiles), the
// consumers' side of the weight ring, and the head-stationary attention
// pass (attend_heads: attn_block.cu's phase 1 at C = 192-768, and the
// attention launch of swin_block.cu at C = 768).
#pragma once
#include "sm90.cuh"
#include "swin_common.cuh"

namespace swin {

constexpr int align1k(int b) { return (b + 1023) / 1024 * 1024; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The bias [49, 49] of one head for a thread of warp wq of a warpgroup:
// bz[nt][hi] = (row 16 wq + lane / 4 + 8 hi; keys 8 nt + 2 (lane % 4), + 1)
// as a bf16 pair, zero past the window.
__device__ __forceinline__ void head_bias(const bf16* __restrict__ hb, int wq,
                                          uint32_t (&bz)[7][2]) {
  const int lane = threadIdx.x % 32, row0 = wq * 16 + lane / 4, t = lane % 4;
#pragma unroll
  for (int nt = 0; nt < 7; ++nt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi, key = 8 * nt + 2 * t;
      const float b0 = row < N && key < N ? to_f<bf16>(hb[row * N + key]) : 0.0f;
      const float b1 = row < N && key + 1 < N ? to_f<bf16>(hb[row * N + key + 1]) : 0.0f;
      bz[nt][hi] = pack_bf16(b0, b1);
    }
}

// Which of the scores of a thread of warp wq in attend_rows pair tokens of
// different regions: bit nt * 4 + i for sacc[nt][i]. rl, rh: the window's
// region ids, token j in lane j % 32 of rl for j < 32, else rh. The same
// for every head.
__device__ __forceinline__ uint32_t region_differ(int wq, int rl, int rh) {
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int row0 = wq * 16 + lane / 4;
  uint32_t differ = 0;
  int rrow[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
    rrow[hi] = __shfl_sync(0xffffffffu, wq < 2 ? rl : rh, min(row0 + 8 * hi, N - 1) % 32);
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
  return differ;
}

// One warp (wq of the four of a warpgroup): query rows 16 wq .. 16 wq + 15
// of a window, for one head: o = softmax(q k^T + bias + mask) v, float32,
// o[nt][i] for rows 16 wq + lane / 4 (+ 8 for i >= 2) and columns 8 nt +
// 2 (lane % 4) + i % 2. qa: q (already scaled) as the mma A fragments of
// its two k-steps; tk, tv: the k and v tiles (64-byte swizzled rows, the
// window's 49 rows from row rb, rows past the window zero); bz: the head's
// bias of this thread's scores (head_bias); differ: which of them take the
// -100 region fill (region_differ; 0 for an unshifted block).
__device__ __forceinline__ void attend_q(const uint32_t (&qa)[2][4], const unsigned char* tk,
                                         const unsigned char* tv, int rb,
                                         const uint32_t (&bz)[7][2], uint32_t differ,
                                         float (&o)[4][4]) {
  const int lane = threadIdx.x % 32, t = lane % 4;
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
      ldmatrix_x4(b, reinterpret_cast<const bf16*>(
                         tk + sm90::sw64_offset(rb + kt * 16 + lane % 8 + 8 * (lane / 16),
                                                16 * ks + 8 * ((lane / 8) % 2))));
      mma_bf16(sacc[2 * kt], qa[ks], b[0], b[1]);
      if (2 * kt + 1 < 7) mma_bf16(sacc[2 * kt + 1], qa[ks], b[2], b[3]);
    }

  // + bias + mask, -inf past the window; row softmax over the four lanes
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 7; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 8 * nt + 2 * t + i % 2;
      const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bz[nt][i / 2]));
      float sc = sacc[nt][i] + (i % 2 ? b.y : b.x);
      sc += (differ >> (nt * 4 + i)) & 1u ? NEG : 0.0f;
      sc = key < N ? sc : -INFINITY;
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
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nt][i] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4];
    a[0] = pack_bf16(sacc[2 * ks][0] * l[0], sacc[2 * ks][1] * l[0]);
    a[1] = pack_bf16(sacc[2 * ks][2] * l[1], sacc[2 * ks][3] * l[1]);
    if (2 * ks + 1 < 7) {
      a[2] = pack_bf16(sacc[2 * ks + 1][0] * l[0], sacc[2 * ks + 1][1] * l[0]);
      a[3] = pack_bf16(sacc[2 * ks + 1][2] * l[1], sacc[2 * ks + 1][3] * l[1]);
    } else {
      a[2] = a[3] = 0u;
    }
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, reinterpret_cast<const bf16*>(
                               tv + sm90::sw64_offset(rb + 16 * ks + lane % 16,
                                                      16 * dp + 8 * (lane / 16))));
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// attend_q with q from the q tile: query rows 16 wq .. 16 wq + 15 of the
// window whose 49 rows start at row `rb` of the q, k, v tiles (qt bytes
// apart, 64-byte swizzled rows), rounded to bf16 once, into columns col0 ..
// col0 + 31 of the swizzled attention-output tile (64-wide blocks tb bytes
// apart); rows past the window are not stored.
__device__ __forceinline__ void attend_rows(const unsigned char* tq, int qt, int rb, int wq,
                                            const uint32_t (&bz)[7][2], uint32_t differ,
                                            unsigned char* ao, int tb, int col0) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int row0 = wq * 16 + g;                  // this thread's rows: row0, row0 + 8
  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
    ldmatrix_x4(qa[ks], reinterpret_cast<const bf16*>(
                            tq + sm90::sw64_offset(rb + wq * 16 + lane % 16,
                                                   16 * ks + 8 * (lane / 16))));
  float o[4][4];
  attend_q(qa, tq + qt, tq + 2 * qt, rb, bz, differ, o);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi, col = col0 + 8 * nt + 2 * t;
      if (row < N)
        *reinterpret_cast<uint32_t*>(ao + (col / 64) * tb + sm90::sw128_offset(rb + row, col % 64)) =
            pack_bf16(o[nt][2 * hi], o[nt][2 * hi + 1]);
    }
}

// The qkv epilogue of head h for one warpgroup, which holds columns col0 ..
// col0 + NQ - 1 of the head's 96 q | k | v columns ([64, NQ] accumulators of
// wgmma; er, ec: this thread's first row and column in them): + bqkv in
// float32, rounded to bf16; q * scale rounded again (scale already rounded);
// into the q, k, v tiles of 64-byte swizzled rows, QT = 4096 bytes apart,
// rows past the window zero.
template <int C, int NQ>
__device__ __forceinline__ void store_qkv(const float (&acc)[NQ / 2], const float* __restrict__ bqkv,
                                          int h, int col0, float scale, unsigned char* qkv,
                                          int er, int ec) {
  constexpr int QT = 64 * 64;
#pragma unroll
  for (int j = 0; j < NQ / 8; ++j) {
    const int col = col0 + 8 * j + ec, which = col / HD, d = col % HD;
    const float2 b = *reinterpret_cast<const float2*>(bqkv + which * C + h * HD + d);
    const float mul = which == 0 ? scale : 1.0f;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = er + 8 * hi;
      const float v0 = round_to<bf16>(acc[4 * j + 2 * hi] + b.x);
      const float v1 = round_to<bf16>(acc[4 * j + 2 * hi + 1] + b.y);
      *reinterpret_cast<uint32_t*>(qkv + which * QT + sm90::sw64_offset(row, d)) =
          row < N ? pack_bf16(which == 0 ? v0 * mul : v0, which == 0 ? v1 * mul : v1) : 0u;
    }
  }
}

// The consumers' side of a ring of STAGES slots of SLOT bytes at shared
// address `slots`, with barriers full[STAGES] (one arrival and the TMA bytes)
// and empty[STAGES] (one arrival from every consuming warp). Every consuming
// warp walks every use in order (use u lies in slot u % STAGES). A warp releases a
// use once the products issued after it have waited for it (wgmma_wait<1>),
// so a use's products run under the next use's wait; releases are predicated,
// not branched, so that no product in flight meets a divergent path.
template <int STAGES, int SLOT> struct RingReader {
  uint64_t* full;
  uint64_t* empty;
  uint32_t slots;
  int use = 0, pending = -1;    // uses walked; the last whose products may be in flight

  // Wait for use `use` to land; returns its slot's shared address. The
  // issuing thread (thread 0 unless named) first tops the ring up to
  // STAGES - 1 uses ahead (issue_upto), which waits only for releases that
  // every consuming warp makes before it can wait here.
  template <typename Issue>
  __device__ __forceinline__ uint32_t acquire(Issue& issue_upto) {
    return acquire(issue_upto, threadIdx.x == 0);
  }
  template <typename Issue>
  __device__ __forceinline__ uint32_t acquire(Issue& issue_upto, bool issuer) {
    if (issuer) issue_upto(use + STAGES - 1);
    __syncwarp();
    sm90::mbar_wait(full + use % STAGES, (use / STAGES) & 1);
    return slots + (use % STAGES) * SLOT;
  }
  // After this warpgroup's products on use `use` are issued.
  __device__ __forceinline__ void retire() {
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();
    sm90::mbar_arrive_if(empty + (pending + STAGES) % STAGES,
                         threadIdx.x % 32 == 0 && pending >= 0);
    pending = use++;
  }
  // Every product done, every use released.
  __device__ __forceinline__ void drain() {
    sm90::wgmma_wait<0>();
    sm90::mbar_arrive_if(empty + (pending + STAGES) % STAGES,
                         threadIdx.x % 32 == 0 && pending >= 0);
    pending = -1;
  }
};

// Per width: warpgroups a block and x ring slots a warpgroup of phase 1.
template <int WGN_, int XS_> struct HeadShapeOf {
  static constexpr int WGN = WGN_, XS = XS_;
};
template <int C> struct HeadShape;
template <> struct HeadShape<192> : HeadShapeOf<3, 5> {};
template <> struct HeadShape<384> : HeadShapeOf<3, 5> {};
template <> struct HeadShape<768> : HeadShapeOf<2, 4> {};

template <int C> struct HeadPlan {
  static constexpr int WGN = HeadShape<C>::WGN, XS = HeadShape<C>::XS;
  static constexpr int THREADS = WGN * 128;
  static constexpr int HEADS = C / HD, KB = C / 64;
  static constexpr int XT = 64 * 128;                // one k-block of a window's x rows
  static constexpr int QT = 64 * 64;                 // the k and v tiles
  static constexpr int W = 0;                        // per k-block the head's 96 rows of wqkv
  static constexpr int WG0 = W + KB * 96 * 128;      // per warpgroup its x slots, k and v tiles
  static constexpr int WGB = XS * XT + 2 * QT;
  // barriers: the weights', then per warpgroup full[XS], empty[XS]
  static constexpr int BAR = WG0 + WGN * WGB;
  static constexpr int SMEM = BAR + (1 + 2 * WGN * XS) * 8 + 1024;   // + aligning the base
  static_assert(C % 64 == 0 && XS >= 3 && WGN * 2 < 16, "k-blocks, ring, named barriers");
  static_assert(SMEM <= 232448, "shared memory");
};

// Phase 1 of the attention half-block, the body of a kernel launched on
// HEADS x chunks blocks of HeadPlan<C>::THREADS threads with HeadPlan<C>::SMEM
// bytes of dynamic shared memory (attn_block.cu, and swin_block.cu at C = 768):
// block b takes head b % HEADS and chunk b / HEADS of the windows; the head's
// 96 q | k | v rows of wqkv stay in shared memory while each warpgroup walks
// its own windows, their x rows by TMA (tm_x: [bnw * 49, C], 64-row boxes)
// through a ring of its own; q | k | v on wgmma, q kept in registers as the A
// fragments of q k^T, attention on mma.sync (attend_q); the head's 32
// columns of the attention output, rounded once, go to ao [bnw * 49, C].
template <int C>
__device__ __forceinline__ void attend_heads(const CUtensorMap& tm_x, const CUtensorMap& tm_qkv,
                                             const float* __restrict__ bqkv,
                                             const bf16* __restrict__ bias,
                                             const int* __restrict__ region,
                                             bf16* __restrict__ ao, int bnw, int nw) {
  using P = HeadPlan<C>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t base = sm90::smem_addr(smem);
  const int h = blockIdx.x % P::HEADS, chunks = gridDim.x / P::HEADS, ch = blockIdx.x / P::HEADS;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, wq = warp % 4;
  const int lane = threadIdx.x % 32;
  const int er = 16 * wq + lane / 4, ec = 2 * (lane % 4);    // accumulator row and column
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + P::BAR);
  uint64_t* full = wbar + 1 + wg * 2 * P::XS;
  uint64_t* empty = full + P::XS;
  if (threadIdx.x == 0) {
    sm90::mbar_init(wbar, 1);
    for (int i = 0; i < P::WGN * 2 * P::XS; ++i)     // full: the TMA; empty: a warpgroup's warps
      sm90::mbar_init(wbar + 1 + i, i % (2 * P::XS) < P::XS ? 1 : 4);
    sm90::fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(wbar, P::KB * 96 * 128);
    for (int kb = 0; kb < P::KB; ++kb)
      for (int j = 0; j < 3; ++j)
        sm90::tma_load_2d(base + P::W + (kb * 3 + j) * HD * 128, &tm_qkv, kb * 64,
                          j * C + h * HD, wbar);
  }

  // this warpgroup's windows: first, first + stride, ...; use v of its ring
  // is k-block v % KB of its window v / KB
  const int stride = chunks * P::WGN, first = ch + chunks * wg;
  const int uses = first < bnw ? ((bnw - 1 - first) / stride + 1) * P::KB : 0;
  const uint32_t xs = base + P::WG0 + wg * P::WGB;
  unsigned char* tk = smem + P::WG0 + wg * P::WGB + P::XS * P::XT;
  unsigned char* tv = tk + P::QT;
  const bool issuer = threadIdx.x % 128 == 0;
  int issued = 0;
  auto issue_upto = [&](int upto) {
    for (; issued < upto && issued < uses; ++issued) {
      const int s = issued % P::XS;
      sm90::mbar_wait(empty + s, ((issued / P::XS) & 1) ^ 1);
      sm90::mbar_expect_tx(full + s, P::XT);
      sm90::tma_load_2d(xs + s * P::XT, &tm_x, (issued % P::KB) * 64,
                        (first + stride * (issued / P::KB)) * N, full + s);
    }
  };
  if (issuer) issue_upto(P::XS - 1);
  RingReader<P::XS, P::XT> ring{full, empty, xs};

  // the head's bias and this thread's bqkv, in registers for every window
  uint32_t bz[7][2];
  head_bias(bias + static_cast<size_t>(h) * N * N, wq, bz);
  float2 bq[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const int col = 8 * j + ec;
    bq[j] = *reinterpret_cast<const float2*>(bqkv + (col / HD) * C + h * HD + col % HD);
  }
  const float scale = round_to<bf16>(QK_SCALE);
  const uint64_t dw = sm90::sw128_desc(base + P::W);
  auto sync_own = [wg] { sm90::named_barrier(1 + wg, 128); };
  sm90::mbar_wait(wbar, 0);

  for (int u0 = 0; u0 < uses; u0 += P::KB) {
    const int w = first + stride * (u0 / P::KB);
    uint32_t differ = 0;
    if (region != nullptr) {
      const int* rr = region + static_cast<size_t>(w % nw) * N;
      differ = region_differ(wq, rr[lane], lane < N - 32 ? rr[32 + lane] : 0);
    }
    // q | k | v: [64, C] x [C, 96]
    float acc[48];
#pragma unroll
    for (int z = 0; z < 48; ++z) acc[z] = 0.0f;
#pragma unroll 1
    for (int kb = 0; kb < P::KB; ++kb) {
      const uint64_t da = sm90::sw128_desc(ring.acquire(issue_upto, issuer));
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < 64; k += 16)
        sm90::wgmma_ss(acc, sm90::desc_add(da, k * 2),
                       sm90::desc_add(dw, kb * 96 * 128 + k * 2), kb > 0 || k > 0);
      ring.retire();
    }
    ring.drain();
    sm90::fence_regs(acc);
    // + bqkv, rounded; q * scale rounded, as the A fragments of q k^T; k and
    // v into their tiles; rows past the window zero
    uint32_t qa[2][4];
#pragma unroll
    for (int j = 0; j < 12; ++j)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = er + 8 * hi, d = (8 * j + ec) % HD;
        const float v0 = round_to<bf16>(acc[4 * j + 2 * hi] + bq[j].x);
        const float v1 = round_to<bf16>(acc[4 * j + 2 * hi + 1] + bq[j].y);
        if (j < 4)
          qa[j / 2][(j % 2) * 2 + hi] = row < N ? pack_bf16(v0 * scale, v1 * scale) : 0u;
        else
          *reinterpret_cast<uint32_t*>((j < 8 ? tk : tv) + sm90::sw64_offset(row, d)) =
              row < N ? pack_bf16(v0, v1) : 0u;
      }
    sync_own();                         // k and v are whole
    float o[4][4];
    attend_q(qa, tk, tv, 0, bz, differ, o);
    // the head's columns of the attention output, rounded once
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int row = er + 8 * hi;
        if (row < N)
          *reinterpret_cast<uint32_t*>(ao + (static_cast<size_t>(w) * N + row) * C + h * HD +
                                       8 * nt + ec) = pack_bf16(o[nt][2 * hi], o[nt][2 * hi + 1]);
      }
    sync_own();                         // every warp is done with k and v
  }
}


}  // namespace swin
