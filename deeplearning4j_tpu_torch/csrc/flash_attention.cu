// FlashAttention forward and backward, never writing the [T, T] scores
// to memory.
//
// Forward: O = softmax(Q K^T * scale + mask) V, with the log-sum-exp of
// each row. Replaces deeplearning4j_tpu/kernels/flash_attention.py::
// _fwd_kernel (the Pallas kernel behind _flash_fwd_impl).
// Backward (FlashAttention-2 split, as the TPU kernels): dQ replaces
// _bwd_dq_kernel, dK/dV replaces _bwd_dkv_kernel (both behind
// _flash_bwd_impl). Both recompute p = exp(s - lse) from the LSE the
// forward wrote and read delta = rowsum(dO * O), computed outside.
//
// Layout: q, k, v, o, dO, dQ, dK, dV [B, T, H, D] f32 (the framework
// layout, read with strides, so no transpose); key_mask [B, T] f32 or
// null (> 0 = attend, shared by every head of a batch element); lse and
// delta [B, H, T] f32.
//
// What bounds them: operations. At T = 1024, D = 64, causal each does
// ~130 flops or more per byte it must move, so the arithmetic rate
// bounds it, not memory.
//
// All three run their products on the tensor cores in 3xTF32: each f32
// operand x splits into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// a product is lo*hi + hi*lo + hi*hi (small terms first, f32
// accumulation), which drops only lo*lo (~2^-22 of the product). That
// keeps f32 accuracy at the cost of three TF32 products per f32 product
// (the forward splits more cheaply, leaving lo for the tensor cores to
// truncate, which drops ~2^-20 instead: split_tf32_fast):
// the forward's output stays within 1e-4 of the plain f32 version (one
// TF32 pass errs by ~1e-3 there, which would move the served path's
// logits and break greedy parity with the reference; the split's error
// is ~1e-6, far below the logit margins that parity rests on), and the
// gradients within 1e-4 of theirs, times the largest gradient where it
// exceeds 1. So a kernel's bound is 3 x its flops at 495 TFLOP/s, beside
// its flops at the f32 rate (67 TFLOP/s): at H=8, T=1024, D=64, causal,
// the forward does 1.075 GFLOP at B=1 -> 0.0065 ms (0.0160 ms at f32)
// and 4.30 GFLOP at B=4 -> 0.0261 ms (0.0642 ms); at B=4, dQ 6.45 GFLOP
// -> 0.0391 ms (0.0962) and dK/dV 8.60 GFLOP -> 0.0521 ms (0.1283).
//
// Forward design (B3):
//  - One block per (64-row query tile, batch*head), in KG groups of 4
//    warps; warp w of a group owns query rows 16w .. 16w+15. Q is copied
//    once, split into hi and lo in shared memory, and at D <= 64 held in
//    registers as split A fragments.
//  - Group kg walks the key tiles kg, kg + KG, ... (BN = 32 keys, 16 at
//    D = 128) through its own two-stage cp.async ring, split in place as
//    in the backward but by split_tf32_fast (hi by an integer add and
//    mask, lo left for the tensor cores to truncate: 3 instructions
//    where cvt.rna with its NaN guard takes ~9, and measured faster on
//    the H100 at B=1 and B=4), with one barrier of its own per tile.
//  - KG answers the single wave at B = 1: 16 query tiles x 8 heads are
//    128 blocks on 132 SMs, so the kernel lasts as long as its longest
//    block, and under the causal mask the last query tile walks 16 times
//    the keys of the first. With KG = 2 each block's keys are split over
//    two groups, which halves that chain and puts two warps on every SM
//    sub-partition, with no second pass and no scratch: the groups'
//    (m, l, O) are merged once at the end through shared memory, always
//    group 0's first, so two calls give identical bits. A two-group
//    block takes a whole SM (1 block per SM, against 2 of one group),
//    so once the work, not the longest chain, sets the time, the merge
//    and the halved tiles per group cost more than the balance gains.
//    Measured on the H100 (chip_smoke.py key_group_sweep, H=8, D=64,
//    causal): two groups win at every served bucket at B=1 (T=1024:
//    0.0555 against 0.0656 ms; T=256: 0.0174 against 0.0197) and up to
//    336 blocks (by 2%), one group from 360 blocks on (training's B=4,
//    T=1024, 512 blocks: 0.1035 against 0.1197). So the wrapper passes
//    KG = 2 while the grid is at most 2.5 blocks per SM
//    (kernels/flash_attention.py key_groups_for). A consequence: a
//    row's bits (the order its keys are summed in) depend on the batch
//    it runs in and on the card's SM count, though both versions stay
//    within 1e-4 of the plain one. Smaller query tiles were not built:
//    a warp owns 16 query rows either way and the last one still walks
//    every key tile to the diagonal, so they would not shorten the
//    longest chain, which key groups halve.
//  - S = Q K^T stays in accumulator fragments; the online softmax runs in
//    registers on log2(e)-scaled scores (exp2f), each row's max reduced
//    over the four threads that hold it; P is formed in place and fed as
//    the A operand of O += P V through the FlashAttention-2 permutation
//    (frag_a_acc), so P never goes through shared memory. Each thread
//    sums its own columns of l and reduces them once at the end.
//  - Causal key tiles above the diagonal are never visited, a warp skips
//    the products of a tile wholly above its rows, and the grid runs the
//    last query tile (the longest) first.
//  - A row with no live key keeps m = -1e30: its O is exactly 0 and its
//    LSE exactly -1e30, as the backward's where-guards expect.
//
// Backward design (dQ and dK/dV):
//  - One block of 4 warps per (64-row tile, batch*head): a query tile
//    for dQ, a key tile for dK/dV (K outer, as in _bwd_dkv_kernel). Each
//    warp owns 16 rows of it. The block's own two tiles (Q and dO, or K
//    and V) stay in shared memory; the other side (K and V, or Q, dO and
//    their LSE and delta) streams through a two-stage ring of BN-row
//    tiles filled with cp.async (16-byte copies when D % 4 == 0 and the
//    tensors are 16-byte aligned, 4-byte copies otherwise; the ragged
//    edge is zero-filled by the copy's src-size operand). Tile k+1 loads
//    while tile k computes; one barrier per tile.
//  - Products are mma.sync.m16n8k8 TF32 (hand-loaded fragments, so any
//    layout works; wgmma would need transposed copies of three of the
//    operands). cvt.rna.tf32 is ~3 instructions (it guards NaN), so the
//    splits, not the tensor cores, set the pace: each streamed tile is
//    split once, in shared memory, by the threads that copied it (right
//    after their own cp.async wait, so no extra barrier; 16-byte vector
//    accesses, as scalar ones to a thread's own chunk conflict 4 ways),
//    instead of by every warp at every use; dQ holds its Q and dO
//    fragments split in registers (at D <= 64; dK/dV needs those
//    registers for its two accumulators and splits K and V on use).
//  - Scores stay in the accumulator fragments: S and dP for dQ (rows =
//    queries), S^T and dP^T for dK/dV (rows = keys, computed as K Q^T and
//    V dO^T). P and dS are formed in place and fed as the A operand of
//    the next product (dQ += dS K, dV += P^T dO, dK += dS^T Q) by
//    permuting the contraction index of the B fragment to the
//    accumulator's column order (k = t <-> column 2t, k = t + 4 <->
//    column 2t + 1). No product needs a shared-memory stage for P or dS.
//    p = exp2(s * scale * log2(e) - lse * log2(e)), one FFMA and ex2.
//  - Tile sizes (BwdTile): BN = 16 streamed rows for dQ at D = 64, 32
//    for dK/dV and for D = 32, 8 at D = 128, so every block takes at most
//    105 KB of shared memory and two blocks fit on an SM with no spill.
//  - Causal balance: dQ's grid runs the last query tile (the most key
//    tiles) first, dK/dV's the first key tile (the most query tiles)
//    first; a warp skips the products of a streamed tile that lies
//    wholly on the masked side of its 16 rows.
//  - Every dQ, dK and dV row has one owner block that sums in a fixed
//    order: no atomics, so two calls give identical bits.
//
// Shared by all three: tiles above the diagonal are skipped under the
// causal mask, and tiles past T are never visited. Masking as in the TPU
// kernels: masked scores are -1e30 and p is forced to 0 where masked. A
// fully masked row's LSE is -1e30, so exp(s - lse) would be 1 there: the
// backward where-guards p rather than relying on the exponential to
// underflow, which makes that row's gradients exactly 0.
// Not yet: wgmma/TMA, warp-specialised producers. Every warp reads the
// whole streamed tile's hi and lo fragments from shared memory, which
// with the tensor cores' mma.sync issue and the split instructions sets
// the pace; wgmma, whose B operand a warpgroup reads once, is the way
// past it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---- 3xTF32 mma.sync building blocks, scores in registers, cp.async ring ----

constexpr int kBwdWarps = 4;  // a backward block, a forward key group
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;  // a block's own tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Per head-dim bucket and kernel (DKV: dK/dV, else dQ): the streamed
// tile's rows, whether the warp's A fragments of the block's own tiles
// are held in registers (AFrags), and the dynamic shared memory: the
// block's two [kBwdRows][LD] tiles, two stages of two streamed [BN][LD]
// tiles each held as hi and lo, two stages of two [BN] row vectors. Two
// blocks fit on an SM at every D (launch bounds cap registers at 255).
template <int DMAX, bool DKV>
struct BwdTile {
  static constexpr int BN = DMAX == 128 ? 8 : DKV || DMAX == 32 ? 32 : 16;
  static constexpr bool kHeld = !DKV && DMAX <= 64;
  static constexpr int LD = DMAX + 4;
  static constexpr size_t kSmemBytes =
      (size_t)(2 * kBwdRows * LD + 8 * BN * LD + 4 * BN) * sizeof(float);
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32; lo keeps the remainder to ~2^-22 of |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The forward's split, in 3 instructions instead of ~9: hi is x rounded
// to TF32 half away from zero (cvt.rna's result for finite x, without
// its NaN guard: NaN stays NaN, only an infinity turns NaN), and lo =
// x - hi (exact) is left for the tensor cores, which read a TF32
// operand's top 19 bits and ignore the rest, so lo is truncated. lo*hi
// + hi*lo + hi*hi then drops ~2^-20 of the product instead of ~2^-22.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

template <bool kFast>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kFast)
    split_tf32_fast(x, hi, lo);
  else
    split_tf32(x, hi, lo);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b to f32 accuracy in three TF32 products, small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4). A: rows m0 + g
// (+8), columns c0 + t (+4) of a row-major [.][LD] tile.
template <int LD>
__device__ __forceinline__ void frag_a(const float* s, int m0, int c0,
                                       int g, int t, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const float* p = s + (m0 + g) * LD + c0 + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * LD], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * LD + 4], hi[3], lo[3]);
}

// The A fragments of a warp's 16 rows of a [.][LD] tile over the whole
// head dim, split. kHeld: loaded and split once per block into DMAX
// registers a thread (dQ at D <= 64, for Q and for dO); else each use
// loads and splits its step from shared memory (at D = 128 Q and dO
// would take 256 registers, and dK/dV needs its registers for two
// accumulators).
template <int DMAX, bool kHeld>
struct AFrags {
  static constexpr int KS = DMAX / 8;
  static constexpr int LD = DMAX + 4;
  uint32_t hi[kHeld ? KS : 1][4], lo[kHeld ? KS : 1][4];
  const float* tile;
  int m0, g, t;

  __device__ __forceinline__ AFrags(const float* s, int m0_, int g_, int t_)
      : tile(s), m0(m0_), g(g_), t(t_) {
    if constexpr (kHeld) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        frag_a<LD>(tile, m0, 8 * ks, g, t, hi[ks], lo[ks]);
    }
  }
  // step ks of the contraction over the head dim
  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4],
                                      uint32_t (&l)[4]) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = hi[ks][i];
        l[i] = lo[ks][i];
      }
    } else {
      frag_a<LD>(tile, m0, 8 * ks, g, t, h, l);
    }
  }
};

// B operands come from streamed tiles already split into hi and lo
// (split_tile_pair). B of X Y^T: B[k][n] = Y[n0 + n][c0 + k], Y a
// row-major [.][LD] tile.
template <int LD>
__device__ __forceinline__ void frag_b_rows(const float* yh, const float* yl,
                                            int n0, int c0, int g, int t,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const int o = (n0 + g) * LD + c0 + t;
  hi[0] = __float_as_uint(yh[o]);
  hi[1] = __float_as_uint(yh[o + 4]);
  lo[0] = __float_as_uint(yl[o]);
  lo[1] = __float_as_uint(yl[o + 4]);
}

// B of P Y with P an accumulator: B[k][n] = Y[r0 + k'][n0 + n], the
// contraction index permuted to the accumulator's column order (k = t is
// row r0 + 2t, k = t + 4 is row r0 + 2t + 1), see frag_a_acc
template <int LD>
__device__ __forceinline__ void frag_b_cols(const float* yh, const float* yl,
                                            int r0, int n0, int g, int t,
                                            uint32_t (&hi)[2],
                                            uint32_t (&lo)[2]) {
  const int o = (r0 + 2 * t) * LD + n0 + g;
  hi[0] = __float_as_uint(yh[o]);
  hi[1] = __float_as_uint(yh[o + LD]);
  lo[0] = __float_as_uint(yl[o]);
  lo[1] = __float_as_uint(yl[o + LD]);
}

// An accumulator (rows g, g + 8; columns 2t, 2t + 1) as the A operand of
// a product over its columns, in frag_b_cols's order
template <bool kFast = false>
__device__ __forceinline__ void frag_a_acc(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split<kFast>(c[0], hi[0], lo[0]);
  split<kFast>(c[2], hi[1], lo[1]);
  split<kFast>(c[1], hi[2], lo[2]);
  split<kFast>(c[3], hi[3], lo[3]);
}

// cp.async global -> shared; !valid writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows t0 .. t0+ROWS-1 of one (batch, head) of N [B, T, H, D] tensors
// into [ROWS][DMAX + 4] shared tiles, zero past T and past D; one index
// computation feeds the N copies. vec4: D % 4 == 0 and the tensors
// 16-byte aligned, so 16-byte copies.
template <int DMAX, int ROWS, int N>
__device__ __forceinline__ void async_tiles(float* const (&dst)[N],
                                            const float* const (&src)[N],
                                            size_t base, size_t row, int t0,
                                            int T, int D, bool vec4,
                                            int tid) {
  constexpr int LD = DMAX + 4;
  static_assert(ROWS * DMAX % (4 * kBwdThreads) == 0, "whole passes");
  if (vec4) {
    constexpr int CH = DMAX / 4;
#pragma unroll
    for (int i = 0; i < ROWS * CH / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int r = idx / CH, d = (idx % CH) * 4, t = t0 + r;
      const bool ok = t < T && d < D;
      const size_t off = ok ? base + (size_t)t * row + d : 0;
#pragma unroll
      for (int j = 0; j < N; ++j)
        cp_async16(dst[j] + r * LD + d, src[j] + off, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * DMAX / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int r = idx / DMAX, d = idx % DMAX, t = t0 + r;
      const bool ok = t < T && d < D;
      const size_t off = ok ? base + (size_t)t * row + d : 0;
#pragma unroll
      for (int j = 0; j < N; ++j)
        cp_async4(dst[j] + r * LD + d, src[j] + off, ok);
    }
  }
}

template <int DMAX, int ROWS>
__device__ __forceinline__ void async_tile_pair(
    float* dst_a, const float* __restrict__ src_a, float* dst_b,
    const float* __restrict__ src_b, size_t base, size_t row, int t0, int T,
    int D, bool vec4, int tid) {
  async_tiles<DMAX, ROWS, 2>({dst_a, dst_b}, {src_a, src_b}, base, row, t0,
                             T, D, vec4, tid);
}

template <bool kFast = false>
__device__ __forceinline__ void split_in_place(float* hi, float* lo) {
  uint32_t h, l;
  split<kFast>(*hi, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// The same for a 16-byte chunk: one vector load and two vector stores
// (scalar accesses to a thread's own chunk would conflict 4 ways)
template <bool kFast = false>
__device__ __forceinline__ void split_in_place4(float* hi, float* lo) {
  float4 x = *reinterpret_cast<const float4*>(hi);
  float* v = &x.x;
  float4 h, l;
  float* hv = &h.x;
  float* lv = &l.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t a, b;
    split<kFast>(v[e], a, b);
    hv[e] = __uint_as_float(a);
    lv[e] = __uint_as_float(b);
  }
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = l;
}

// After async_tiles' copies have landed: each thread splits the
// elements it copied itself (visible to it after its own wait, so no
// barrier is needed) into hi, in place, and lo. Every warp then reads
// ready TF32 pairs instead of splitting each element on each use.
template <int DMAX, int ROWS, int N, bool kFast>
__device__ __forceinline__ void split_tiles(float* const (&hi)[N],
                                            float* const (&lo)[N], bool vec4,
                                            int tid) {
  constexpr int LD = DMAX + 4;
  if (vec4) {
    constexpr int CH = DMAX / 4;
#pragma unroll
    for (int i = 0; i < ROWS * CH / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int o = (idx / CH) * LD + (idx % CH) * 4;
#pragma unroll
      for (int j = 0; j < N; ++j) split_in_place4<kFast>(hi[j] + o, lo[j] + o);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * DMAX / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int o = (idx / DMAX) * LD + idx % DMAX;
#pragma unroll
      for (int j = 0; j < N; ++j) split_in_place<kFast>(hi[j] + o, lo[j] + o);
    }
  }
}

template <int DMAX, int ROWS, bool kFast = false>
__device__ __forceinline__ void split_tile_pair(float* a_hi, float* a_lo,
                                                float* b_hi, float* b_lo,
                                                bool vec4, int tid) {
  split_tiles<DMAX, ROWS, 2, kFast>({a_hi, b_hi}, {a_lo, b_lo}, vec4, tid);
}

// src[i0 .. i0+n-1] into dst, 0 past `end`
__device__ __forceinline__ void async_vec(float* dst,
                                          const float* __restrict__ src,
                                          int i0, int n, int end, int tid) {
  if (tid < n) {
    const bool ok = i0 + tid < end;
    cp_async4(dst + tid, src + (ok ? i0 + tid : 0), ok);
  }
}

// dQ = sum over key tiles of dS K * scale, dS = P o (dO V^T - delta).
// Grid: (B*H, query tiles), the last query tile first; the query tile
// and its dO stay, K and V stream.
template <int DMAX>
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ key_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int T, int D, int causal, float scale, int vec4) {
  using Tile = BwdTile<DMAX, false>;
  constexpr int BN = Tile::BN;
  constexpr int LD = Tile::LD;
  constexpr int KS = DMAX / 8;  // 8-wide steps over the head dim
  constexpr int NB = BN / 8;    // 8-key blocks of a streamed tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [kBwdRows][LD]
  float* dOs = Qs + kBwdRows * LD;   // [kBwdRows][LD]
  float* ring = dOs + kBwdRows * LD;  // [2][K hi, K lo, V hi, V lo][BN][LD]
  float* okring = ring + 8 * BN * LD;  // [2][BN] 1 = key inside T, unmasked
  auto tile = [&](int st, int i) { return ring + (4 * st + i) * BN * LD; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int m0 = 16 * warp;  // the warp's rows of the tile

  // this thread's two rows: q0 + m0 + g and 8 below; p = exp2(s *
  // scale * log2(e) - lse * log2(e))
  const float sl2 = scale * kLog2e;
  float rlse[2], rdelta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + m0 + g + 8 * r;
    rlse[r] = qp < T ? lse[(size_t)bh * T + qp] * kLog2e : 0.f;
    rdelta[r] = qp < T ? delta[(size_t)bh * T + qp] : 0.f;
  }

  const int n_tiles = (T + BN - 1) / BN;
  int last = n_tiles - 1;
  if (causal) {
    const int diag = (q0 + kBwdRows - 1) / BN;
    last = diag < last ? diag : last;
  }
  auto load_kv = [&](int kt) {
    const int st = kt & 1;
    async_tile_pair<DMAX, BN>(tile(st, 0), k, tile(st, 2), v, base, row,
                              kt * BN, T, D, vec4, tid);
    if (key_mask != nullptr)
      async_vec(okring + st * BN, key_mask + (size_t)b * T, kt * BN, BN, T,
                tid);
    else if (tid < BN)
      okring[st * BN + tid] = kt * BN + tid < T ? 1.f : 0.f;
  };

  async_tile_pair<DMAX, kBwdRows>(Qs, q, dOs, dout, base, row, q0, T, D,
                                  vec4, tid);
  load_kv(0);
  cp_async_commit();
  cp_async_wait_all();
  split_tile_pair<DMAX, BN>(tile(0, 0), tile(0, 1), tile(0, 2), tile(0, 3),
                            vec4, tid);
  __syncthreads();
  const AFrags<DMAX, Tile::kHeld> qf(Qs, m0, g, t4), of(dOs, m0, g, t4);

  float acc[KS][4];  // dQ: rows g, g + 8; columns 8n + 2t4, + 1
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Each step: start loading tile kt + 1, compute tile kt, then wait for
  // and split tile kt + 1; the barrier ends the step.
  for (int kt = 0; kt <= last; ++kt) {
    const int st = kt & 1;
    if (kt < last) load_kv(kt + 1);
    cp_async_commit();
    const int k0 = kt * BN;
    // a warp whose rows all lie before the tile's first key has nothing
    // to add
    if (!causal || k0 <= q0 + m0 + 15) {
      const float *Kh = tile(st, 0), *Kl = tile(st, 1);
      const float *Vh = tile(st, 2), *Vl = tile(st, 3);
      const float* oks = okring + st * BN;

      float s[NB][4], dp[NB][4];  // Q K^T, dO V^T: keys 8nb + 2t4, + 1
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        qf.get(ks, qh, ql);
        of.get(ks, oh, ol);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bhi[2], blo[2];
          frag_b_rows<LD>(Kh, Kl, 8 * nb, 8 * ks, g, t4, bhi, blo);
          mma_3xtf32(s[nb], qh, ql, bhi, blo);
          frag_b_rows<LD>(Vh, Vl, 8 * nb, 8 * ks, g, t4, bhi, blo);
          mma_3xtf32(dp[nb], oh, ol, bhi, blo);
        }
      }
      // dS = P o (dP - delta) in place of S, P recomputed under the guard
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = 8 * nb + 2 * t4 + (e & 1);
          const int qp = q0 + m0 + g + 8 * r;
          const bool ok = oks[c] > 0.f && (!causal || k0 + c <= qp);
          const float p = ok ? exp2f(fmaf(s[nb][e], sl2, -rlse[r])) : 0.f;
          s[nb][e] = p * (dp[nb][e] - rdelta[r]);
        }
      // dQ += dS K, dS straight from the accumulators
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ah[4], al[4];
        frag_a_acc(s[j], ah, al);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_cols<LD>(Kh, Kl, 8 * j, 8 * n, g, t4, bhi, blo);
          mma_3xtf32(acc[n], ah, al, bhi, blo);
        }
      }
    }
    cp_async_wait_all();
    if (kt < last)
      split_tile_pair<DMAX, BN>(tile(st ^ 1, 0), tile(st ^ 1, 1),
                                tile(st ^ 1, 2), tile(st ^ 1, 3), vec4, tid);
    __syncthreads();  // tile kt + 1 is in and split; tile kt is done
  }

#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qp = q0 + m0 + g + 8 * (e >> 1);
      const int d = 8 * n + 2 * t4 + (e & 1);
      if (qp < T && d < D) dq[base + (size_t)qp * row + d] = acc[n][e] * scale;
    }
}

// dV = sum over query tiles of P^T dO; dK = sum of dS^T Q * scale.
// Grid: (B*H, key tiles), the first key tile (the most query tiles under
// the causal mask) first; K and V stay, Q, dO, LSE and delta stream from
// the diagonal down. Scores are computed transposed (rows = keys), so
// P^T and dS^T are accumulators ready to be A operands.
template <int DMAX>
__global__ void __launch_bounds__(kBwdThreads, 2)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ key_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int T, int D, int causal, float scale, int vec4) {
  using Tile = BwdTile<DMAX, true>;
  constexpr int BN = Tile::BN;
  constexpr int LD = Tile::LD;
  constexpr int KS = DMAX / 8;
  constexpr int NB = BN / 8;  // 8-query blocks of a streamed tile
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                   // [kBwdRows][LD]
  float* Vs = Ks + kBwdRows * LD;     // [kBwdRows][LD]
  float* ring = Vs + kBwdRows * LD;   // [2][Q hi, Q lo, dO hi, dO lo][BN][LD]
  float* lring = ring + 8 * BN * LD;  // [2][BN] lse
  float* dring = lring + 2 * BN;      // [2][BN] delta
  auto tile = [&](int st, int i) { return ring + (4 * st + i) * BN * LD; };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int k0 = blockIdx.y * kBwdRows;
  const int m0 = 16 * warp;
  const float sl2 = scale * kLog2e;

  // this thread's two key rows: k0 + m0 + g and 8 below
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + m0 + g + 8 * r;
    kok[r] = kp < T &&
             (key_mask == nullptr || key_mask[(size_t)b * T + kp] > 0.f);
  }

  const int n_tiles = (T + BN - 1) / BN;
  // query tiles wholly above this key tile see none of its keys
  const int first = causal ? k0 / BN : 0;
  auto load_q = [&](int qt) {
    const int st = (qt - first) & 1;
    async_tile_pair<DMAX, BN>(tile(st, 0), q, tile(st, 2), dout, base, row,
                              qt * BN, T, D, vec4, tid);
    async_vec(lring + st * BN, lse + (size_t)bh * T, qt * BN, BN, T, tid);
    async_vec(dring + st * BN, delta + (size_t)bh * T, qt * BN, BN, T, tid);
  };

  async_tile_pair<DMAX, kBwdRows>(Ks, k, Vs, v, base, row, k0, T, D, vec4,
                                  tid);
  load_q(first);
  cp_async_commit();
  cp_async_wait_all();
  split_tile_pair<DMAX, BN>(tile(0, 0), tile(0, 1), tile(0, 2), tile(0, 3),
                            vec4, tid);
  __syncthreads();
  const AFrags<DMAX, Tile::kHeld> kf(Ks, m0, g, t4), vf(Vs, m0, g, t4);

  float dka[KS][4], dva[KS][4];  // rows g, g + 8; columns 8n + 2t4, + 1
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  // Each step: start loading tile qt + 1, compute tile qt, then wait for
  // and split tile qt + 1; the barrier ends the step.
  for (int qt = first; qt < n_tiles; ++qt) {
    const int st = (qt - first) & 1;
    if (qt + 1 < n_tiles) load_q(qt + 1);
    cp_async_commit();
    const int t0 = qt * BN;
    // a warp whose keys all lie after the tile's last query has nothing
    // to add
    if (!causal || t0 + BN - 1 >= k0 + m0) {
      const float *Qh = tile(st, 0), *Ql = tile(st, 1);
      const float *dOh = tile(st, 2), *dOl = tile(st, 3);
      const float* ls = lring + st * BN;
      const float* ds = dring + st * BN;

      float s[NB][4], dp[NB][4];  // K Q^T, V dO^T: queries 8nb + 2t4, + 1
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        kf.get(ks, kh, kl);
        vf.get(ks, vh, vl);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bhi[2], blo[2];
          frag_b_rows<LD>(Qh, Ql, 8 * nb, 8 * ks, g, t4, bhi, blo);
          mma_3xtf32(s[nb], kh, kl, bhi, blo);
          frag_b_rows<LD>(dOh, dOl, 8 * nb, 8 * ks, g, t4, bhi, blo);
          mma_3xtf32(dp[nb], vh, vl, bhi, blo);
        }
      }
      // P^T in place of S^T, dS^T = P^T o (dP^T - delta) in place of dP^T
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = 8 * nb + 2 * t4 + (e & 1);  // query row of the tile
          const int qp = t0 + c;
          const bool ok = kok[r] && qp < T &&
                          (!causal || k0 + m0 + g + 8 * r <= qp);
          const float p =
              ok ? exp2f(fmaf(s[nb][e], sl2, -ls[c] * kLog2e)) : 0.f;
          s[nb][e] = p;
          dp[nb][e] = p * (dp[nb][e] - ds[c]);
        }
      // dV += P^T dO, dK += dS^T Q, both A operands from the accumulators
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ph[4], pl[4], sh[4], sl[4];
        frag_a_acc(s[j], ph, pl);
        frag_a_acc(dp[j], sh, sl);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_cols<LD>(dOh, dOl, 8 * j, 8 * n, g, t4, bhi, blo);
          mma_3xtf32(dva[n], ph, pl, bhi, blo);
          frag_b_cols<LD>(Qh, Ql, 8 * j, 8 * n, g, t4, bhi, blo);
          mma_3xtf32(dka[n], sh, sl, bhi, blo);
        }
      }
    }
    cp_async_wait_all();
    if (qt + 1 < n_tiles)
      split_tile_pair<DMAX, BN>(tile(st ^ 1, 0), tile(st ^ 1, 1),
                                tile(st ^ 1, 2), tile(st ^ 1, 3), vec4, tid);
    __syncthreads();  // tile qt + 1 is in and split; tile qt is done
  }

#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kp = k0 + m0 + g + 8 * (e >> 1);
      const int d = 8 * n + 2 * t4 + (e & 1);
      if (kp < T && d < D) {
        dk[base + (size_t)kp * row + d] = dka[n][e] * scale;
        dv[base + (size_t)kp * row + d] = dva[n][e];
      }
    }
}

// ---- forward (B3): 3xTF32 mma.sync, P in registers, key groups ----

// A fragments of a warp's 16 rows of a tile already split into hi and lo
// in shared memory: held in registers (kHeld) or read at each use.
template <int DMAX, bool kHeld>
struct SplitAFrags {
  static constexpr int KS = DMAX / 8;
  static constexpr int LD = DMAX + 4;
  uint32_t hi[kHeld ? KS : 1][4], lo[kHeld ? KS : 1][4];
  const float *th, *tl;
  int o;  // (m0 + g) * LD + t

  __device__ __forceinline__ SplitAFrags(const float* h, const float* l,
                                         int m0, int g, int t)
      : th(h), tl(l), o((m0 + g) * LD + t) {
    if constexpr (kHeld) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) read(ks, hi[ks], lo[ks]);
    }
  }
  __device__ __forceinline__ void read(int ks, uint32_t (&h)[4],
                                       uint32_t (&l)[4]) const {
    const int p = o + 8 * ks;
    h[0] = __float_as_uint(th[p]);
    h[1] = __float_as_uint(th[p + 8 * LD]);
    h[2] = __float_as_uint(th[p + 4]);
    h[3] = __float_as_uint(th[p + 8 * LD + 4]);
    l[0] = __float_as_uint(tl[p]);
    l[1] = __float_as_uint(tl[p + 8 * LD]);
    l[2] = __float_as_uint(tl[p + 4]);
    l[3] = __float_as_uint(tl[p + 8 * LD + 4]);
  }
  __device__ __forceinline__ void get(int ks, uint32_t (&h)[4],
                                      uint32_t (&l)[4]) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h[i] = hi[ks][i];
        l[i] = lo[ks][i];
      }
    } else {
      read(ks, h, l);
    }
  }
};

// Per head-dim bucket and key-group count KG: the streamed tile's rows,
// whether Q's fragments are held in registers, and the dynamic shared
// memory: Q split into hi and lo ([64][LD] each), and per key group two
// stages of K hi, K lo, V hi, V lo ([BN][LD] each) and of the [BN] key
// flags.
template <int DMAX, int KG>
struct FwdTile {
  static constexpr int BN = DMAX == 128 ? 16 : 32;
  static constexpr bool kHeld = DMAX <= 64;
  static constexpr int LD = DMAX + 4;
  static constexpr int kRing = 8 * BN * LD + 2 * BN;  // floats a group
  static constexpr int kThreads = KG * kBwdThreads;
  static constexpr size_t kSmemBytes =
      (size_t)(2 * kBwdRows * LD + KG * kRing) * sizeof(float);
};

__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(kBwdThreads) : "memory");
}

// O = softmax(Q K^T * scale + mask) V and the LSE of each row. Grid:
// (B*H, query tiles), the last query tile (the most key tiles under the
// causal mask) first. A block is KG groups of 4 warps; warp w of a group
// owns rows 16w .. 16w+15 of the 64-row query tile, and group kg walks
// the key tiles kg, kg + KG, ... through its own cp.async ring, so the
// longest query tile's chain of key tiles is KG times shorter. The
// groups' (m, l, O) are merged at the end in a fixed order.
template <int DMAX, int KG>
__global__ void __launch_bounds__(KG * kBwdThreads, KG == 1 ? 2 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask,
                 float* __restrict__ o, float* __restrict__ lse, int H,
                 int T, int D, int causal, float scale, int vec4) {
  using Tile = FwdTile<DMAX, KG>;
  constexpr int BN = Tile::BN;
  constexpr int LD = Tile::LD;
  constexpr int KS = DMAX / 8;  // 8-wide steps over the head dim
  constexpr int NB = BN / 8;    // 8-key blocks of a streamed tile
  extern __shared__ __align__(16) float smem[];
  float* Qh = smem;                   // [kBwdRows][LD]
  float* Ql = Qh + kBwdRows * LD;     // [kBwdRows][LD]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int kg = warp / kBwdWarps;    // the warp's key group
  const int gtid = tid % kBwdThreads;  // thread index in the group
  float* ring = Ql + kBwdRows * LD + kg * Tile::kRing;
  float* okring = ring + 8 * BN * LD;  // [2][BN] 1 = key inside T, unmasked
  auto tile = [&](int st, int i) { return ring + (4 * st + i) * BN * LD; };

  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdRows;
  const int m0 = 16 * (warp % kBwdWarps);  // the warp's rows of the tile
  const float sl2 = scale * kLog2e;        // scores in log2 units

  const int n_tiles = (T + BN - 1) / BN;
  int last = n_tiles - 1;
  if (causal) {
    const int diag = (q0 + kBwdRows - 1) / BN;
    last = diag < last ? diag : last;
  }
  auto load_kv = [&](int kt, int st) {
    async_tile_pair<DMAX, BN>(tile(st, 0), k, tile(st, 2), v, base, row,
                              kt * BN, T, D, vec4, gtid);
    if (key_mask != nullptr)
      async_vec(okring + st * BN, key_mask + (size_t)b * T, kt * BN, BN, T,
                gtid);
    else if (gtid < BN)
      okring[st * BN + gtid] = kt * BN + gtid < T ? 1.f : 0.f;
  };

  // each group copies and splits its share of Q, then its first tile
  constexpr int QR = kBwdRows / KG;
  async_tiles<DMAX, QR, 1>({Qh + kg * QR * LD}, {q}, base, row, q0 + kg * QR,
                          T, D, vec4, gtid);
  if (kg <= last) load_kv(kg, 0);
  cp_async_commit();
  cp_async_wait_all();
  split_tiles<DMAX, QR, 1, true>({Qh + kg * QR * LD}, {Ql + kg * QR * LD},
                                vec4, gtid);
  if (kg <= last)
    split_tile_pair<DMAX, BN, true>(tile(0, 0), tile(0, 1), tile(0, 2),
                                    tile(0, 3), vec4, gtid);
  __syncthreads();
  const SplitAFrags<DMAX, Tile::kHeld> qf(Qh, Ql, m0, g, t4);

  // this thread's rows q0 + m0 + g and 8 below: running max (log2
  // units), its own columns' share of the sum, and O's columns 8n + 2t4,
  // + 1
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // Each step: start loading the group's next tile, compute this one,
  // then wait for and split the next; the group's barrier ends the step.
  for (int kt = kg, st = 0; kt <= last; kt += KG, st ^= 1) {
    if (kt + KG <= last) load_kv(kt + KG, st ^ 1);
    cp_async_commit();
    const int k0 = kt * BN;
    // a warp whose rows all lie before the tile's first key has nothing
    // to add
    if (!causal || k0 <= q0 + m0 + 15) {
      const float *Kh = tile(st, 0), *Kl = tile(st, 1);
      const float *Vh = tile(st, 2), *Vl = tile(st, 3);
      const float* oks = okring + st * BN;

      float s[NB][4];  // Q K^T: keys 8nb + 2t4, + 1
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qh[4], ql[4];
        qf.get(ks, qh, ql);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          uint32_t bhi[2], blo[2];
          frag_b_rows<LD>(Kh, Kl, 8 * nb, 8 * ks, g, t4, bhi, blo);
          mma_3xtf32(s[nb], qh, ql, bhi, blo);
        }
      }
      // online softmax: masked scores are -1e30 and their p is 0; a row's
      // max is reduced over the quad that holds it
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int c = 8 * nb + 2 * t4 + (e & 1);
          const bool ok = oks[c] > 0.f &&
                          (!causal || k0 + c <= q0 + m0 + g + 8 * r);
          s[nb][e] = ok ? s[nb][e] * sl2 : kNegInf;
          mx[r] = fmaxf(mx[r], s[nb][e]);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float corr = exp2f(m[r] - mx[r]);
        l[r] *= corr;
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          acc[n][2 * r] *= corr;
          acc[n][2 * r + 1] *= corr;
        }
        m[r] = mx[r];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p =
              s[nb][e] > kNegInf ? exp2f(s[nb][e] - m[r]) : 0.f;
          l[r] += p;
          s[nb][e] = p;
        }
      // O += P V, P straight from the accumulators
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        uint32_t ah[4], al[4];
        frag_a_acc<true>(s[j], ah, al);
#pragma unroll
        for (int n = 0; n < KS; ++n) {
          uint32_t bhi[2], blo[2];
          frag_b_cols<LD>(Vh, Vl, 8 * j, 8 * n, g, t4, bhi, blo);
          mma_3xtf32(acc[n], ah, al, bhi, blo);
        }
      }
    }
    cp_async_wait_all();
    if (kt + KG <= last)
      split_tile_pair<DMAX, BN, true>(tile(st ^ 1, 0), tile(st ^ 1, 1),
                                      tile(st ^ 1, 2), tile(st ^ 1, 3), vec4,
                                      gtid);
    group_barrier(1 + kg);  // the next tile is in and split; this one done
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if constexpr (KG == 2) {
    // group 1 hands its state to group 0 through its own (finished) ring,
    // slot-major so that a warp's accesses are consecutive; group 0
    // merges the two in a fixed order
    constexpr int kSlots = 4 + 4 * KS;
    float* xfer = Ql + kBwdRows * LD + Tile::kRing;
    if (kg == 1) {
      xfer[0 * kBwdThreads + gtid] = m[0];
      xfer[1 * kBwdThreads + gtid] = m[1];
      xfer[2 * kBwdThreads + gtid] = l[0];
      xfer[3 * kBwdThreads + gtid] = l[1];
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xfer[(4 + 4 * n + e) * kBwdThreads + gtid] = acc[n][e];
    }
    static_assert(kSlots * kBwdThreads <= Tile::kRing, "hand-over fits");
    __syncthreads();
    if (kg == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xfer[r * kBwdThreads + gtid];
      const float mm = fmaxf(m[r], m1);
      const float c0 = exp2f(m[r] - mm), c1 = exp2f(m1 - mm);
      l[r] = l[r] * c0 + xfer[(2 + r) * kBwdThreads + gtid] * c1;
#pragma unroll
      for (int n = 0; n < KS; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e)
          acc[n][e] = acc[n][e] * c0 +
                      xfer[(4 + 4 * n + e) * kBwdThreads + gtid] * c1;
      m[r] = mm;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + m0 + g + 8 * r;
    if (qp >= T) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const float inv = 1.f / lc;
#pragma unroll
    for (int n = 0; n < KS; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        const int d = 8 * n + 2 * t4 + (e & 1);
        if (d < D) o[base + (size_t)qp * row + d] = acc[n][e] * inv;
      }
    // a row with no live key keeps m = -1e30 and gets LSE -1e30 exactly
    if (t4 == 0)
      lse[(size_t)bh * T + qp] =
          m[r] > kNegInf ? m[r] * kLn2 + logf(lc) : kNegInf;
  }
}

// ---- bf16 legs (B3, B6, B7 on bf16 operands) ----
//
// Replace the same three TPU kernels for bf16 q, k, v and dO
// (deeplearning4j_tpu/kernels/flash_attention.py: _fwd_kernel, which
// casts each block to f32 and writes O in q's dtype, :90-92 and :116;
// _bwd_dq_kernel, :189-192 and :211; _bwd_dkv_kernel, :236-239 and
// :260-261). O, dQ, dK and dV are bf16; the LSE, delta and the key mask
// stay f32 [B, H, T] and [B, T] as in the f32 legs.
//
// Arithmetic. Every product is wgmma (m64n64k16; the forward's S = Q K^T
// m64n128k16) on bf16 operands with f32 accumulation. A product of two bf16 values is exact in f32, so S =
// Q K^T and dP = dO V^T equal the reference's f32 dot of the bf16 values
// up to the order of the f32 sums. The second products (O += P V, dQ +=
// dS K, dV += P^T dO, dK += dS^T Q) need P or dS as bf16 A operands: P
// and dS are rounded to bf16 (round to nearest even, ~2^-9 of each term)
// right before them. That rounding, and the final rounding of O, dQ, dK
// and dV to bf16, are the legs' only errors beyond the order of the sums
// and ex2.approx's ~2^-22. The softmax, the LSE and delta stay f32.
//
// Bounds on this card (989 TFLOP/s bf16 dense, 3.35 TB/s; each input
// read once, each output written once) at the training shapes B=4, H=8,
// T=1024, D=64, causal (524,800 live (query, key) pairs a head):
//  - forward: 4.298 GFLOP -> 0.00435 ms; q, k, v, O in bf16 (16.78 MB)
//    with the mask (16 KB) and the LSE (131 KB): 16.92 MB -> 0.00505 ms,
//    so bytes bound it, at 0.00505 ms;
//  - dQ: 6.449 GFLOP -> 0.00652 ms; q, k, v, dO read and dQ written
//    (20.97 MB) with LSE, delta and mask: 21.25 MB -> 0.00634 ms, so
//    operations bound it, at 0.00652 ms;
//  - dK/dV: 8.598 GFLOP -> 0.00869 ms; 25.44 MB -> 0.00760 ms:
//    operations, at 0.00869 ms.
// All three sit near the ridge (~300 flops a byte), so neither the
// tensor cores nor memory alone sets the pace. Per 64 x 64 tile of
// scores a warpgroup issues 8 (forward) to 16 (dK/dV) wgmma of 32
// tensor-core cycles each at the card's peak, and the forward takes
// 4,096 exponentials of the 16 a cycle an SM's special-function units
// give: as long as the products (~256 cycles). So latency, and which
// unit waits for which, sets the pace, not any one unit's rate: a
// clock64 trace of one forward block spent most of each tile in the
// softmax, both warpgroups at once, with the tensor cores idle.
//
// One design for all three (wgmma fed by TMA, warp-specialised):
//  - a block of 384 threads: two consumer warpgroups own 64 rows each of
//    a 128-row tile (queries for the forward and dQ, keys for dK/dV), and
//    one warp of the third streams the other side (K and V, or Q and dO)
//    in 64-row tiles (the forward 128) through a ring of three stages
//    (the forward four; two at D = 128) in shared memory, which both
//    consumers read. setmaxnreg moves
//    registers from the producer warpgroup (56) to the consumers (224):
//    no spills at any D;
//  - TMA copies every tile (4-D tensor maps over [B, T, H, D], boxes of
//    64 columns by 64 rows (the forward 128), encoded on the host at each launch through
//    the runtime's driver entry point) in the 128-byte swizzle that the
//    wgmma descriptors read; rows past T and columns past D arrive as 0.
//    Where TMA cannot take the strides (D % 8 != 0, or a tensor not
//    16-byte aligned), the producer warp writes the same swizzled bytes
//    with 2-byte loads, then a proxy fence; the consumers do not change;
//  - mbarriers, no block-wide barrier in the loop: a stage's full
//    barrier completes on the tiles' bytes and the producer's arrival
//    with the stage's f32 vectors (forward and dQ: each key's predicate,
//    key mask and T, and for the forward whether every key of the tile
//    is live; dK/dV: the queries' LSE in log2 units, +inf past T, and
//    delta), which it reads from global memory one tile ahead so their
//    latency hides behind the wait for a free stage; its empty barrier
//    on one arrival from each of the 8 consumer warps once their
//    products on the stage have completed;
//  - the first products take the block's own rows as A (dQ and dK/dV:
//    held in registers at D <= 64, read by ldmatrix through the swizzle
//    once a block; from shared memory at D = 128 and in the forward) and
//    the streamed tile as a
//    K-major B: S = Q K^T (forward, dQ), dP = dO V^T (dQ), S^T = K Q^T
//    and dP^T = V dO^T (dK/dV). The second products, O += P V, dQ += dS
//    K, dV += P^T dO and dK += dS^T Q, take A = P or dS from the
//    accumulators (the m64nNk16 accumulator has mma.sync's per-warp
//    layout, so two 8-column blocks pack into a k step's A) and B = the
//    same streamed tile read MN-major through the transpose bit: no tile
//    is stored twice, and P and dS never touch shared memory;
//  - an exponential is one FFMA and one ex2.approx (exp2f's range check
//    and rescale cost more than the products here); the causal compare
//    runs only on the diagonal tile, the key's predicate is one select a
//    column (forward, dQ) or a row (dK/dV), and the where-guard stays
//    wherever a key can be masked, so a fully masked row's O and
//    gradients are exactly 0 and its LSE -1e30;
//  - causal tiles wholly above the diagonal are never loaded, a
//    warpgroup waits for and releases, but skips, a stage wholly on the
//    masked side of its rows, and the grid runs the longest tiles first
//    (forward and dQ the last query tile, dK/dV the first key tile);
//  - one owner block per output row, summing in a fixed order, no
//    atomics: two calls give the same bits.
//
// The forward's own parts (B3):
//  - online softmax per row over its running max m of the raw scores,
//    reduced over the 4 threads that hold the row: p = 2^(s c - m c)
//    with c = scale log2(e), the O accumulator and the row's sum l
//    corrected once a tile by 2^((m_old - m_new) c); each thread sums
//    its own columns of l, reduced once at the end; LSE = m scale +
//    log(l) in f32;
//  - a tile off the diagonal whose keys are all live (the producer's
//    flag) takes no select; elsewhere a masked score is -1e30 and p is
//    where-guarded to 0, so a row with no live key keeps m = -1e30;
//  - one tile at a time: S, the softmax, then P V, each waited for;
//  - tried on the H100 in scratch builds, timed in turns, and dropped:
//    the softmax of tile i beside P V of tile i - 1 (no faster), beside
//    S of tile i + 1 as well (slower: ptxas serialised the products),
//    the two warpgroups taking turns to issue their products (slower
//    where it ran; launch failures at T = 64), 64-key tiles (slower at
//    long T, no faster at the training shape), the key mask read four
//    tiles ahead (no change), and Q held in registers: in the
//    one-tile-at-a-time loop ptxas reused those registers for the
//    softmax (wrong results), and where right it was no faster.
// Not yet (forward): the tensor cores kept busy while the softmax runs;
// the softmax's special-function work moved in part to the FMA units.
//
// Per head-dim bucket and block: the padded width DP (64 or 128 columns,
// held as 64-wide swizzled panels; D <= 32 is read into one panel whose
// upper half is zero), the 16-wide contraction steps over the head dim,
// the streamed tile (BN rows), the block's own rows (BM: two consumer
// warpgroups of 64), the ring's stages and the dynamic shared memory:
// NOWN own tiles (2: Q and dO, or K and V; the forward 1: Q), two
// streamed tiles and two [BN] f32 vectors a stage, the barriers, and
// 1024 bytes to align the panels.
template <int DMAX, int NOWN = 2, int BN_ = 64>
struct Wg {
  static constexpr int DP = DMAX < 64 ? 64 : DMAX;
  static constexpr int NP = DP / 64;    // 64-column panels
  static constexpr int KS = DMAX / 16;  // k steps over the head dim
  static constexpr int BN = BN_;
  static constexpr int BM = 128;
  static constexpr int STAGES = NP == 1 ? (NOWN == 1 ? 4 : 3) : 2;
  static constexpr int NOWN_ = NOWN;
  static constexpr int kThreads = 384;  // consumers 0..255, producer WG
  static constexpr uint32_t OWN = NP * BM * 128;     // bytes, own tile
  static constexpr uint32_t STREAM = NP * BN * 128;  // bytes, streamed
  static constexpr size_t kSmemBytes = 1024 + NOWN * OWN +
                                       STAGES * 2 * (STREAM + BN * 4) +
                                       (2 * STAGES + 1) * 8;
};

__device__ __forceinline__ uint16_t f32_to_bf16(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// two f32 values rounded to bf16 (nearest even), lo in the low half as
// the A fragments expect the lower column there
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The block's shared memory, carved from the dynamic allocation: own
// tiles [NOWN][NP][BM][64], ring [STAGES][2][NP][BN][64] (bf16,
// swizzled), vectors [STAGES][2][BN] f32, barriers full[STAGES],
// empty[STAGES], own.
template <typename W>
struct WgSmem {
  unsigned char* own;
  unsigned char* ring;
  float* vec;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* own_bar;

  __device__ __forceinline__ explicit WgSmem(unsigned char* raw) {
    own = raw + ((1024 - (sm90::smem_u32(raw) & 1023)) & 1023);
    ring = own + W::NOWN_ * W::OWN;
    vec = reinterpret_cast<float*>(ring + W::STAGES * 2 * W::STREAM);
    full = reinterpret_cast<uint64_t*>(vec + W::STAGES * 2 * W::BN);
    empty = full + W::STAGES;
    own_bar = empty + W::STAGES;
  }
  __device__ __forceinline__ unsigned char* stage(int s) const {
    return ring + s * 2 * W::STREAM;
  }
  // every barrier, by one thread, before the block's roles part
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < W::STAGES; ++s) {
      sm90::mbar_init(&full[s], 2);   // the tiles' bytes, the vectors
      sm90::mbar_init(&empty[s], 8);  // each consumer warp
    }
    sm90::mbar_init(own_bar, 1);
    sm90::fence_mbar_init();
  }
};

// Rows t0 .. t0 + rows - 1 of one (batch, head) of a bf16 [B, T, H, D]
// tensor into NP swizzled [rows][64] panels at dst, zero past T and past
// D: the bytes TMA would write, by one warp's 2-byte loads (for strides
// or alignments TMA does not take; cp.async cannot copy 2-byte pieces
// either)
template <int NP>
__device__ void fill_panels(unsigned char* dst, const uint16_t* src,
                            size_t base, size_t row, int t0, int rows, int T,
                            int D, int lane) {
  for (int idx = lane; idx < rows * NP * 64; idx += 32) {
    const int r = idx / (NP * 64), c = idx % (NP * 64), t = t0 + r;
    const uint16_t x = t < T && c < D ? src[base + (size_t)t * row + c] : 0;
    *reinterpret_cast<uint16_t*>(dst + (c >> 6) * rows * 128 +
                                 sm90::swz128(r, c & 63)) = x;
  }
}

// The producer warp: the block's NOWN own tiles (rows own_t0 .., from
// own_map[j] or own[j]) once, then n pairs of streamed tiles (tile first
// + i at rows 64 (first + i), from map0 and map1 or src0 and src1)
// through the ring, by TMA when `tma`, else by fill_panels and a proxy
// fence. Each stage also gets up to two [BN] f32 vectors: load(t0, v)
// reads a lane's share of them from global memory into registers one
// tile ahead (so their latency hides behind the wait for a free stage)
// and store(stage, v) writes them. A stage's full barrier takes two
// arrivals: the tiles' (with their bytes) and the vectors'.
template <typename W, typename Load, typename Store>
__device__ __forceinline__ void wg_produce(
    const WgSmem<W>& sm, const CUtensorMap* const (&own_map)[W::NOWN_],
    const CUtensorMap* map0, const CUtensorMap* map1,
    const uint16_t* const (&own)[W::NOWN_], const uint16_t* src0,
    const uint16_t* src1, int b, int h, size_t base, size_t row, int own_t0,
    int first, int n, int T, int D, bool tma, int lane, Load load,
    Store store) {
  constexpr int NOWN = W::NOWN_;
  float v[4];
  load(first * W::BN, v);
  const uint32_t own_s = sm90::smem_u32(sm.own);
  if (tma) {
    if (lane == 0) {
      sm90::mbar_arrive_tx(sm.own_bar, NOWN * W::OWN);
#pragma unroll
      for (int j = 0; j < NOWN; ++j)
#pragma unroll
        for (int p = 0; p < W::NP; ++p)
#pragma unroll
          for (int rr = 0; rr < W::BM / W::BN; ++rr)
            sm90::tma_load_4d(
                own_s + j * W::OWN + (p * W::BM + rr * W::BN) * 128,
                own_map[j], sm.own_bar, 64 * p, h, own_t0 + rr * W::BN, b);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NOWN; ++j)
      fill_panels<W::NP>(sm.own + j * W::OWN, own[j], base, row, own_t0,
                         W::BM, T, D, lane);
    sm90::fence_proxy_async();
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(sm.own_bar);
  }
  for (int i = 0; i < n; ++i) {
    const int s = i % W::STAGES;
    sm90::mbar_wait(&sm.empty[s], ((i / W::STAGES) & 1) ^ 1);
    const int t0 = (first + i) * W::BN;
    unsigned char* tile = sm.stage(s);
    if (tma) {
      if (lane == 0) {
        const uint32_t dst = sm90::smem_u32(tile);
        sm90::mbar_arrive_tx(&sm.full[s], 2 * W::STREAM);
#pragma unroll
        for (int p = 0; p < W::NP; ++p) {
          sm90::tma_load_4d(dst + p * W::BN * 128, map0, &sm.full[s], 64 * p,
                            h, t0, b);
          sm90::tma_load_4d(dst + W::STREAM + p * W::BN * 128, map1,
                            &sm.full[s], 64 * p, h, t0, b);
        }
      }
    } else {
      fill_panels<W::NP>(tile, src0, base, row, t0, W::BN, T, D, lane);
      fill_panels<W::NP>(tile + W::STREAM, src1, base, row, t0, W::BN, T, D,
                         lane);
      sm90::fence_proxy_async();
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&sm.full[s]);
    }
    store(s, v);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.full[s]);
    if (i + 1 < n) load(t0 + W::BN, v);
  }
}

// 2^x by the special-function unit in one instruction (exp2f adds a
// range check and a rescale around it): relative error ~2^-22, under the
// bf16 rounding that p and dS get before the second products; -inf -> 0
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A consumer warpgroup's A operand of its first products: its 64 rows of
// an own tile (at `rows`), per k step over the head dim.
// HELD: read once into registers by ldmatrix (through the swizzle) and
// multiplied from there; else read from shared memory by every product.
template <int DMAX, bool HELD>
struct OwnA {
  using W = Wg<DMAX>;
  uint32_t base;
  uint32_t r[HELD ? W::KS : 1][4];

  __device__ __forceinline__ OwnA(const unsigned char* rows, int warp,
                                  int lane)
      : base(sm90::smem_u32(rows)) {
    if constexpr (HELD) {
      const int row = 16 * warp + (lane & 15);
#pragma unroll
      for (int ks = 0; ks < W::KS; ++ks) {
        const int chunk = 2 * (ks % 4) + (lane >> 4);
        ldsm_x4(r[ks], reinterpret_cast<const uint16_t*>(
                           rows + (ks / 4) * W::BM * 128 + row * 128 +
                           ((chunk ^ (row & 7)) << 4)));
      }
    }
  }
  // x (+)= A[:, 16 ks ..] B, B K-major at descriptor db
  __device__ __forceinline__ void mma(float (&x)[32], int ks,
                                      uint64_t db) const {
    if constexpr (HELD)
      sm90::wgmma_rs<0>(x, r[ks], db, ks > 0);
    else
      sm90::wgmma_ss<0>(
          x,
          sm90::desc128(base + (ks / 4) * W::BM * 128 + (ks % 4) * 32, 16,
                        1024),
          db, ks > 0);
  }
};

// The two first products of a consumer warpgroup over one streamed
// stage, issued and committed as one group: x = A0 B0^T and y = A1 B1^T,
// A the warpgroup's 64 own rows, B the stage's two tiles (at b0, b1),
// contracted over the head dim, K-major.
template <int DMAX, typename A>
__device__ __forceinline__ void first_products(float (&x)[32],
                                               float (&y)[32], const A& a0,
                                               const A& a1, uint32_t b0,
                                               uint32_t b1) {
  using W = Wg<DMAX>;
  sm90::wgmma_fence();
  sm90::fence_acc(x);
  sm90::fence_acc(y);
#pragma unroll
  for (int ks = 0; ks < W::KS; ++ks) {
    const uint32_t pb = (ks / 4) * W::BN * 128 + (ks % 4) * 32;
    a0.mma(x, ks, sm90::desc128(b0 + pb, 16, 1024));
    a1.mma(y, ks, sm90::desc128(b1 + pb, 16, 1024));
  }
  sm90::wgmma_commit();
}

// Accumulator columns 16kk .. 16kk + 15 rounded to bf16 pairs: the A
// operand of k step kk of a second product
template <int N>
__device__ __forceinline__ void acc_to_a16(const float (&x)[N], int kk,
                                           uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// d[p] += A B[p] for each 64-column panel p of a streamed tile at bt,
// contracted over its BN rows (MN-major through the transpose bit), A
// from registers (a[kk] for rows 16kk ..)
template <typename W>
__device__ __forceinline__ void second_product(
    float (&d)[W::NP][32], const uint32_t (&a)[W::BN / 16][4], uint32_t bt) {
#pragma unroll
  for (int kk = 0; kk < W::BN / 16; ++kk)
#pragma unroll
    for (int p = 0; p < W::NP; ++p)
      sm90::wgmma_rs<1>(
          d[p], a[kk],
          sm90::desc128(bt + p * W::BN * 128 + kk * 2048, 1024, 1024));
}

// A warpgroup's 64 rows of an output [B, T, H, D] in bf16: rows r0 + 16w
// + g + 8rr, columns 64p + 8j + 2t (+ 1), times mul[rr]; pairs stored as
// one 4-byte word when `pair` (D even, output 4-byte aligned)
template <int NP>
__device__ __forceinline__ void store_rows(uint16_t* out,
                                           const float (&x)[NP][32],
                                           const float (&mul)[2], size_t base,
                                           size_t row, int r0, int T, int D,
                                           bool pair, int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = r0 + 16 * warp + g + 8 * rr;
    if (t >= T) continue;
    uint16_t* o = out + base + (size_t)t * row;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = 64 * p + 8 * j + 2 * t4;
        const float v0 = x[p][4 * j + 2 * rr] * mul[rr];
        const float v1 = x[p][4 * j + 2 * rr + 1] * mul[rr];
        if (pair && d + 1 < D) {
          *reinterpret_cast<uint32_t*>(o + d) = pack_bf16(v0, v1);
        } else {
          if (d < D) o[d] = f32_to_bf16(v0);
          if (d + 1 < D) o[d + 1] = f32_to_bf16(v1);
        }
      }
  }
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// A consumer warp is done with a stage: its products that read it have
// completed
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(empty);
}

// One key tile of the forward's online softmax for this thread's two
// rows (mrow and mrow + 8 of its warpgroup), in place: s (N raw scores:
// columns 8j + 2t + (x & 1) of row x >> 1 & 1, x = 4j + e) becomes p in
// f32; m (running max of the raw scores), l (this thread's share of the
// sum) and corr (the factor for the O accumulator) are updated. MASKED:
// each key's predicate (ok) and, on a diagonal tile, the causal compare
// (key column <= doff + row); a masked score is -1e30 and its p 0.
template <bool MASKED, int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const float* ok, bool diag,
                                             int doff, int mrow, int t4,
                                             float c) {
  if constexpr (MASKED) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float2 o2 = *reinterpret_cast<const float2*>(ok + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * j + e, col = 8 * j + 2 * t4 + (e & 1);
        const bool keep = ((e & 1) ? o2.y : o2.x) > 0.f &&
                          (!diag || col <= doff + mrow + 8 * (e >> 1));
        s[x] = keep ? s[x] : kNegInf;
      }
    }
  }
  // two partial maxima and sums a row, for shorter dependency chains
  float mx[2][2] = {{m[0], m[0]}, {m[1], m[1]}};
#pragma unroll
  for (int x = 0; x < N; ++x)
    mx[(x >> 1) & 1][(x >> 2) & 1] =
        fmaxf(mx[(x >> 1) & 1][(x >> 2) & 1], s[x]);
  float nb[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(mx[r][0], mx[r][1]);
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    corr[r] = exp2_fast((m[r] - v) * c);
    m[r] = v;
    nb[r] = -v * c;
  }
  float ls[2][2] = {{l[0] * corr[0], 0.f}, {l[1] * corr[1], 0.f}};
#pragma unroll
  for (int x = 0; x < N; ++x) {
    const int r = (x >> 1) & 1;
    float p = exp2_fast(fmaf(s[x], c, nb[r]));
    if constexpr (MASKED) p = s[x] > kNegInf ? p : 0.f;
    ls[r][(x >> 2) & 1] += p;  // the f32 p: only the product sees it rounded
    s[x] = p;
  }
  l[0] = ls[0][0] + ls[0][1];
  l[1] = ls[1][0] + ls[1][1];
}

// The bf16 forward's key tile: 128 keys, so that S = Q K^T is one
// m64n128k16 product a k step (64 measured slower, see the notes above)
constexpr int kFwdKeys = 128;

// O = softmax(Q K^T * scale + mask) V and the LSE, bf16 operands. Grid:
// (B*H, 128-row query blocks), the last block first. Warpgroups 0 and 1
// own query rows q0 .. q0 + 63 and q0 + 64 .. q0 + 127 (Q, loaded once
// and read from shared memory by every product); warp 8 streams K and V
// in tiles of 128 keys with each key's predicate (key mask and T) and the
// tile's all-live flag through the ring.
template <int DMAX>
__global__ void __launch_bounds__(Wg<DMAX, 1, kFwdKeys>::kThreads, 1)
flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const float* __restrict__ key_mask,
                      uint16_t* __restrict__ o, float* __restrict__ lse,
                      int H, int T, int D, int causal, float scale, int tma,
                      int pair) {
  using W = Wg<DMAX, 1, kFwdKeys>;
  constexpr int BN = W::BN;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem<W> sm(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * W::BM;
  const int n_kt = (T + BN - 1) / BN;
  const int n = causal ? min(n_kt, (q0 + W::BM - 1) / BN + 1) : n_kt;
  if (tid == 0) sm.init();
  __syncthreads();

  if (tid >= 256) {
    sm90::setmaxnreg_dec<56>();
    if (tid < 288) {
      const int lane = tid - 256;
      wg_produce<W>(
          sm, {&map_q}, &map_k, &map_v, {q}, k, v, b, h, base, row, q0, 0, n,
          T, D, tma != 0, lane,
          [&](int t0, float (&x)[4]) {  // each key's mask value, 0 past T
#pragma unroll
            for (int j = 0; j < BN / 32; ++j) {
              const int t = t0 + lane + 32 * j;
              x[j] = t >= T ? 0.f
                     : key_mask == nullptr ? 1.f
                                           : key_mask[(size_t)b * T + t];
            }
          },
          [&](int s, const float (&x)[4]) {  // predicates, all-live flag
            float* ok = sm.vec + s * 2 * BN;
            bool all = true;
#pragma unroll
            for (int j = 0; j < BN / 32; ++j) {
              ok[lane + 32 * j] = x[j] > 0.f ? 1.f : 0.f;
              all = all && x[j] > 0.f;
            }
            all = __all_sync(0xffffffffu, all);
            if (lane == 0) ok[BN] = all ? 1.f : 0.f;
          });
    }
  } else {
    sm90::setmaxnreg_inc<224>();
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int t4 = lane % 4;
    const int r0 = q0 + 64 * wg;           // the warpgroup's first query
    const int mrow = 16 * warp + lane / 4;  // this thread's rows: mrow, + 8
    const float c = scale * kLog2e;
    // key tiles this warpgroup computes: causal, up to its diagonal
    const int nw = r0 >= T ? 0 : causal ? min(n, (r0 + 63) / BN + 1) : n;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[W::NP][32];
#pragma unroll
    for (int p = 0; p < W::NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    sm90::mbar_wait(sm.own_bar, 0);
    const uint32_t qs = sm90::smem_u32(sm.own + wg * 64 * 128);
    uint32_t a[BN / 16][4];  // P in bf16, the A of O += P V
    float corr[2];           // the rows' correction of O and l

    auto full = [&](int i) {
      sm90::mbar_wait(&sm.full[i % W::STAGES], (i / W::STAGES) & 1);
    };
    // S = Q K^T of tile i into x, K K-major (issued and committed)
    auto scores = [&](float (&x)[BN / 2], int i) {
      const uint32_t kt = sm90::smem_u32(sm.stage(i % W::STAGES));
      sm90::wgmma_fence();
      sm90::fence_acc(x);
#pragma unroll
      for (int ks = 0; ks < W::KS; ++ks) {
        const uint32_t k32 = (ks % 4) * 32;  // 16 columns of a panel
        const uint64_t da =
            sm90::desc128(qs + (ks / 4) * W::BM * 128 + k32, 16, 1024);
        const uint64_t db =
            sm90::desc128(kt + (ks / 4) * BN * 128 + k32, 16, 1024);
        sm90::wgmma_ss_n128<0>(x, da, db, ks > 0);
      }
      sm90::wgmma_commit();
    };
    // p in place of S; off the diagonal, a tile whose keys are all live
    // takes no select
    auto softmax = [&](float (&x)[BN / 2], int i) {
      sm90::fence_acc(x);
      const float* ok = sm.vec + (i % W::STAGES) * 2 * BN;
      const int k0 = i * BN;
      const bool diag = causal && k0 + BN - 1 > r0;
      if (!diag && ok[BN] > 0.f)
        softmax_tile<false>(x, m, l, corr, ok, false, 0, mrow, t4, c);
      else
        softmax_tile<true>(x, m, l, corr, ok, diag, r0 - k0, mrow, t4, c);
    };
    // O corrected, and P rounded to bf16 as the A of P V
    auto rescale_pack = [&](const float (&x)[BN / 2]) {
#pragma unroll
      for (int p = 0; p < W::NP; ++p)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[p][j] *= corr[(j >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a16(x, kk, a[kk]);
    };
    // O += P V of tile i, V read MN-major (issued and committed)
    auto pv = [&](int i) {
      sm90::wgmma_fence();
#pragma unroll
      for (int p = 0; p < W::NP; ++p) sm90::fence_acc(acc[p]);
      second_product<W>(
          acc, a, sm90::smem_u32(sm.stage(i % W::STAGES)) + W::STREAM);
      sm90::wgmma_commit();
    };
    auto pv_done = [&] {
#pragma unroll
      for (int p = 0; p < W::NP; ++p) sm90::fence_acc(acc[p]);
      sm90::fence_frag(a);
    };
    auto done = [&](int i) { release(&sm.empty[i % W::STAGES], lane); };

    float s[BN / 2];  // S of a tile, then P in f32
    for (int i = 0; i < nw; ++i) {
      full(i);
      scores(s, i);
      sm90::wgmma_wait<0>();
      softmax(s, i);
      rescale_pack(s);
      pv(i);
      sm90::wgmma_wait<0>();
      pv_done();
      done(i);
    }
    for (int i = nw; i < n; ++i) {  // stages wholly above its rows
      full(i);
      done(i);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    store_rows<W::NP>(o, acc, {1.f / l[0], 1.f / l[1]}, base, row, r0, T, D,
                      pair != 0, warp, lane);
    // a row with no live key keeps m = -1e30 and gets LSE -1e30 exactly
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + mrow + 8 * r;
      if (t4 == 0 && t < T)
        lse[(size_t)bh * T + t] =
            m[r] > kNegInf ? m[r] * scale + logf(l[r]) : kNegInf;
    }
  }
}

// dQ = sum over key tiles of dS K * scale, bf16 operands. Grid: (B*H,
// 128-row query blocks), the last block first. Warpgroups 0 and 1 own
// query rows q0 .. q0 + 63 and q0 + 64 .. q0 + 127 (Q and dO, loaded
// once); warp 8 streams K and V with each key's column predicate (key
// mask and T) through the ring.
template <int DMAX>
__global__ void __launch_bounds__(Wg<DMAX>::kThreads, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const float* __restrict__ key_mask,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int H, int T, int D,
                         int causal, float scale, int tma, int pair) {
  using W = Wg<DMAX>;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem<W> sm(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * W::BM;
  const int n_kt = (T + W::BN - 1) / W::BN;
  const int n = causal ? min(n_kt, (q0 + W::BM - 1) / W::BN + 1) : n_kt;
  if (tid == 0) sm.init();
  __syncthreads();

  if (tid >= 256) {
    sm90::setmaxnreg_dec<56>();
    if (tid < 288) {
      const int lane = tid - 256;
      wg_produce<W>(
          sm, {&map_q, &map_do}, &map_k, &map_v, {q, dout}, k, v, b, h, base,
          row, q0, 0, n, T, D, tma != 0, lane,
          [&](int t0, float (&x)[4]) {  // each key's predicate
            for (int j = 0; j < 2; ++j) {
              const int t = t0 + lane + 32 * j;
              x[j] = t < T && (key_mask == nullptr ||
                               key_mask[(size_t)b * T + t] > 0.f)
                         ? 1.f
                         : 0.f;
            }
          },
          [&](int s, const float (&x)[4]) {
            float* ok = sm.vec + s * 2 * W::BN;
            ok[lane] = x[0];
            ok[lane + 32] = x[1];
          });
    }
  } else {
    sm90::setmaxnreg_inc<224>();
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * wg;        // the warpgroup's first query
    const int mrow = 16 * warp + g;     // this thread's rows: mrow, + 8
    const float sl2 = scale * kLog2e;
    float rl[2], rd[2];  // LSE (log2 units; +inf past T) and delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + mrow + 8 * r;
      rl[r] = t < T ? lse[(size_t)bh * T + t] * kLog2e : pos_inf();
      rd[r] = t < T ? delta[(size_t)bh * T + t] : 0.f;
    }
    float acc[W::NP][32];
#pragma unroll
    for (int p = 0; p < W::NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    sm90::mbar_wait(sm.own_bar, 0);
    const unsigned char* aq = sm.own + wg * 64 * 128;
    const OwnA<DMAX, DMAX <= 64> qa(aq, warp, lane),
        oa(aq + W::OWN, warp, lane);
    for (int i = 0; i < n; ++i) {
      const int st = i % W::STAGES;
      sm90::mbar_wait(&sm.full[st], (i / W::STAGES) & 1);
      const int k0 = i * W::BN;
      if (r0 < T && (!causal || k0 <= r0)) {
        const bool diag = causal && k0 == r0;
        const uint32_t kt = sm90::smem_u32(sm.stage(st)), vt = kt + W::STREAM;
        float s[32], dp[32];  // Q K^T, dO V^T (the first step overwrites)
        first_products<DMAX>(s, dp, qa, oa, kt, vt);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(s);
        sm90::fence_acc(dp);
        // dS = P o (dP - delta) in place of S; p where-guarded by the
        // key's predicate and, on the diagonal tile, the causal compare
        const float* ok = sm.vec + st * 2 * W::BN;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 o2 = *reinterpret_cast<const float2*>(ok + 8 * j +
                                                             2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e, r = e >> 1;
            const int c = 8 * j + 2 * t4 + (e & 1);
            const bool keep = ((e & 1) ? o2.y : o2.x) > 0.f &&
                              (!diag || c <= mrow + 8 * r);
            const float p = keep ? exp2_fast(fmaf(s[x], sl2, -rl[r])) : 0.f;
            s[x] = p * (dp[x] - rd[r]);
          }
        }
        uint32_t a[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a16(s, kk, a[kk]);
        // dQ += dS K: dS rounded to bf16 as A, K read MN-major
        sm90::wgmma_fence();
#pragma unroll
        for (int p = 0; p < W::NP; ++p) sm90::fence_acc(acc[p]);
        second_product<W>(acc, a, kt);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < W::NP; ++p) sm90::fence_acc(acc[p]);
      }
      release(&sm.empty[st], lane);
    }
    store_rows<W::NP>(dq, acc, {scale, scale}, base, row, r0, T, D,
                      pair != 0, warp, lane);
  }
}

// dV = sum over query tiles of P^T dO; dK = sum of dS^T Q * scale, bf16
// operands. Grid: (B*H, 128-row key blocks), the first block first.
// Warpgroups 0 and 1 own keys k0 .. k0 + 63 and k0 + 64 .. k0 + 127 (K
// and V, loaded once); warp 8 streams Q and dO with their LSE (log2
// units, +inf past T) and delta from the diagonal down. Scores are
// computed transposed (rows = keys), so P^T and dS^T are accumulators
// ready to be A operands.
template <int DMAX>
__global__ void __launch_bounds__(Wg<DMAX>::kThreads, 1)
flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const uint16_t* __restrict__ q,
                          const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v,
                          const float* __restrict__ key_mask,
                          const uint16_t* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int H, int T, int D, int causal, float scale,
                          int tma, int pair) {
  using W = Wg<DMAX>;
  extern __shared__ unsigned char smem_raw[];
  const WgSmem<W> sm(smem_raw);
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int k0 = blockIdx.y * W::BM;
  const int first = causal ? k0 / W::BN : 0;
  const int n = (T + W::BN - 1) / W::BN - first;
  if (tid == 0) sm.init();
  __syncthreads();

  if (tid >= 256) {
    sm90::setmaxnreg_dec<56>();
    if (tid < 288) {
      const int lane = tid - 256;
      wg_produce<W>(
          sm, {&map_k, &map_v}, &map_q, &map_do, {k, v}, q, dout, b, h, base,
          row, k0, first, n, T, D, tma != 0, lane,
          [&](int t0, float (&x)[4]) {  // LSE (log2 units) and delta
            for (int j = 0; j < 2; ++j) {
              const int t = t0 + lane + 32 * j;
              x[j] = t < T ? lse[(size_t)bh * T + t] * kLog2e : pos_inf();
              x[2 + j] = t < T ? delta[(size_t)bh * T + t] : 0.f;
            }
          },
          [&](int s, const float (&x)[4]) {
            float* lv = sm.vec + s * 2 * W::BN;
            lv[lane] = x[0];
            lv[lane + 32] = x[1];
            lv[W::BN + lane] = x[2];
            lv[W::BN + lane + 32] = x[3];
          });
    }
  } else {
    sm90::setmaxnreg_inc<224>();
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = k0 + 64 * wg;     // the warpgroup's first key
    const int mrow = 16 * warp + g;  // this thread's keys: mrow, + 8
    const float sl2 = scale * kLog2e;
    bool kok[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + mrow + 8 * r;
      kok[r] = t < T &&
               (key_mask == nullptr || key_mask[(size_t)b * T + t] > 0.f);
    }
    float dka[W::NP][32], dva[W::NP][32];
#pragma unroll
    for (int p = 0; p < W::NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) dka[p][i] = dva[p][i] = 0.f;
    sm90::mbar_wait(sm.own_bar, 0);
    const unsigned char* ak = sm.own + wg * 64 * 128;
    const OwnA<DMAX, DMAX <= 64> ka(ak, warp, lane),
        va(ak + W::OWN, warp, lane);
    for (int i = 0; i < n; ++i) {
      const int st = i % W::STAGES;
      sm90::mbar_wait(&sm.full[st], (i / W::STAGES) & 1);
      const int t0 = (first + i) * W::BN;
      if (r0 < T && (!causal || t0 >= r0)) {
        const bool diag = causal && t0 == r0;
        const uint32_t qt = sm90::smem_u32(sm.stage(st)), ot = qt + W::STREAM;
        float s[32], dp[32];  // K Q^T, V dO^T (the first step overwrites)
        first_products<DMAX>(s, dp, ka, va, qt, ot);
        sm90::wgmma_wait<0>();
        sm90::fence_acc(s);
        sm90::fence_acc(dp);
        // P^T in place of S^T, where-guarded by the key's predicate and,
        // on the diagonal tile, the causal compare
        const float* lv = sm.vec + st * 2 * W::BN;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(lv + 8 * j +
                                                             2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e, r = e >> 1;
            const int c = 8 * j + 2 * t4 + (e & 1);
            const bool keep = kok[r] && (!diag || mrow + 8 * r <= c);
            s[x] = keep ? exp2_fast(fmaf(s[x], sl2, -((e & 1) ? l2.y : l2.x)))
                        : 0.f;
          }
        }
        uint32_t ap[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a16(s, kk, ap[kk]);
        // dS^T = P^T o (dP^T - delta) in place of dP^T
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 d2 = *reinterpret_cast<const float2*>(
              lv + W::BN + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * j + e;
            dp[x] = s[x] * (dp[x] - ((e & 1) ? d2.y : d2.x));
          }
        }
        uint32_t as[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a16(dp, kk, as[kk]);
        // dV += P^T dO, dK += dS^T Q: P^T and dS^T rounded to bf16 as A,
        // dO and Q read MN-major
        sm90::wgmma_fence();
#pragma unroll
        for (int p = 0; p < W::NP; ++p) {
          sm90::fence_acc(dva[p]);
          sm90::fence_acc(dka[p]);
        }
        second_product<W>(dva, ap, ot);
        second_product<W>(dka, as, qt);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < W::NP; ++p) {
          sm90::fence_acc(dva[p]);
          sm90::fence_acc(dka[p]);
        }
      }
      release(&sm.empty[st], lane);
    }
    store_rows<W::NP>(dk, dka, {scale, scale}, base, row, r0, T, D,
                      pair != 0, warp, lane);
    store_rows<W::NP>(dv, dva, {1.f, 1.f}, base, row, r0, T, D, pair != 0,
                      warp, lane);
  }
}

// Raise a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <int DMAX, int KG>
int launch_fwd(const void* q, const void* k, const void* v, const void* km,
               void* o, void* lse, int B, int T, int H, int D, int causal,
               float scale, void* stream) {
  using Tile = FwdTile<DMAX, KG>;
  cudaError_t e = allow_smem(flash_fwd_kernel<DMAX, KG>, Tile::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  dim3 grid(B * H, (T + kBwdRows - 1) / kBwdRows);
  flash_fwd_kernel<DMAX, KG><<<grid, Tile::kThreads, Tile::kSmemBytes,
                               (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (float*)o, (float*)lse, H, T, D, causal, scale, vec4);
  return (int)cudaGetLastError();
}

// out[0..4]: registers a thread, local (spill) bytes, dynamic shared
// bytes, resident blocks per SM and threads a block of the forward
// kernel at DMAX with KG key groups
template <int DMAX, int KG>
int fwd_info(int* out) {
  using Tile = FwdTile<DMAX, KG>;
  cudaFuncAttributes attr;
  cudaError_t e = allow_smem(flash_fwd_kernel<DMAX, KG>, Tile::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&attr, flash_fwd_kernel<DMAX, KG>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], flash_fwd_kernel<DMAX, KG>, Tile::kThreads,
        Tile::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)Tile::kSmemBytes;
  out[4] = Tile::kThreads;
  return 0;
}

template <int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* km,
              const void* dout, const void* lse, const void* delta,
              void* dq, int B, int T, int H, int D, int causal, float scale,
              void* stream) {
  const size_t smem = BwdTile<DMAX, false>::kSmemBytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<DMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout);
  dim3 grid(B * H, (T + kBwdRows - 1) / kBwdRows);
  flash_bwd_dq_kernel<DMAX><<<grid, kBwdThreads, smem,
                              (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (float*)dq, H, T, D, causal, scale, vec4);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* km,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int B, int T, int H, int D, int causal,
               float scale, void* stream) {
  const size_t smem = BwdTile<DMAX, true>::kSmemBytes;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<DMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  const int vec4 = D % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dout);
  dim3 grid(B * H, (T + kBwdRows - 1) / kBwdRows);
  flash_bwd_dkv_kernel<DMAX><<<grid, kBwdThreads, smem,
                               (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (float*)dk, (float*)dv, H, T, D, causal, scale, vec4);
  return (int)cudaGetLastError();
}

// out[0..3]: dQ's dynamic shared bytes and resident blocks per SM, then
// dK/dV's two
template <int DMAX>
int bwd_info(int* out) {
  const size_t dq_smem = BwdTile<DMAX, false>::kSmemBytes;
  const size_t dkv_smem = BwdTile<DMAX, true>::kSmemBytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<DMAX>, dq_smem);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkv_kernel<DMAX>, dkv_smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], flash_bwd_dq_kernel<DMAX>, kBwdThreads, dq_smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[3], flash_bwd_dkv_kernel<DMAX>, kBwdThreads, dkv_smem);
  out[0] = (int)dq_smem;
  out[2] = (int)dkv_smem;
  return (int)e;
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

// The bf16 legs' tensor maps: TMA when D % 8 == 0 and every tile tensor
// (q, k, v, and dO for the backward) is 16-byte aligned (its strides must
// be multiples of 16 bytes): the maps are encoded here, at every launch,
// and passed by value; else the producer warp fills the same swizzled
// tiles itself and the maps are unused.
template <int N>
bool bf16_maps(CUtensorMap (&maps)[N], const void* const (&src)[N], int B,
               int T, int H, int D, int rows, cudaError_t& e) {
  bool tma = D % 8 == 0;
  for (int i = 0; i < N; ++i) tma = tma && aligned16(src[i]);
  e = cudaSuccess;
  for (int i = 0; tma && i < N && e == cudaSuccess; ++i)
    e = sm90::bf16_bthd_map(&maps[i], src[i], B, T, H, D, rows);
  return tma;
}


template <int DMAX>
int launch_fwd_bf16(const void* q, const void* k, const void* v,
                    const void* km, void* o, void* lse, int B, int T, int H,
                    int D, int causal, float scale, void* stream) {
  using W = Wg<DMAX, 1, kFwdKeys>;
  const auto kernel = flash_fwd_bf16_kernel<DMAX>;
  cudaError_t e = allow_smem(kernel, W::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[3] = {};
  const int tma = bf16_maps<3>(maps, {q, k, v}, B, T, H, D, W::BN, e);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (T + W::BM - 1) / W::BM);
  kernel<<<grid, W::kThreads, W::kSmemBytes, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], (const uint16_t*)q, (const uint16_t*)k,
      (const uint16_t*)v, (const float*)km, (uint16_t*)o, (float*)lse, H, T,
      D, causal, scale, tma, D % 2 == 0 && aligned4(o));
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dq_bf16(const void* q, const void* k, const void* v,
                   const void* km, const void* dout, const void* lse,
                   const void* delta, void* dq, int B, int T, int H, int D,
                   int causal, float scale, void* stream) {
  using W = Wg<DMAX>;
  cudaError_t e = allow_smem(flash_bwd_dq_bf16_kernel<DMAX>, W::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[4] = {};
  const int tma = bf16_maps<4>(maps, {q, k, v, dout}, B, T, H, D, W::BN, e);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (T + W::BM - 1) / W::BM);
  flash_bwd_dq_bf16_kernel<DMAX><<<grid, W::kThreads, W::kSmemBytes,
                                   (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const uint16_t*)q,
      (const uint16_t*)k, (const uint16_t*)v, (const float*)km,
      (const uint16_t*)dout, (const float*)lse, (const float*)delta,
      (uint16_t*)dq, H, T, D, causal, scale, tma,
      D % 2 == 0 && aligned4(dq));
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dkv_bf16(const void* q, const void* k, const void* v,
                    const void* km, const void* dout, const void* lse,
                    const void* delta, void* dk, void* dv, int B, int T,
                    int H, int D, int causal, float scale, void* stream) {
  using W = Wg<DMAX>;
  cudaError_t e = allow_smem(flash_bwd_dkv_bf16_kernel<DMAX>, W::kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap maps[4] = {};
  const int tma = bf16_maps<4>(maps, {q, k, v, dout}, B, T, H, D, W::BN, e);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (T + W::BM - 1) / W::BM);
  flash_bwd_dkv_bf16_kernel<DMAX><<<grid, W::kThreads, W::kSmemBytes,
                                    (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const uint16_t*)q,
      (const uint16_t*)k, (const uint16_t*)v, (const float*)km,
      (const uint16_t*)dout, (const float*)lse, (const float*)delta,
      (uint16_t*)dk, (uint16_t*)dv, H, T, D, causal, scale, tma,
      D % 2 == 0 && aligned4(dk) && aligned4(dv));
  return (int)cudaGetLastError();
}

// out[0..4]: registers a thread, local (spill) bytes, dynamic shared
// bytes, resident blocks per SM and threads of a kernel launched with
// blocks of `threads`
template <typename Kernel>
int kernel_info(Kernel kernel, size_t smem, int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[4] = threads;
  return 0;
}

template <int DMAX>
int bf16_info(int which, int* out) {
  using W = Wg<DMAX>;
  if (which == 0)
    return kernel_info(flash_fwd_bf16_kernel<DMAX>,
                       Wg<DMAX, 1, kFwdKeys>::kSmemBytes,
                       Wg<DMAX, 1, kFwdKeys>::kThreads, out);
  if (which == 1)
    return kernel_info(flash_bwd_dq_bf16_kernel<DMAX>, W::kSmemBytes,
                       W::kThreads, out);
  return kernel_info(flash_bwd_dkv_bf16_kernel<DMAX>, W::kSmemBytes,
                     W::kThreads, out);
}

}  // namespace

#define DISPATCH_HEAD_DIM(D, CALL)                         \
  do {                                                     \
    if ((D) <= 32) return CALL(32);                        \
    if ((D) <= 64) return CALL(64);                        \
    if ((D) <= 128) return CALL(128);                      \
    return (int)cudaErrorInvalidValue;                     \
  } while (0)

// The forward with key_groups (KG, 1 or 2) groups of 4 warps a block
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, const void* key_mask,
                                       void* o, void* lse, int B, int T,
                                       int H, int D, int causal, float scale,
                                       int key_groups, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1 || key_groups < 1 || key_groups > 2)
    return (int)cudaErrorInvalidValue;
#define FWD(DM)                                                          \
  (key_groups == 1 ? launch_fwd<DM, 1>(q, k, v, key_mask, o, lse, B, T, H, \
                                       D, causal, scale, stream)         \
                   : launch_fwd<DM, 2>(q, k, v, key_mask, o, lse, B, T, H, \
                                       D, causal, scale, stream))
  DISPATCH_HEAD_DIM(D, FWD);
#undef FWD
}

extern "C" int flash_attention_bwd_dq_f32(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int T, int H, int D, int causal, float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
#define DQ(DM) launch_dq<DM>(q, k, v, key_mask, dout, lse, delta, dq, B, T, \
                             H, D, causal, scale, stream)
  DISPATCH_HEAD_DIM(D, DQ);
#undef DQ
}

extern "C" int flash_attention_bwd_dkv_f32(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* lse, const void* delta, void* dk,
    void* dv, int B, int T, int H, int D, int causal, float scale,
    void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
#define DKV(DM) launch_dkv<DM>(q, k, v, key_mask, dout, lse, delta, dk, dv, \
                               B, T, H, D, causal, scale, stream)
  DISPATCH_HEAD_DIM(D, DKV);
#undef DKV
}

// Registers, spills, shared memory and resident blocks per SM of the
// forward kernel at head dim D with KG key groups (see fwd_info).
extern "C" int flash_attention_fwd_info(int D, int key_groups, int* out) {
  if (D < 1 || key_groups < 1 || key_groups > 2)
    return (int)cudaErrorInvalidValue;
#define INFO(DM) (key_groups == 1 ? fwd_info<DM, 1>(out) : fwd_info<DM, 2>(out))
  DISPATCH_HEAD_DIM(D, INFO);
#undef INFO
}

// Shared memory and resident blocks per SM of the backward kernels at
// head dim D (see bwd_info).
extern "C" int flash_attention_bwd_info(int D, int* out) {
  if (D < 1) return (int)cudaErrorInvalidValue;
#define INFO(DM) bwd_info<DM>(out)
  DISPATCH_HEAD_DIM(D, INFO);
#undef INFO
}

// The bf16 legs: the same arguments as the f32 entry points (the
// forward has one key group), q, k, v, dO, O, dQ, dK and dV bf16
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, const void* key_mask,
                                        void* o, void* lse, int B, int T,
                                        int H, int D, int causal, float scale,
                                        void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
#define FWD(DM) launch_fwd_bf16<DM>(q, k, v, key_mask, o, lse, B, T, H, D, \
                                    causal, scale, stream)
  DISPATCH_HEAD_DIM(D, FWD);
#undef FWD
}

extern "C" int flash_attention_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* lse, const void* delta, void* dq, int B,
    int T, int H, int D, int causal, float scale, void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
#define DQ(DM) launch_dq_bf16<DM>(q, k, v, key_mask, dout, lse, delta, dq, B, \
                                  T, H, D, causal, scale, stream)
  DISPATCH_HEAD_DIM(D, DQ);
#undef DQ
}

extern "C" int flash_attention_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* key_mask,
    const void* dout, const void* lse, const void* delta, void* dk,
    void* dv, int B, int T, int H, int D, int causal, float scale,
    void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
#define DKV(DM) launch_dkv_bf16<DM>(q, k, v, key_mask, dout, lse, delta, dk, \
                                    dv, B, T, H, D, causal, scale, stream)
  DISPATCH_HEAD_DIM(D, DKV);
#undef DKV
}

// Registers, spills, shared memory, resident blocks per SM and threads
// of a bf16 leg (which: 0 forward, 1 dQ, 2 dK/dV) at head dim D.
extern "C" int flash_attention_bf16_info(int which, int D, int* out) {
  if (D < 1 || which < 0 || which > 2) return (int)cudaErrorInvalidValue;
#define INFO(DM) bf16_info<DM>(which, out)
  DISPATCH_HEAD_DIM(D, INFO);
#undef INFO
}
