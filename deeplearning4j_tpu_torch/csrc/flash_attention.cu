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
// The forward (B3) computes in FP32 FMA on the CUDA cores (67 TFLOP/s):
// its output is the served path's logits, and TF32 would move them by
// ~1e-3 and break greedy parity with the reference. The backward (dQ,
// dK/dV) runs its products on the tensor cores in 3xTF32: each f32
// operand x splits into hi = rna_tf32(x) and lo = rna_tf32(x - hi), and
// a product is lo*hi + hi*lo + hi*hi (small terms first, f32
// accumulation), which drops only lo*lo (~2^-22 of the product). That
// keeps gradients at f32 accuracy (the tests and chip_smoke.py hold
// them within 1e-4 of the plain version, times the largest gradient
// where it exceeds 1; one TF32 pass errs by ~1e-3) at the cost of three
// TF32 products per f32 product, so the backward's bound is
// 3 x its flops at 495 TFLOP/s: at B=4, H=8, T=1024, D=64, causal,
// dQ 6.45 GFLOP -> 0.0391 ms and dK/dV 8.60 GFLOP -> 0.0521 ms (0.0962
// and 0.1283 ms at the f32 rate).
//
// Forward design (B3):
//  - One block of 256 threads per (64-row query tile, batch*head); the
//    query tile stays in shared memory, K and V stream through it one
//    64-row tile at a time.
//  - Register tiling, as in an SGEMM: thread (ty, tx) of a 16 x 16 grid
//    computes a 4 x 4 block of scores (its rows 4ty..4ty+3 against the
//    streamed rows tx + 16j, tile_dot) and a 4 x D/16 block of the
//    accumulator (tile_pv), reading 16-byte vectors from shared memory,
//    so each vector load feeds four FMAs. Row strides are padded to an
//    odd number of 16-byte units, so neighbouring threads' vectors fall
//    in different banks.
//  - Probabilities go through shared memory between the two products of
//    a step; row maxima and sums are reduced across the 16 threads of a
//    row with shuffles.
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
// Not yet: wgmma/TMA, warp-specialised producers, split tiles for the
// causal imbalance.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 64;        // rows of a block's own tile
constexpr int kBN = 64;        // rows of a streamed tile
constexpr int kThreads = 256;  // a 16 x 16 thread grid
constexpr int kLDP = kBN + 4;  // row stride of P / dS tiles
constexpr float kNegInf = -1e30f;

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      out[c] = x.x; out[c + 1] = x.y; out[c + 2] = x.z; out[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + c);
      out[c] = x.x; out[c + 1] = x.y;
    }
  }
}

// Rows t0 .. t0+63 of one (batch, head) of a [B, T, H, D] tensor into a
// [64][DMAX + 4] shared tile, zero past T and past D.
template <int DMAX>
__device__ __forceinline__ void load_tile(float* dst,
                                          const float* __restrict__ src,
                                          size_t base, size_t row, int t0,
                                          int T, int D, int tid) {
  constexpr int LD = DMAX + 4;
  for (int idx = tid; idx < 64 * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx % DMAX;
    const int t = t0 + r;
    dst[r * LD + d] = (t < T && d < D) ? src[base + t * row + d] : 0.f;
  }
}

// The same rows of two tensors (K and V) in one pass: one index
// computation feeds both loads.
template <int DMAX>
__device__ __forceinline__ void load_tile_pair(
    float* dst_a, const float* __restrict__ src_a, float* dst_b,
    const float* __restrict__ src_b, size_t base, size_t row, int t0, int T,
    int D, int tid) {
  constexpr int LD = DMAX + 4;
  for (int idx = tid; idx < 64 * DMAX; idx += kThreads) {
    const int r = idx / DMAX, d = idx % DMAX;
    const int t = t0 + r;
    const bool ok = t < T && d < D;
    dst_a[r * LD + d] = ok ? src_a[base + t * row + d] : 0.f;
    dst_b[r * LD + d] = ok ? src_b[base + t * row + d] : 0.f;
  }
}

// s[i][j] = A[4ty + i] . Bt[tx + 16j]: rows of two [64][DMAX + 4] tiles
template <int DMAX>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bt,
                                         int ty, int tx, float (&s)[4][4]) {
  constexpr int LD = DMAX + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DMAX; d += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float a = s[i][j];
        a = fmaf(av[i].x, bv[j].x, a);
        a = fmaf(av[i].y, bv[j].y, a);
        a = fmaf(av[i].z, bv[j].z, a);
        a = fmaf(av[i].w, bv[j].w, a);
        s[i][j] = a;
      }
  }
}

// acc[i][c] += sum_kk P[4ty + i][kk] * M[kk][tx * DMAX/16 + c], with P a
// [64][kLDP] tile and M a [64][DMAX + 4] tile
template <int DMAX>
__device__ __forceinline__ void tile_pv(const float* P, const float* M,
                                        int ty, int tx,
                                        float (&acc)[4][DMAX / 16]) {
  constexpr int LD = DMAX + 4;
  constexpr int COLS = DMAX / 16;
#pragma unroll 2
  for (int kk = 0; kk < kBN; kk += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kLDP + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float mr[COLS];
      load_vec<COLS>(M + (kk + u) * LD + tx * COLS, mr);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y
                      : u == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[i][c] = fmaf(p, mr[c], acc[i][c]);
      }
    }
  }
}

// 1 where key t0 + j lies inside T and is not masked, per streamed key
__device__ __forceinline__ void load_key_ok(float* ok,
                                            const float* __restrict__ km,
                                            int b, int t0, int T, int tid) {
  if (tid < kBN) {
    const int t = t0 + tid;
    ok[tid] = (t < T && (km == nullptr || km[(size_t)b * T + t] > 0.f))
                  ? 1.f : 0.f;
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ key_mask,
                 float* __restrict__ o, float* __restrict__ lse,
                 int H, int T, int D, int causal, float scale) {
  constexpr int LD = DMAX + 4;     // row stride of Q, K, V tiles
  constexpr int COLS = DMAX / 16;  // output elements per thread and row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [kBM][LD]
  float* Ks = Qs + kBM * LD;       // [kBN][LD]
  float* Vs = Ks + kBN * LD;       // [kBN][LD]
  float* Ps = Vs + kBN * LD;       // [kBM][kLDP]
  float* colok = Ps + kBM * kLDP;  // [kBN] 1 = key inside T and unmasked

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;  // stride between positions
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int q0 = blockIdx.x * kBM;

  load_tile<DMAX>(Qs, q, base, row, q0, T, D, tid);

  float m[4], l[4], acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (T + kBN - 1) / kBN;
  int last = n_tiles - 1;
  if (causal) {
    const int diag = (q0 + kBM - 1) / kBN;
    last = diag < last ? diag : last;
  }
  for (int kt = 0; kt <= last; ++kt) {
    __syncthreads();  // the previous tile and P are consumed
    load_tile_pair<DMAX>(Ks, k, Vs, v, base, row, kt * kBN, T, D, tid);
    load_key_ok(colok, key_mask, b, kt * kBN, T, tid);
    __syncthreads();

    float s[4][4];  // S = Q K^T: rows 4ty + i, keys tx + 16j
    tile_dot<DMAX>(Qs, Ks, ty, tx, s);

    // online softmax per row; the 16 threads of a row share a half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + 4 * ty + i;
      unsigned valid = 0u;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = colok[c] > 0.f && (!causal || kt * kBN + c <= q_pos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        valid |= ok ? (1u << j) : 0u;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = (valid >> j) & 1u ? expf(s[i][j] - mx) : 0.f;
        psum += p;
        Ps[(4 * ty + i) * kLDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * corr + psum;
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    tile_pv<DMAX>(Ps, Vs, ty, tx, acc);  // O += P V
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + 4 * ty + i;
    if (q_pos >= T) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = tx * COLS + c;
      if (d < D) o[base + q_pos * row + d] = acc[i][c] / lc;
    }
    if (tx == 0) lse[(size_t)bh * T + q_pos] = m[i] + logf(lc);
  }
}

// ---- backward: 3xTF32 mma.sync, scores in registers, cp.async ring ----

constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;  // a block's own tile
constexpr float kLog2e = 1.4426950408889634f;

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
__device__ __forceinline__ void frag_a_acc(const float (&c)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split_tf32(c[0], hi[0], lo[0]);
  split_tf32(c[2], hi[1], lo[1]);
  split_tf32(c[1], hi[2], lo[2]);
  split_tf32(c[3], hi[3], lo[3]);
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

// Rows t0 .. t0+ROWS-1 of one (batch, head) of two [B, T, H, D] tensors
// into [ROWS][DMAX + 4] shared tiles, zero past T and past D. vec4: D % 4
// == 0 and both tensors 16-byte aligned, so 16-byte copies.
template <int DMAX, int ROWS>
__device__ __forceinline__ void async_tile_pair(
    float* dst_a, const float* __restrict__ src_a, float* dst_b,
    const float* __restrict__ src_b, size_t base, size_t row, int t0, int T,
    int D, bool vec4, int tid) {
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
      cp_async16(dst_a + r * LD + d, src_a + off, ok);
      cp_async16(dst_b + r * LD + d, src_b + off, ok);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * DMAX / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int r = idx / DMAX, d = idx % DMAX, t = t0 + r;
      const bool ok = t < T && d < D;
      const size_t off = ok ? base + (size_t)t * row + d : 0;
      cp_async4(dst_a + r * LD + d, src_a + off, ok);
      cp_async4(dst_b + r * LD + d, src_b + off, ok);
    }
  }
}

__device__ __forceinline__ void split_in_place(float* hi, float* lo) {
  uint32_t h, l;
  split_tf32(*hi, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// The same for a 16-byte chunk: one vector load and two vector stores
// (scalar accesses to a thread's own chunk would conflict 4 ways)
__device__ __forceinline__ void split_in_place4(float* hi, float* lo) {
  float4 x = *reinterpret_cast<const float4*>(hi);
  float* v = &x.x;
  float4 h, l;
  float* hv = &h.x;
  float* lv = &l.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t a, b;
    split_tf32(v[e], a, b);
    hv[e] = __uint_as_float(a);
    lv[e] = __uint_as_float(b);
  }
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = l;
}

// After async_tile_pair's copies have landed: each thread splits the
// elements it copied itself (visible to it after its own wait, so no
// barrier is needed) into hi, in place, and lo. Every warp then reads
// ready TF32 pairs instead of splitting each element on each use.
template <int DMAX, int ROWS>
__device__ __forceinline__ void split_tile_pair(float* a_hi, float* a_lo,
                                                float* b_hi, float* b_lo,
                                                bool vec4, int tid) {
  constexpr int LD = DMAX + 4;
  if (vec4) {
    constexpr int CH = DMAX / 4;
#pragma unroll
    for (int i = 0; i < ROWS * CH / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int o = (idx / CH) * LD + (idx % CH) * 4;
      split_in_place4(a_hi + o, a_lo + o);
      split_in_place4(b_hi + o, b_lo + o);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < ROWS * DMAX / kBwdThreads; ++i) {
      const int idx = tid + i * kBwdThreads;
      const int o = (idx / DMAX) * LD + idx % DMAX;
      split_in_place(a_hi + o, a_lo + o);
      split_in_place(b_hi + o, b_lo + o);
    }
  }
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

// Raise a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int DMAX>
int launch_fwd(const void* q, const void* k, const void* v, const void* km,
               void* o, void* lse, int B, int T, int H, int D, int causal,
               float scale, void* stream) {
  const size_t smem =
      (size_t)(3 * kBN * (DMAX + 4) + kBM * kLDP + kBN) * sizeof(float);
  cudaError_t e = allow_smem(flash_fwd_kernel<DMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBM - 1) / kBM, B * H);
  flash_fwd_kernel<DMAX><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (float*)o, (float*)lse, H, T, D, causal, scale);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

}  // namespace

#define DISPATCH_HEAD_DIM(D, CALL)                         \
  do {                                                     \
    if ((D) <= 32) return CALL(32);                        \
    if ((D) <= 64) return CALL(64);                        \
    if ((D) <= 128) return CALL(128);                      \
    return (int)cudaErrorInvalidValue;                     \
  } while (0)

extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, const void* key_mask,
                                       void* o, void* lse, int B, int T,
                                       int H, int D, int causal, float scale,
                                       void* stream) {
  if (B < 1 || T < 1 || H < 1 || D < 1) return (int)cudaErrorInvalidValue;
#define FWD(DM) launch_fwd<DM>(q, k, v, key_mask, o, lse, B, T, H, D, \
                               causal, scale, stream)
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

// Shared memory and resident blocks per SM of the backward kernels at
// head dim D (see bwd_info).
extern "C" int flash_attention_bwd_info(int D, int* out) {
  if (D < 1) return (int)cudaErrorInvalidValue;
#define INFO(DM) bwd_info<DM>(out)
  DISPATCH_HEAD_DIM(D, INFO);
#undef INFO
}
