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
// ~130 flops or more per byte it must move, so the f32 rate bounds it,
// not memory. The TPU kernels compute in f32, so these use FP32 FMA and
// no TF32 tensor cores (TF32 would move logits by ~1e-3 and break greedy
// parity with the reference). Design, shared by the three kernels:
//  - One block of 256 threads per (64-row tile, batch*head): a query
//    tile for the forward and dQ, a key tile for dK/dV (K outer, as in
//    _bwd_dkv_kernel). The block's own tiles stay in shared memory, the
//    other side streams through it one 64-row tile at a time.
//  - Register tiling, as in an SGEMM: thread (ty, tx) of a 16 x 16 grid
//    computes a 4 x 4 block of scores (its rows 4ty..4ty+3 against the
//    streamed rows tx + 16j, tile_dot) and a 4 x D/16 block of each
//    accumulator (tile_pv), reading 16-byte vectors from shared memory,
//    so each vector load feeds four FMAs. Row strides are padded to an
//    odd number of 16-byte units, so neighbouring threads' vectors fall
//    in different banks.
//  - Probabilities (and dS) go through shared memory between the two
//    products of a step; forward row maxima and sums are reduced across
//    the 16 threads of a row with shuffles.
//  - Tiles above the diagonal are skipped under the causal mask, and
//    tiles past T are never visited.
//  - Masking as in the TPU kernels: masked scores are -1e30 and p is
//    forced to 0 where masked. A fully masked row's LSE is -1e30, so
//    exp(s - lse) would be 1 there: the backward where-guards p rather
//    than relying on the exponential to underflow, which makes that
//    row's gradients exactly 0.
//  - dK/dV: every gradient row has one owner block that sums over all
//    query tiles in a fixed order. No atomics, so results are
//    deterministic.
// Not yet: wgmma/TMA, double-buffered tile loads, split tiles for the
// causal imbalance.
#include <cuda_runtime.h>

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

// The same rows of two tensors (K and V, or Q and dO) in one pass: one
// index computation feeds both loads.
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

// a [B, H, T] row statistic (lse, delta) for rows t0 .. t0+63, 0 past T
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int bh, int t0, int T, int tid) {
  if (tid < kBM) {
    const int t = t0 + tid;
    dst[tid] = t < T ? src[(size_t)bh * T + t] : 0.f;
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

// dQ = sum over key tiles of dS K * scale, dS = P o (dO V^T - delta).
// Grid: (query tiles, B*H); the query tile, its dO, LSE and delta stay.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ key_mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int T, int D, int causal, float scale) {
  constexpr int LD = DMAX + 4;
  constexpr int COLS = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                // [kBM][LD]
  float* dOs = Qs + kBM * LD;      // [kBM][LD]
  float* Ks = dOs + kBM * LD;      // [kBN][LD]
  float* Vs = Ks + kBN * LD;       // [kBN][LD]
  float* dSs = Vs + kBN * LD;      // [kBM][kLDP]
  float* colok = dSs + kBM * kLDP;  // [kBN]
  float* rlse = colok + kBN;       // [kBM]
  float* rdelta = rlse + kBM;      // [kBM]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int q0 = blockIdx.x * kBM;

  load_tile_pair<DMAX>(Qs, q, dOs, dout, base, row, q0, T, D, tid);
  load_rows(rlse, lse, bh, q0, T, tid);
  load_rows(rdelta, delta, bh, q0, T, tid);

  float acc[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[i][c] = 0.f;

  const int n_tiles = (T + kBN - 1) / kBN;
  int last = n_tiles - 1;
  if (causal) {
    const int diag = (q0 + kBM - 1) / kBN;
    last = diag < last ? diag : last;
  }
  for (int kt = 0; kt <= last; ++kt) {
    __syncthreads();  // the previous tiles and dS are consumed
    load_tile_pair<DMAX>(Ks, k, Vs, v, base, row, kt * kBN, T, D, tid);
    load_key_ok(colok, key_mask, b, kt * kBN, T, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DMAX>(Qs, Ks, ty, tx, s);    // Q K^T
    tile_dot<DMAX>(dOs, Vs, ty, tx, dp);  // dO V^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      const int q_pos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = colok[c] > 0.f && (!causal || kt * kBN + c <= q_pos);
        const float p = ok ? expf(s[i][j] * scale - rlse[r]) : 0.f;
        dSs[r * kLDP + c] = p * (dp[i][j] - rdelta[r]);
      }
    }
    __syncthreads();
    tile_pv<DMAX>(dSs, Ks, ty, tx, acc);  // dQ += dS K
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_pos = q0 + 4 * ty + i;
    if (q_pos >= T) continue;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = tx * COLS + c;
      if (d < D) dq[base + q_pos * row + d] = acc[i][c] * scale;
    }
  }
}

// dV = sum over query tiles of P^T dO; dK = sum of dS^T Q * scale.
// Grid: (key tiles, B*H); the key tile's K and V stay, Q and dO stream
// from the diagonal down under the causal mask. Scores are computed
// transposed (rows = keys), so P^T and dS^T land in shared memory in
// the layout tile_pv reads.
template <int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ key_mask,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int T, int D, int causal, float scale) {
  constexpr int LD = DMAX + 4;
  constexpr int COLS = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                // [kBN][LD]
  float* Vs = Ks + kBN * LD;       // [kBN][LD]
  float* Qs = Vs + kBN * LD;       // [kBM][LD]
  float* dOs = Qs + kBM * LD;      // [kBM][LD]
  float* Pt = dOs + kBM * LD;      // [kBN][kLDP] P^T
  float* dSt = Pt + kBN * kLDP;    // [kBN][kLDP] dS^T
  float* keyok = dSt + kBN * kLDP;  // [kBN]
  float* clse = keyok + kBN;       // [kBM]
  float* cdelta = clse + kBM;      // [kBM]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const size_t row = (size_t)H * D;
  const size_t base = (size_t)b * T * row + (size_t)h * D;
  const int k0 = blockIdx.x * kBN;

  load_tile_pair<DMAX>(Ks, k, Vs, v, base, row, k0, T, D, tid);
  load_key_ok(keyok, key_mask, b, k0, T, tid);

  float dka[4][COLS], dva[4][COLS];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < COLS; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_tiles = (T + kBM - 1) / kBM;
  // query tiles wholly above this key tile see none of its keys (kBM ==
  // kBN, so the diagonal query tile has this tile's index)
  const int first = causal ? k0 / kBM : 0;
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kBM;
    __syncthreads();  // the previous tiles, P^T and dS^T are consumed
    load_tile_pair<DMAX>(Qs, q, dOs, dout, base, row, q0, T, D, tid);
    load_rows(clse, lse, bh, q0, T, tid);
    load_rows(cdelta, delta, bh, q0, T, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<DMAX>(Ks, Qs, ty, tx, s);    // (Q K^T)^T
    tile_dot<DMAX>(Vs, dOs, ty, tx, dp);  // (dO V^T)^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;  // key row in the tile
      const bool kok = keyok[r] > 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;  // query row in the tile
        const int q_pos = q0 + c;
        const bool ok = kok && q_pos < T && (!causal || k0 + r <= q_pos);
        const float p = ok ? expf(s[i][j] * scale - clse[c]) : 0.f;
        Pt[r * kLDP + c] = p;
        dSt[r * kLDP + c] = p * (dp[i][j] - cdelta[c]);
      }
    }
    __syncthreads();
    tile_pv<DMAX>(Pt, dOs, ty, tx, dva);  // dV += P^T dO
    tile_pv<DMAX>(dSt, Qs, ty, tx, dka);  // dK += dS^T Q
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k_pos = k0 + 4 * ty + i;
    if (k_pos >= T) continue;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int d = tx * COLS + c;
      if (d < D) {
        dk[base + k_pos * row + d] = dka[i][c] * scale;
        dv[base + k_pos * row + d] = dva[i][c];
      }
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

template <int DMAX>
int launch_dq(const void* q, const void* k, const void* v, const void* km,
              const void* dout, const void* lse, const void* delta,
              void* dq, int B, int T, int H, int D, int causal, float scale,
              void* stream) {
  const size_t smem = (size_t)(4 * kBM * (DMAX + 4) + kBM * kLDP + kBN
                               + 2 * kBM) * sizeof(float);
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<DMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBM - 1) / kBM, B * H);
  flash_bwd_dq_kernel<DMAX><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (float*)dq, H, T, D, causal, scale);
  return (int)cudaGetLastError();
}

template <int DMAX>
int launch_dkv(const void* q, const void* k, const void* v, const void* km,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int B, int T, int H, int D, int causal,
               float scale, void* stream) {
  const size_t smem = (size_t)(4 * kBN * (DMAX + 4) + 2 * kBN * kLDP + kBN
                               + 2 * kBM) * sizeof(float);
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<DMAX>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBN - 1) / kBN, B * H);
  flash_bwd_dkv_kernel<DMAX><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)km,
      (const float*)dout, (const float*)lse, (const float*)delta,
      (float*)dk, (float*)dv, H, T, D, causal, scale);
  return (int)cudaGetLastError();
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
