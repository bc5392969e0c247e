// Decode attention over the paged KV pool: one query row per
// (sequence, head) attends over that sequence's cached K/V prefix, which
// lives in pool blocks addressed by the sequence's block-table row.
//
// paged_attention_f32/_bf16 replace
// deeplearning4j_tpu/kernels/paged_attention.py::_paged_kernel (the
// Pallas kernel behind paged_attention_pallas); paged_attention_int8
// replaces ::_paged_kernel_quant (behind _paged_pallas_quant), see the
// end of this file.
//
// Layout: q [S, H, D] f32; k_pool, v_pool [N, H, Bs, D] f32 or bf16
// (positions contiguous per head inside a block); tables [S, B] int32
// pool indices, padded with the null block 0; lengths [S] int32;
// out [S, H, D] f32.
//
// What bounds it: bytes. Each live K/V element is read once and used for
// one multiply-add, about 0.5 flop per byte in f32, far below the card's
// ratio of f32 rate to memory rate (~20). So the kernel is a stream over
// the live K/V bytes, and its design is about reading those and no more:
//  - On the TPU the tables were scalar-prefetched so that each grid
//    step's DMA landed on pool[tbl[s, bi]], and the grid walked all B
//    table entries, masking key positions >= lengths[s]. Here one block
//    per (sequence, head), 8 warps. The block reads the sequence's length
//    once and stages only its LIVE table entries, ceil(len / Bs) of them,
//    in shared memory. The null padding past the length is never
//    dereferenced, so neither the null block (where inactive decode lanes
//    and padded prefill-chunk rows write junk) nor a recycled block's
//    stale tail can reach the sum.
//  - Warps split the live blocks: warp w takes blocks w, w + 8, ... Each
//    pool block is one contiguous Bs x D panel at ((tbl * H + h) * Bs) * D,
//    loaded directly, with no materialised gather. Lanes hold head-dim
//    elements lane, lane + 32, ... so a key row is one coalesced load per
//    warp; four rows are loaded before their dot products are reduced, to
//    keep loads in flight.
//  - Inside the last live block, keys at positions >= len are not loaded:
//    their p is 0 and their V adds nothing (the TPU kernel zeroed those V
//    rows, because 0 * NaN = NaN).
//  - Each warp keeps its own online softmax (m, l, acc) in registers; the
//    warps are merged once through shared memory at the end.
//  - f32 pools compute in f32 FMA. bf16 pools: q and p are rounded to
//    bf16 before their products and accumulation is f32, as the TPU
//    kernel's bf16 operands with f32 accumulation
//    (paged_attention.py:95-122).
//  - A sequence with length 0 gives exactly 0: l is clamped at 1e-30 as
//    in the TPU kernel, and the running max starts at -1e30, not -inf.
//  - A live table entry outside [0, N) is not dereferenced: that row's
//    output is NaN, which the engine's finite-logits guard reports.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "int8_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;       // key rows loaded per warp before reducing
constexpr int kMaxPerLane = 4;   // head dim <= 128
constexpr int kMaxTable = 8192;  // live table entries staged in shared memory
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const float* __restrict__ q,
                       const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths,
                       float* __restrict__ out,
                       int H, int N, int Bs, int D, int B, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ int s_tbl[];  // this sequence's live table entries
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * kMaxPerLane];
  __shared__ int sm_bad;

  const int sh = blockIdx.x;  // sequence * H + head
  const int s = sh / H;
  const int h = sh - s * H;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int len = lengths[s];
  const int cap = B * Bs;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int nblk = (len + Bs - 1) / Bs;
  if (threadIdx.x == 0) sm_bad = 0;
  for (int i = threadIdx.x; i < nblk; i += kThreads)
    s_tbl[i] = tables[(size_t)s * B + i];
  __syncthreads();

  const float* qp = q + (size_t)sh * D;
  float qr[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) {
    const int d = lane + 32 * i;
    const float x = d < D ? qp[d] : 0.f;
    qr[i] = kBf16 ? round_bf16(x) : x;
  }

  float m = kNegInf, l = 0.f;
  float acc[kMaxPerLane];
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) acc[i] = 0.f;

  for (int bi = warp; bi < nblk; bi += kWarps) {
    const int blk = s_tbl[bi];
    if (blk < 0 || blk >= N) {
      sm_bad = 1;
      continue;
    }
    const size_t base = ((size_t)blk * H + h) * Bs * D;
    const T* kp = k_pool + base;
    const T* vp = v_pool + base;
    const int nkeys = min(Bs, len - bi * Bs);  // live keys in this block
    for (int t0 = 0; t0 < nkeys; t0 += kUnroll) {
      float sc[kUnroll];
      float vr[kUnroll][kMaxPerLane];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const int t = t0 + j;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPerLane; ++i) {
          const int d = lane + 32 * i;
          const bool ok = t < nkeys && d < D;
          const float kx = ok ? to_float(kp[(size_t)t * D + d]) : 0.f;
          vr[j][i] = ok ? to_float(vp[(size_t)t * D + d]) : 0.f;
          part = fmaf(qr[i], kx, part);
        }
        sc[j] = part;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
      }
      float m_new = m;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        sc[j] *= scale;
        if (t0 + j < nkeys) m_new = fmaxf(m_new, sc[j]);
      }
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        if (t0 + j < nkeys) {
          const float p = expf(sc[j] - m_new);
          l += p;
          const float pv = kBf16 ? round_bf16(p) : p;
#pragma unroll
          for (int i = 0; i < kMaxPerLane; ++i)
            acc[i] = fmaf(pv, vr[j][i], acc[i]);
        }
      }
      m = m_new;
    }
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);
      lsum += sm_l[w] * c;
      a += sm_acc[w][d] * c;
    }
    out[(size_t)sh * D + d] =
        sm_bad ? __int_as_float(0x7fc00000) : a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* tables, const void* lengths, void* out, int S, int H,
           int N, int Bs, int D, int B, float scale, void* stream) {
  if (D < 1 || D > 32 * kMaxPerLane || B < 1 || B > kMaxTable || Bs < 1 ||
      N < 1 || S * H == 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)B * sizeof(int);
  paged_attention_kernel<T><<<S * H, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const T*)k_pool, (const T*)v_pool,
      (const int*)tables, (const int*)lengths, (float*)out, H, N, Bs, D, B,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k_pool,
                                   const void* v_pool, const void* tables,
                                   const void* lengths, void* out, int S,
                                   int H, int N, int Bs, int D, int B,
                                   float scale, void* stream) {
  return launch<float>(q, k_pool, v_pool, tables, lengths, out, S, H, N, Bs,
                       D, B, scale, stream);
}

extern "C" int paged_attention_bf16(const void* q, const void* k_pool,
                                    const void* v_pool, const void* tables,
                                    const void* lengths, void* out, int S,
                                    int H, int N, int Bs, int D, int B,
                                    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, tables, lengths, out, S, H,
                               N, Bs, D, B, scale, stream);
}

// int8 pools (B5): k_pool, v_pool [N, H, Bs, D] int8 with scale rows ks,
// vs [N, H, Bs] f32. Replaces paged_attention.py::_paged_kernel_quant.
//
// The numeric contract, the folds, the lane layout, the I2F-free
// conversion and the merge are int8_attention.cuh's, shared with the
// int8 decode kernel (B4): warp w folds the live pool blocks w, w + 8,
// ... in tiles of kTile = 8 * 32 / G rows. At Bs == kTile (Bs = 16 at
// D = 64) a tile is a pool block and the folds are B4's on the gathered
// panel, which is why the two agree to the bit there.
//
// What bounds it: bytes (2 D int8 + 8 scale bytes per live key, ~2 flops
// a byte). One block per (sequence, head) on a 2-D grid, its live table
// entries staged in shared memory, warps splitting the live pool blocks;
// the null block and stale tails are never read, scales included. A
// warp's next tile (across pool blocks) is loaded into the second
// register buffer before the current one is folded: at ~90 registers two
// blocks of 256 threads fit on an SM. A three-stage cp.async ring per
// warp in shared memory instead (no tile in registers, 64 registers,
// four blocks per SM, phase 3's 512 blocks in one wave) measured slower
// on the H100: its copy loops and the capped registers cost more than
// the wave it saves. The live-block test is bi * Bs < len, so no integer
// division (whose reciprocal is an I2F.RP) is left. A live table entry
// outside [0, N) gives a NaN row; length 0 gives exactly 0.
namespace {

template <int G, int VEC>
__global__ void __launch_bounds__(int8_attention::kThreads)
paged_attention_int8_kernel(const float* __restrict__ q,
                            const int8_t* __restrict__ k_pool,
                            const int8_t* __restrict__ v_pool,
                            const float* __restrict__ ks_pool,
                            const float* __restrict__ vs_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ lengths,
                            float* __restrict__ out, int H, int N, int Bs,
                            int D, int B, float scale) {
  using Lane = int8_attention::Int8Lane<G, VEC>;
  constexpr int kTile = Lane::kTile;
  constexpr int kWarps = int8_attention::kWarps;
  extern __shared__ int s_tbl[];  // this sequence's live table entries
  __shared__ int sm_bad;
  __shared__ typename Lane::Merge sm;

  const int s = blockIdx.x, h = blockIdx.y;  // sequences in x: no cap
  const int sh = s * H + h;
  const int warp = threadIdx.x / 32;
  int len = lengths[s];
  const int cap = B * Bs;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  if (threadIdx.x == 0) sm_bad = 0;
  for (int i = threadIdx.x; i * Bs < len; i += int8_attention::kThreads)
    s_tbl[i] = tables[(size_t)s * B + i];
  __syncthreads();

  Lane lane(q + (size_t)sh * D, D);

  // The warp's tiles in order: pool block bi (live while bi * Bs < len),
  // rows t0 .. of it. seek moves to the first live block at or after bi
  // whose table entry lies in [0, N); other entries flag the row NaN.
  auto seek = [&](int bi) {
    for (; bi * Bs < len; bi += kWarps) {
      const int blk = s_tbl[bi];
      if (blk >= 0 && blk < N) break;
      sm_bad = 1;
    }
    return bi;
  };
  auto rows_of = [&](int bi, int t0) {
    return min(kTile, min(Bs, len - bi * Bs) - t0);
  };
  auto load = [&](typename Lane::Buf& b, int bi, int t0) {
    const size_t row0 = ((size_t)s_tbl[bi] * H + h) * Bs + t0;
    lane.load(b, k_pool + row0 * D, v_pool + row0 * D, ks_pool + row0,
              vs_pool + row0, rows_of(bi, t0), D);
  };

  // the warp's tiles in order, the next one loading while this one folds
  typename Lane::Buf cur, nxt;
  int bi = seek(warp), t0 = 0;
  if (bi * Bs < len) load(cur, bi, t0);
  while (bi * Bs < len) {
    int nb = bi, nt = t0 + kTile;
    if (nt >= min(Bs, len - bi * Bs)) {
      nb = seek(bi + kWarps);
      nt = 0;
    }
    if (nb * Bs < len) load(nxt, nb, nt);
    lane.fold(cur, rows_of(bi, t0), scale);
    cur = nxt;
    bi = nb;
    t0 = nt;
  }

  lane.stash(sm, D);
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D)
    out[(size_t)sh * D + d] = sm_bad ? __int_as_float(0x7fc00000)
                                     : Lane::combine(sm, d, D);
}

struct PagedInt8 {
  using Fn = decltype(&paged_attention_int8_kernel<1, 4>);
  template <int G, int VEC>
  static Fn fn() { return paged_attention_int8_kernel<G, VEC>; }
};

}  // namespace

extern "C" int paged_attention_int8(const void* q, const void* k_pool,
                                    const void* v_pool, const void* ks_pool,
                                    const void* vs_pool, const void* tables,
                                    const void* lengths, void* out, int S,
                                    int H, int N, int Bs, int D, int B,
                                    float scale, void* stream) {
  const PagedInt8::Fn kernel =
      int8_attention::kernel_for<PagedInt8>(k_pool, v_pool, D);
  if (kernel == nullptr || B < 1 || B > kMaxTable || Bs < 1 || N < 1 ||
      S < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(S, H), int8_attention::kThreads, (size_t)B * sizeof(int),
           (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)k_pool, (const int8_t*)v_pool,
      (const float*)ks_pool, (const float*)vs_pool, (const int*)tables,
      (const int*)lengths, (float*)out, H, N, Bs, D, B, scale);
  return (int)cudaGetLastError();
}

// The int8 paged kernel taken at head dim D with 16-byte-aligned pools
// and a B-entry table: out = {registers, local (spill) bytes, blocks per
// SM, load width}.
extern "C" int paged_attention_int8_info(int D, int B, int* out) {
  const void* aligned = reinterpret_cast<const void*>(256);
  const PagedInt8::Fn kernel =
      int8_attention::kernel_for<PagedInt8>(aligned, aligned, D);
  if (kernel == nullptr || B < 1 || B > kMaxTable)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], kernel, int8_attention::kThreads, (size_t)B * sizeof(int));
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = int8_attention::load_width(aligned, aligned, D);
  return 0;
}
