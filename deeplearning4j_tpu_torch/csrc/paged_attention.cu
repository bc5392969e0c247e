// Decode attention over the paged KV pool: one query row per
// (sequence, head) attends over that sequence's cached K/V prefix, which
// lives in pool blocks addressed by the sequence's block-table row.
//
// paged_attention_f32/_bf16 replace
// deeplearning4j_tpu/kernels/paged_attention.py::_paged_kernel (the
// Pallas kernel behind paged_attention_pallas); paged_attention_int8
// replaces ::_paged_kernel_quant (behind _paged_pallas_quant), see the
// end of this file and int8_attention.cuh.
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

// int8 pools: k_pool, v_pool [N, H, Bs, D] int8 with scale rows ks, vs
// [N, H, Bs] f32; the numeric contract and the lane layout are in
// int8_attention.cuh. The block layout is the f32 kernel's above: one
// block per (sequence, head), the live table entries staged in shared
// memory, warps splitting the live pool blocks. Each live block's value
// panel and its scale row are read through the same table entry, with
// no gather pass; the null block and stale tails are never read.
namespace {

template <int G>
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
  using Lane = int8_attention::Lane<G>;
  extern __shared__ int s_tbl[];  // this sequence's live table entries
  __shared__ int sm_bad;
  const int sh = blockIdx.x;  // sequence * H + head
  const int s = sh / H;
  const int h = sh - s * H;
  const int warp = threadIdx.x / 32;
  int len = lengths[s];
  const int cap = B * Bs;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int nblk = (len + Bs - 1) / Bs;
  if (threadIdx.x == 0) sm_bad = 0;
  for (int i = threadIdx.x; i < nblk; i += int8_attention::kThreads)
    s_tbl[i] = tables[(size_t)s * B + i];
  __syncthreads();

  Lane ln(q + (size_t)sh * D, D);
  for (int bi = warp; bi < nblk; bi += int8_attention::kWarps) {
    const int blk = s_tbl[bi];
    if (blk < 0 || blk >= N) {
      sm_bad = 1;
      continue;
    }
    const size_t row0 = ((size_t)blk * H + h) * Bs;
    const int nkeys = min(Bs, len - bi * Bs);  // live keys in this block
    for (int t0 = 0; t0 < nkeys; t0 += Lane::kTile) {
      const int n = min(Lane::kTile, nkeys - t0);
      ln.tile(k_pool + (row0 + t0) * D, v_pool + (row0 + t0) * D,
              ks_pool + row0 + t0, vs_pool + row0 + t0, n, D, scale);
    }
  }
  ln.merge_store(out + (size_t)sh * D, D, &sm_bad);
}

}  // namespace

extern "C" int paged_attention_int8(const void* q, const void* k_pool,
                                    const void* v_pool, const void* ks_pool,
                                    const void* vs_pool, const void* tables,
                                    const void* lengths, void* out, int S,
                                    int H, int N, int Bs, int D, int B,
                                    float scale, void* stream) {
  decltype(&paged_attention_int8_kernel<1>) kernel;
  switch (int8_attention::group_width(D)) {
    case 1: kernel = paged_attention_int8_kernel<1>; break;
    case 2: kernel = paged_attention_int8_kernel<2>; break;
    case 4: kernel = paged_attention_int8_kernel<4>; break;
    case 8: kernel = paged_attention_int8_kernel<8>; break;
    case 16: kernel = paged_attention_int8_kernel<16>; break;
    case 32: kernel = paged_attention_int8_kernel<32>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (B < 1 || B > kMaxTable || Bs < 1 || N < 1 || S * H == 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)B * sizeof(int);
  kernel<<<S * H, int8_attention::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)k_pool, (const int8_t*)v_pool,
      (const float*)ks_pool, (const float*)vs_pool, (const int*)tables,
      (const int*)lengths, (float*)out, H, N, Bs, D, B, scale);
  return (int)cudaGetLastError();
}
