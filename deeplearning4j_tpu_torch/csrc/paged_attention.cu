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
// Numeric contract: int8_attention.cuh's (the Pallas kernel's): q rounded
// to bf16, int8 -> f32 exact, s = dot(q, k) * (1/sqrt(D)) * kscale as an
// f32 sum of exact products, p = exp(s - m), pv = bf16(p * vscale), f32
// accumulation. Where pv is rounded depends on the running max m, so the
// kernel keeps the int8 decode kernel's (B4's) folds exactly: with G =
// int8_attention::group_width(D), warp w folds the live pool blocks w,
// w + 8, ... in tiles of kTile = 8 * 32 / G rows, and within a tile
// stream g of the warp (g < 32 / G) takes rows g, g + 32 / G, ... and
// updates its max once per tile. At Bs = 16 and D = 64 a tile is a pool
// block and the folds are B4's on the gathered panel, which is why the
// two agree to f32 rounding.
//
// What bounds it: bytes (2 D int8 + 8 scale bytes per live key, ~2 flops
// a byte). One block per (sequence, head), its live table entries staged
// in shared memory, warps splitting the live pool blocks; the null block
// and stale tails are never read, scales included. The lane layout is
// built for the bytes, not for B4's lane groups:
//  - VEC-byte loads (16 when D % 16 == 0 and the pools are 16-byte
//    aligned, else 8, else 4): a row is L = D / VEC lanes (rounded up to
//    a power of two), a warp load covers R = 32 / L rows (8 rows of 64
//    bytes at D = 64), and a lane loads NL = 32 / VEC rows of K and of V
//    per tile (2 at VEC = 16). R is a multiple of the stream count, so
//    all of a lane's rows belong to one stream: scores are computed in
//    this layout and each stream's max and rounding are taken over its
//    own rows, as B4 takes them.
//  - int8 -> f32 without I2F (a quarter-rate conversion): each 32-bit
//    word is XORed with 0x80808080 (int8 b -> byte b + 128), PRMT puts a
//    byte into the low byte of 0x4B000000 (the f32 2^23 + b + 128), and
//    one FADD of -(2^23 + 128) leaves b, exactly, for all 256 values. The
//    grid is 2-D and the live-block test is bi * Bs < len, so no integer
//    division (whose reciprocal is an I2F.RP) is left either.
//  - A row's dot reduces over its L lanes (2 shuffles at D = 64, against
//    4 per 2 rows in B4's layout); the stream max over the lanes that
//    share a stream (2 more).
//  - Loads in flight: a warp's next tile (across pool blocks) is loaded
//    into a second register buffer before the current one is folded.
//    At ~95 registers two blocks of 256 threads fit on an SM. A
//    three-stage cp.async ring per warp in shared memory instead (no
//    tile in registers, 64 registers, four blocks per SM, phase 3's 512
//    blocks in one wave) measured slower on the H100: its copy loops and
//    the capped registers cost more than the wave it saves.
//  - Each lane keeps its rows' partial (l, acc) under its stream's max;
//    at the end the partials of a stream are summed by shuffles and every
//    stream of every warp is merged once through shared memory.
//  - A live table entry outside [0, N) gives a NaN row; length 0 gives
//    exactly 0 (max starts at -1e30, l is clamped at 1e-30).
namespace {

template <int G, int VEC>
struct Int8Layout {
  static constexpr int kStreams = 32 / G;  // B4's streams per warp
  static constexpr int kTile = kStreams * int8_attention::kUnroll;
  static constexpr int L = G * 4 / VEC;    // lanes per row
  static constexpr int R = 32 / L;         // rows per warp load
  static constexpr int NL = kTile / R;     // rows per lane per tile
  static constexpr int W = VEC / 4;        // 32-bit words per lane load
  static_assert(L >= 1 && R % kStreams == 0 && NL * R == kTile, "layout");
};

// A lane's share of one tile: NL rows of K and V, VEC bytes each, and
// their scales.
template <int NL, int W>
struct Int8Buf {
  uint32_t k[NL][W], v[NL][W];
  float ks[NL], vs[NL];
};

template <int W>
__device__ __forceinline__ void load_words(const int8_t* __restrict__ p,
                                           uint32_t (&w)[W]) {
  if constexpr (W == 4) {
    const int4 x = __ldg(reinterpret_cast<const int4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (W == 2) {
    const int2 x = __ldg(reinterpret_cast<const int2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const int*>(p));
  }
}

// The four int8 of a word as exact floats, with no I2F: x ^ 0x80808080
// holds b + 128 in each byte; 0x4B0000xx is the f32 2^23 + xx.
__device__ __forceinline__ void int8x4_to_f32(uint32_t x, float (&f)[4]) {
  const uint32_t u = x ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | e)) -
           8388736.f;  // 2^23 + 128
}

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
  using Lay = Int8Layout<G, VEC>;
  constexpr int L = Lay::L, R = Lay::R, NL = Lay::NL, W = Lay::W;
  constexpr int kTile = Lay::kTile;
  constexpr int kWarps = int8_attention::kWarps;
  constexpr int kStreamsAll = kWarps * Lay::kStreams;
  extern __shared__ int s_tbl[];  // this sequence's live table entries
  __shared__ int sm_bad;
  __shared__ float sm_m[kStreamsAll];
  __shared__ float sm_l[kStreamsAll];
  __shared__ float sm_acc[kWarps * 128];  // kStreamsAll * D <= kWarps * 128

  const int s = blockIdx.x, h = blockIdx.y;  // sequences in x: no cap
  const int sh = s * H + h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / L;          // the lane's row group: rows rg + R i
  const int d0 = VEC * (lane % L);  // its bytes of a row
  const bool dok = d0 < D;
  int len = lengths[s];
  const int cap = B * Bs;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  if (threadIdx.x == 0) sm_bad = 0;
  for (int i = threadIdx.x; i * Bs < len; i += int8_attention::kThreads)
    s_tbl[i] = tables[(size_t)s * B + i];
  __syncthreads();

  float qr[VEC], acc[VEC];
  {
    const float* qp = q + (size_t)sh * D + d0;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[e] = dok ? int8_attention::round_bf16(qp[e]) : 0.f;
      acc[e] = 0.f;
    }
  }
  float m = int8_attention::kNegInf, l = 0.f;

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
  auto load = [&](Int8Buf<NL, W>& b, int bi, int t0) {
    const size_t row0 = ((size_t)s_tbl[bi] * H + h) * Bs + t0;
    const int n = rows_of(bi, t0);
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = rg + R * i;
      const bool ok = t < n;
#pragma unroll
      for (int w = 0; w < W; ++w) b.k[i][w] = b.v[i][w] = 0u;
      if (ok && dok) {
        load_words<W>(k_pool + (row0 + t) * D + d0, b.k[i]);
        load_words<W>(v_pool + (row0 + t) * D + d0, b.v[i]);
      }
      b.ks[i] = ok ? __ldg(ks_pool + row0 + t) : 0.f;
      b.vs[i] = ok ? __ldg(vs_pool + row0 + t) : 0.f;
    }
  };
  // fold the tile's rows [0, n) into the lane's stream
  auto fold = [&](const Int8Buf<NL, W>& b, int n) {
    float sc[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      float part = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float f[4];
        int8x4_to_f32(b.k[i][w], f);
#pragma unroll
        for (int e = 0; e < 4; ++e) part = fmaf(qr[4 * w + e], f[e], part);
      }
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      sc[i] = part * scale * b.ks[i];
    }
    float mx = m;
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (rg + R * i < n) mx = fmaxf(mx, sc[i]);
#pragma unroll
    for (int o = L * Lay::kStreams; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float corr = expf(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] *= corr;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (rg + R * i < n) {
        const float p = expf(sc[i] - mx);
        l += p;
        const float pv = int8_attention::round_bf16(p * b.vs[i]);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float f[4];
          int8x4_to_f32(b.v[i][w], f);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[4 * w + e] = fmaf(pv, f[e], acc[4 * w + e]);
        }
      }
    }
    m = mx;
  };

  // the warp's tiles in order, the next one loading while this one folds
  Int8Buf<NL, W> cur, nxt;
  int bi = seek(warp), t0 = 0;
  if (bi * Bs < len) load(cur, bi, t0);
  while (bi * Bs < len) {
    int nb = bi, nt = t0 + kTile;
    if (nt >= min(Bs, len - bi * Bs)) {
      nb = seek(bi + kWarps);
      nt = 0;
    }
    if (nb * Bs < len) load(nxt, nb, nt);
    fold(cur, rows_of(bi, t0));
    cur = nxt;
    bi = nb;
    t0 = nt;
  }

  // a stream's partials: the lanes of one chunk across its row groups
#pragma unroll
  for (int o = L * Lay::kStreams; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (rg < Lay::kStreams) {
    const int stream = warp * Lay::kStreams + rg;
    if (d0 == 0) {
      sm_m[stream] = m;
      sm_l[stream] = l;
    }
    if (dok) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[stream * D + d0 + e] = acc[e];
    }
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D) {
    float mx = int8_attention::kNegInf;
    for (int w = 0; w < kStreamsAll; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kStreamsAll; ++w) {
      const float c = expf(sm_m[w] - mx);
      lsum += sm_l[w] * c;
      a += sm_acc[w * D + d] * c;
    }
    out[(size_t)sh * D + d] =
        sm_bad ? __int_as_float(0x7fc00000) : a / fmaxf(lsum, 1e-30f);
  }
}

using Int8Kernel = decltype(&paged_attention_int8_kernel<1, 4>);

// The kernel for lane-group width G and load width VEC (nullptr if none)
template <int VEC>
Int8Kernel int8_kernel_for(int G) {
  switch (G) {
    case 1: if constexpr (VEC == 4) return paged_attention_int8_kernel<1, 4>;
            return nullptr;
    case 2: if constexpr (VEC <= 8) return paged_attention_int8_kernel<2, VEC>;
            return nullptr;
    case 4: return paged_attention_int8_kernel<4, VEC>;
    case 8: return paged_attention_int8_kernel<8, VEC>;
    case 16: return paged_attention_int8_kernel<16, VEC>;
    case 32: return paged_attention_int8_kernel<32, VEC>;
    default: return nullptr;
  }
}

// The load width the head dim and the pools' alignment allow
int int8_vec(const void* k_pool, const void* v_pool, int D) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(k_pool) |
                      reinterpret_cast<uintptr_t>(v_pool);
  if (D % 16 == 0 && a % 16 == 0) return 16;
  if (D % 8 == 0 && a % 8 == 0) return 8;
  return 4;
}

Int8Kernel int8_kernel(const void* k_pool, const void* v_pool, int D) {
  const int G = int8_attention::group_width(D);
  switch (int8_vec(k_pool, v_pool, D)) {
    case 16: return int8_kernel_for<16>(G);
    case 8: return int8_kernel_for<8>(G);
    default: return int8_kernel_for<4>(G);
  }
}

}  // namespace

extern "C" int paged_attention_int8(const void* q, const void* k_pool,
                                    const void* v_pool, const void* ks_pool,
                                    const void* vs_pool, const void* tables,
                                    const void* lengths, void* out, int S,
                                    int H, int N, int Bs, int D, int B,
                                    float scale, void* stream) {
  const Int8Kernel kernel = int8_kernel(k_pool, v_pool, D);
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
  const Int8Kernel kernel = int8_kernel(aligned, aligned, D);
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
  out[3] = int8_vec(aligned, aligned, D);
  return 0;
}
