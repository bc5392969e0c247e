// Decode attention over the slot KV cache: one query row per
// (slot, head) attends over that slot's cached K/V prefix.
//
// decode_attention_f32/_bf16 replace
// deeplearning4j_tpu/kernels/decode_attention.py::_decode_kernel (the
// Pallas kernel behind decode_attention_pallas); decode_attention_int8
// replaces ::_decode_kernel_quant (behind _decode_pallas_quant), see the
// end of this file and int8_attention.cuh.
//
// Layout: q [S, H, D] f32; k, v [S, H, T, D] f32 or bf16 (T contiguous
// per head); lengths [S] int32; out [S, H, D] f32.
//
// What bounds it: bytes. Each live K/V element is read once and used
// for one multiply-add, about 0.5 flop per byte in f32, far below the
// card's ratio of f32 rate to memory rate (~20). So the kernel is a
// stream over the live cache, and its design is about keeping enough
// of that stream in flight on every SM:
//  - Keys split across blocks. A (slot, head) is one cluster of
//    kCluster blocks (decode_attention_split_kernel, grid
//    (S * H, kCluster)); its keys are chunks of kChunk, and block r
//    takes chunks r, r + kCluster, ... (one chunk a block up to
//    T = kCluster * kChunk = 1024), stopping at the slot's length. A
//    block with no live chunk returns at once. Each block's partial
//    (m, l, acc[D]) goes into rank 0's shared memory (distributed
//    shared memory), and rank 0 merges them in rank order, which is
//    chunk order up to T = 1024. A partial depends only on q, the
//    block's rows and the length, so a slot's output bits are the same
//    whatever S, T and the other slots are. The merge needs no second
//    kernel (one measured slower, PERF.md section 6), no workspace and
//    no global state.
//  - Rows as vectors. A row of D elements is NV = ceil(D / E) vectors
//    of VEC bytes (E elements; 16 bytes where D and the caches'
//    alignment allow, else 8, else 4, else one bf16), spread over
//    L = min(32, the power of two >= NV) lanes, J vectors a lane. A warp
//    load covers R = 32 / L rows (8 rows at f32 D = 16, 2 at D = 64);
//    a row's dot reduces over its L lanes (log2 L shuffles).
//  - Tiles. A warp's tile is NL rows a lane (R NL rows, NL from a budget
//    of 8 registers of K a lane). Warp w folds tiles w, w + kWarps, ...
//    of each chunk through two register buffers in turn, the next
//    tile's loads in flight while the current one folds.
//  - One online softmax per warp: the running max is the warp's; each
//    lane sums l and acc over its own rows, and the row groups are
//    summed by shuffles at the end. The warps are merged in warp order
//    through shared memory into the block's partial.
//  - Rows at or past the length are never loaded: the TPU kernel
//    streamed the whole capacity and masked (and zeroed V, since
//    0 * NaN = NaN); here a recycled slot's non-finite tail cannot reach
//    the sum because it is never read.
//  - bf16 caches: q and p are rounded to bf16 before their products,
//    accumulation is f32, as the TPU kernel's bf16 operands with f32
//    accumulation (decode_attention.py:113-135). The output is f32.
//  - A slot with length 0 gives exactly 0: rank 0 merges no partial,
//    its running max starts at -1e30 and l is clamped at 1e-30, as in
//    the TPU kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "int8_attention.cuh"
#include "sm90.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 128;    // keys a chunk (CHUNK_KEYS in the wrapper)
constexpr int kCluster = 8;    // blocks a (slot, head), one cluster
constexpr int kMaxD = 256;
constexpr int kLaneRegs = 8;   // registers of K a lane holds per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T, int VEC, int L, int J>
struct Split {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int E = VEC / (int)sizeof(T);     // elements a vector
  static constexpr int NW = VEC >= 4 ? VEC / 4 : 1;  // registers a vector
  static constexpr int R = 32 / L;                   // rows a warp load
  static constexpr int NL0 = kLaneRegs / (J * NW);
  static constexpr int NL = NL0 < 1 ? 1 : (NL0 > L ? L : NL0);
  static constexpr int kTile = R * NL;               // rows a warp tile
  static_assert(E >= 1 && kChunk % (kWarps * kTile) == 0, "layout");
  // a lane's share of one tile: NL rows of K and V, J vectors each
  struct Buf {
    uint32_t k[NL][J][NW], v[NL][J][NW];
  };
};

template <int VEC>
__device__ __forceinline__ void load_vec(const void* p,
                                         uint32_t (&w)[VEC >= 4 ? VEC / 4
                                                                : 1]) {
  if constexpr (VEC == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (VEC == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = x.x; w[1] = x.y;
  } else if constexpr (VEC == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// Element e of a loaded vector as f32 (bf16 -> f32 is a shift, exact)
template <typename T, int NW>
__device__ __forceinline__ float elem(const uint32_t (&w)[NW], int e) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(w[e]);
  } else {
    return __uint_as_float(e % 2 ? w[e / 2] & 0xffff0000u : w[e / 2] << 16);
  }
}

// A block's shared memory. Rank 0 of each cluster also gathers the
// cluster's block partials (pm, pl, pacc: the other ranks store theirs
// into it) behind `bar`, which counts their threads' arrivals.
struct SplitShared {
  uint64_t bar;
  float m[kWarps], l[kWarps];
  float acc[kWarps][kMaxD];
  float pm[kCluster], pl[kCluster];
  float pacc[kCluster][kMaxD];
};

template <typename T, int VEC, int L, int J>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads)
decode_attention_split_kernel(const float* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const int* __restrict__ lengths,
                              float* __restrict__ out, int H, int T_cap,
                              int D, float scale) {
  using P = Split<T, VEC, L, J>;
  constexpr int E = P::E, R = P::R, NL = P::NL;
  constexpr int kStep = kWarps * P::kTile;
  __shared__ SplitShared sm;
  const int sh = blockIdx.x;    // slot * H + head
  const int rank = blockIdx.y;  // the block's rank in its cluster
  int len = lengths[sh / H];
  len = len < 0 ? 0 : (len > T_cap ? T_cap : len);
  const int chunks = (len + kChunk - 1) / kChunk;  // live chunks
  const int nb = min(kCluster, chunks);            // live blocks
  if (rank == 0 && threadIdx.x == 0) {
    sm90::mbar_init(&sm.bar, nb > 1 ? (nb - 1) * kThreads : 1);
    sm90::fence_mbar_init();
  }
  // every thread of the cluster arrives here, rank 0's after the
  // barrier's initialisation; the live ranks wait on it before they
  // store into rank 0
  __syncwarp();
  sm90::cluster_arrive();
  if (rank > 0 && rank >= nb) return;  // no live chunk; rank 0 writes out

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / L;  // the lane's rows of a tile: rg + R i

  // the lane's vectors of a row: lane % L + L j, live below NV
  const int nv = (D + E - 1) / E;
  int off[J];
  bool vok[J];
  float qr[J][E], acc[J][E];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int vi = lane % L + L * j;
    vok[j] = vi < nv;
    off[j] = vi * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float x = vok[j] ? q[(size_t)sh * D + off[j] + e] : 0.f;
      qr[j][e] = P::kBf16 ? round_bf16(x) : x;
      acc[j][e] = 0.f;
    }
  }
  float m = kNegInf, l = 0.f;

  // chunks rank, rank + kCluster, ... (one chunk a block up to
  // T = kCluster kChunk); n, kp, vp: the current chunk's live rows
  for (int ci = rank; ci < chunks; ci += kCluster) {
    const int n = min(kChunk, len - ci * kChunk);
    const size_t row0 = (size_t)sh * T_cap + (size_t)ci * kChunk;
    const T* kp = k + row0 * D;
    const T* vp = v + row0 * D;

    // rows [t0, t0 + kTile) of the chunk, those at or past n left 0
    auto load = [&](typename P::Buf& b, int t0) {
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const int t = t0 + rg + R * i;
#pragma unroll
        for (int j = 0; j < J; ++j) {
#pragma unroll
          for (int w = 0; w < P::NW; ++w) b.k[i][j][w] = b.v[i][j][w] = 0u;
          if (t < n && vok[j]) {
            load_vec<VEC>(kp + (size_t)t * D + off[j], b.k[i][j]);
            load_vec<VEC>(vp + (size_t)t * D + off[j], b.v[i][j]);
          }
        }
      }
    };

    auto fold = [&](const typename P::Buf& b, int t0) {
      float sc[NL];
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
#pragma unroll
          for (int e = 0; e < E; ++e)
            part = fmaf(qr[j][e], elem<T>(b.k[i][j], e), part);
        }
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        sc[i] = part * scale;
      }
      float mx = m;
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if (t0 + rg + R * i < n) mx = fmaxf(mx, sc[i]);
#pragma unroll
      for (int o = L; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[j][e] *= corr;
      }
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        if (t0 + rg + R * i < n) {
          const float p = expf(sc[i] - mx);
          l += p;
          const float pv = P::kBf16 ? round_bf16(p) : p;
#pragma unroll
          for (int j = 0; j < J; ++j) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[j][e] = fmaf(pv, elem<T>(b.v[i][j], e), acc[j][e]);
          }
        }
      }
      m = mx;
    };

    // the warp's tiles in order through two buffers in turn: the next
    // tile loads while this one folds (no copy between the buffers,
    // which would wait for the next tile's loads)
    typename P::Buf b0, b1;
    int t0 = warp * P::kTile;
    if (t0 < n) load(b0, t0);
    while (t0 < n) {
      if (t0 + kStep < n) load(b1, t0 + kStep);
      fold(b0, t0);
      t0 += kStep;
      if (t0 >= n) break;
      if (t0 + kStep < n) load(b0, t0 + kStep);
      fold(b1, t0);
      t0 += kStep;
    }
  }

  // the warp's row groups summed, then the warps merged in warp order
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
    }
  }
  if (lane == 0) {
    sm.m[warp] = m;
    sm.l[warp] = l;
  }
  if (rg == 0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (vok[j]) {
#pragma unroll
        for (int e = 0; e < E; ++e) sm.acc[warp][off[j] + e] = acc[j][e];
      }
    }
  }
  __syncthreads();
  float bm = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, sm.m[w]);
  float cw[kWarps];
  float bl = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    cw[w] = expf(sm.m[w] - bm);
    bl += sm.l[w] * cw[w];
  }
  auto block_acc = [&](int d) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm.acc[w][d] * cw[w];
    return a;
  };

  if (rank > 0) {
    // the block's partial into rank 0's slot `rank`, then one arrival a
    // thread on rank 0's barrier
    sm90::cluster_wait();
    const uint32_t base = sm90::cluster_addr(&sm, 0);
    auto at = [&](const void* p) {
      return base + (uint32_t)((const char*)p - (const char*)&sm);
    };
    if (threadIdx.x == 0) {
      sm90::st_cluster(at(&sm.pm[rank]), bm);
      sm90::st_cluster(at(&sm.pl[rank]), bl);
    }
    for (int d = threadIdx.x; d < D; d += kThreads)
      sm90::st_cluster(at(&sm.pacc[rank][d]), block_acc(d));
    sm90::mbar_arrive_cluster(at(&sm.bar));
    return;
  }

  // rank 0: its own partial, the others' once all have arrived, merged
  // in rank order (chunk order up to T = kCluster kChunk)
  if (threadIdx.x == 0) {
    sm.pm[0] = bm;
    sm.pl[0] = bl;
  }
  for (int d = threadIdx.x; d < D; d += kThreads) sm.pacc[0][d] = block_acc(d);
  if (nb > 1) sm90::mbar_wait<true>(&sm.bar, 0);
  __syncthreads();
  float mx = kNegInf;
  for (int r = 0; r < nb; ++r) mx = fmaxf(mx, sm.pm[r]);
  float cr[kCluster];
  float lsum = 0.f;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    cr[r] = r < nb ? expf(sm.pm[r] - mx) : 0.f;
    if (r < nb) lsum += sm.pl[r] * cr[r];
  }
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r)
      if (r < nb) a += sm.pacc[r][d] * cr[r];
    out[(size_t)sh * D + d] = a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T>
using SplitFn = decltype(&decode_attention_split_kernel<T, 4, 1, 1>);

// The instantiation for L lanes and J vectors a lane (J > 1 only at
// L = 32, and only up to what a 256-wide row needs)
template <typename T, int VEC, int L>
SplitFn<T> split_for_j(int J) {
  constexpr int kJMax = kMaxD / (VEC / (int)sizeof(T)) / 32;
  if constexpr (L < 32) {
    return J == 1 ? decode_attention_split_kernel<T, VEC, L, 1> : nullptr;
  } else {
    switch (J) {
      case 1: return decode_attention_split_kernel<T, VEC, 32, 1>;
      case 2:
        if constexpr (kJMax >= 2)
          return decode_attention_split_kernel<T, VEC, 32, 2>;
        return nullptr;
      case 4:
        if constexpr (kJMax >= 4)
          return decode_attention_split_kernel<T, VEC, 32, 4>;
        return nullptr;
      case 8:
        if constexpr (kJMax >= 8)
          return decode_attention_split_kernel<T, VEC, 32, 8>;
        return nullptr;
      default: return nullptr;
    }
  }
}

template <typename T, int VEC>
SplitFn<T> split_for(int D) {
  constexpr int E = VEC / (int)sizeof(T);
  const int nv = (D + E - 1) / E;
  int L = 1, J = 1;
  while (L < nv && L < 32) L <<= 1;
  while (L * J < nv) J <<= 1;
  switch (L) {
    case 1: return split_for_j<T, VEC, 1>(J);
    case 2: return split_for_j<T, VEC, 2>(J);
    case 4: return split_for_j<T, VEC, 4>(J);
    case 8: return split_for_j<T, VEC, 8>(J);
    case 16: return split_for_j<T, VEC, 16>(J);
    default: return split_for_j<T, VEC, 32>(J);
  }
}

// The widest load a row of D elements and the caches' alignment allow;
// one bf16 at odd D
template <typename T>
int split_load_width(const void* k, const void* v, int D) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  const int row = D * (int)sizeof(T);
  for (int w = 16; w >= 4; w >>= 1)
    if (row % w == 0 && a % w == 0) return w;
  return (int)sizeof(T);
}

// The instantiation head dim D and the caches k, v take, or nullptr
template <typename T>
SplitFn<T> split_kernel_for(const void* k, const void* v, int D) {
  if (D < 1 || D > kMaxD) return nullptr;
  switch (split_load_width<T>(k, v, D)) {
    case 16: return split_for<T, 16>(D);
    case 8: return split_for<T, 8>(D);
    case 4: return split_for<T, 4>(D);
    case 2:
      if constexpr (sizeof(T) == 2) return split_for<T, 2>(D);
      return nullptr;
    default: return nullptr;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int S, int H, int T_cap, int D, float scale,
           void* stream) {
  const SplitFn<T> kernel = split_kernel_for<T>(k, v, D);
  if (kernel == nullptr || S < 1 || H < 1 || T_cap < 0)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(S * H, kCluster), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const T*)k, (const T*)v, (const int*)lengths,
      (float*)out, H, T_cap, D, scale);
  return (int)cudaGetLastError();
}

// The split kernel taken at head dim D with 16-byte-aligned caches:
// out = {registers, local (spill) bytes, blocks per SM, load width,
// keys a chunk, blocks a cluster}.
template <typename T>
int info(int D, int* out) {
  const void* aligned = reinterpret_cast<const void*>(256);
  const SplitFn<T> kernel = split_kernel_for<T>(aligned, aligned, D);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = split_load_width<T>(aligned, aligned, D);
  out[4] = kChunk;
  out[5] = kCluster;
  return 0;
}

}  // namespace

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* out, int S, int H, int T_cap,
                                    int D, float scale, void* stream) {
  return launch<float>(q, k, v, lengths, out, S, H, T_cap, D, scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int S, int H, int T_cap,
                                     int D, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, out, S, H, T_cap, D, scale,
                               stream);
}

extern "C" int decode_attention_info(int D, int bf16, int* out) {
  return bf16 ? info<__nv_bfloat16>(D, out) : info<float>(D, out);
}

// int8 caches (B4): k, v [S, H, T, D] int8 with scales ks, vs [S, H, T]
// f32. Replaces decode_attention.py::_decode_kernel_quant.
//
// The numeric contract, the folds, the lane layout, the I2F-free
// conversion and the merge are int8_attention.cuh's, shared with the
// int8 paged kernel (B5). This kernel walks the slot's contiguous panel:
// one block per (slot, head) on a 2-D grid (no division by H), warp w
// folds tiles w, w + 8, ... of kTile rows and stops at the slot's
// length, so a stale tail's values and scales are never loaded. The
// warp's next tile is loaded into the second register buffer before the
// current one is folded.
namespace {

template <int G, int VEC>
__global__ void __launch_bounds__(int8_attention::kThreads)
decode_attention_int8_kernel(const float* __restrict__ q,
                             const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v,
                             const float* __restrict__ ks,
                             const float* __restrict__ vs,
                             const int* __restrict__ lengths,
                             float* __restrict__ out, int T_cap, int D,
                             float scale) {
  using Lane = int8_attention::Int8Lane<G, VEC>;
  constexpr int kStep = int8_attention::kWarps * Lane::kTile;
  __shared__ typename Lane::Merge sm;
  const int s = blockIdx.x, h = blockIdx.y;  // slots in x: no cap
  const size_t sh = (size_t)s * gridDim.y + h;
  int len = lengths[s];
  len = len < 0 ? 0 : (len > T_cap ? T_cap : len);
  Lane lane(q + sh * D, D);
  const size_t row0 = sh * T_cap;
  auto load = [&](typename Lane::Buf& b, int t0) {
    lane.load(b, k + (row0 + t0) * D, v + (row0 + t0) * D, ks + row0 + t0,
              vs + row0 + t0, min(Lane::kTile, len - t0), D);
  };

  // the warp's tiles in order, the next one loading while this one folds
  typename Lane::Buf cur, nxt;
  int t0 = (threadIdx.x / 32) * Lane::kTile;
  if (t0 < len) load(cur, t0);
  for (; t0 < len; t0 += kStep) {
    if (t0 + kStep < len) load(nxt, t0 + kStep);
    lane.fold(cur, min(Lane::kTile, len - t0), scale);
    cur = nxt;
  }

  lane.stash(sm, D);
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D) out[sh * D + d] = Lane::combine(sm, d, D);
}

struct DecodeInt8 {
  using Fn = decltype(&decode_attention_int8_kernel<1, 4>);
  template <int G, int VEC>
  static Fn fn() { return decode_attention_int8_kernel<G, VEC>; }
};

}  // namespace

extern "C" int decode_attention_int8(const void* q, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, const void* lengths,
                                     void* out, int S, int H, int T_cap,
                                     int D, float scale, void* stream) {
  const DecodeInt8::Fn kernel =
      int8_attention::kernel_for<DecodeInt8>(k, v, D);
  if (kernel == nullptr || S < 1 || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  kernel<<<dim3(S, H), int8_attention::kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const int8_t*)k, (const int8_t*)v, (const float*)ks,
      (const float*)vs, (const int*)lengths, (float*)out, T_cap, D, scale);
  return (int)cudaGetLastError();
}

// The int8 decode kernel taken at head dim D with 16-byte-aligned
// caches: out = {registers, local (spill) bytes, blocks per SM, load
// width}.
extern "C" int decode_attention_int8_info(int D, int* out) {
  const void* aligned = reinterpret_cast<const void*>(256);
  const DecodeInt8::Fn kernel =
      int8_attention::kernel_for<DecodeInt8>(aligned, aligned, D);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[2], kernel, int8_attention::kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[3] = int8_attention::load_width(aligned, aligned, D);
  return 0;
}
