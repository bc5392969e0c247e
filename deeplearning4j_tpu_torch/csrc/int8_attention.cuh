// The int8 tile machinery of the int8 decode kernel (decode_attention.cu,
// B4) and the int8 paged kernel (paged_attention.cu, B5): one query row
// attends over int8 K/V rows, each row with its own f32 scale, under an
// online softmax. B4 walks a slot's contiguous [T, D] panel, B5 a
// sequence's pool blocks through its table; both fold their tiles
// through Int8Lane below.
//
// Numeric contract (the Pallas kernels' own, decode_attention.py:159-189
// and paged_attention.py:149-181):
//   q is rounded to bf16; int8 -> float is exact, and so is each bf16 x
//   int8 product, so the QK dot is an f32 sum of exact products;
//   s = dot(q, k) * (1 / sqrt(D)) * kscale;
//   p = exp(s - m), and l sums p;
//   pv = p * vscale, rounded to bf16 before the PV product; the
//   accumulators are f32.
//
// The folds. Where pv is rounded depends on the running max m, so both
// kernels fold the same way: with G = group_width(D) (the power of two
// >= D / 4), warp w folds tiles w, w + 8, ... of kTile = 8 * 32 / G rows,
// and within a tile stream g of the warp (g < 32 / G) takes rows g,
// g + 32 / G, ... and updates its max once per tile. Every stream of
// every warp is merged once through shared memory at the end, in a fixed
// order, so two calls give the same bits. The running max starts at
// -1e30 and l is clamped at 1e-30, so a row with no live key gives
// exactly 0, as in the Pallas kernels.
//
// What bounds it: bytes. A live key costs 2 D int8 bytes plus two f32
// scales and about 4 D flops plus an exp, ~2 flops per byte, under the
// card's f32-rate-to-memory-rate ratio (~20). The lane layout is built
// for the bytes:
//  - VEC-byte loads (16 when D % 16 == 0 and the values are 16-byte
//    aligned, else 8, else 4): a row is L = G * 4 / VEC lanes, a warp
//    load covers R = 32 / L rows (8 rows of 64 bytes at D = 64), and a
//    lane loads NL = kTile / R rows of K and of V per tile (2 at
//    VEC = 16). R is a multiple of the stream count, so all of a lane's
//    rows belong to one stream: scores are computed in this layout and
//    each stream's max and rounding are taken over its own rows.
//  - int8 -> f32 without I2F (a quarter-rate conversion): each 32-bit
//    word is XORed with 0x80808080 (int8 b -> byte b + 128), PRMT puts a
//    byte into the low byte of 0x4B000000 (the f32 2^23 + b + 128), and
//    one FADD of -(2^23 + 128) leaves b, exactly, for all 256 values.
//  - A row's dot reduces over its L lanes (2 shuffles at D = 64); the
//    stream max over the lanes that share a stream (2 more).
//  - Loads in flight: the kernels load a warp's next tile into a second
//    register buffer (Int8Buf) before the current one is folded.
//  - Rows at or past a panel's live count are never loaded, scales
//    included: a stale tail's scale may be NaN, and nothing of it can
//    reach the sum (the Pallas kernels masked it with a where-guard).
//  - Each lane keeps its rows' partial (l, acc) under its stream's max;
//    at the end the partials of a stream are summed by shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace int8_attention {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;  // a tile is kUnroll rows of each stream
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int G, int VEC>
struct Int8Layout {
  static constexpr int kStreams = 32 / G;  // streams per warp
  static constexpr int kTile = kStreams * kUnroll;
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

// One lane's place in the layout and its stream's softmax state.
template <int G, int VEC>
struct Int8Lane {
  using Lay = Int8Layout<G, VEC>;
  static constexpr int L = Lay::L, R = Lay::R, NL = Lay::NL, W = Lay::W;
  static constexpr int kTile = Lay::kTile;
  static constexpr int kStreamsAll = kWarps * Lay::kStreams;
  using Buf = Int8Buf<NL, W>;
  // the block's streams, merged once at the end
  struct Merge {
    float m[kStreamsAll], l[kStreamsAll];
    float acc[kWarps * 128];  // kStreamsAll * D <= kWarps * 128
  };

  int rg;    // the lane's row group: rows rg + R i of a tile
  int d0;    // its bytes of a row
  bool dok;  // d0 < D
  float qr[VEC], acc[VEC];
  float m, l;

  // q: the (sequence, head)'s query row
  __device__ __forceinline__ Int8Lane(const float* __restrict__ q, int D) {
    const int lane = threadIdx.x % 32;
    rg = lane / L;
    d0 = VEC * (lane % L);
    dok = d0 < D;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[e] = dok ? round_bf16(q[d0 + e]) : 0.f;
      acc[e] = 0.f;
    }
    m = kNegInf;
    l = 0.f;
  }

  // Load rows [0, n) of a tile (n <= kTile) of a contiguous run of rows:
  // values at kp/vp (row stride D), scales at ksp/vsp.
  __device__ __forceinline__ void load(Buf& b, const int8_t* __restrict__ kp,
                                       const int8_t* __restrict__ vp,
                                       const float* __restrict__ ksp,
                                       const float* __restrict__ vsp, int n,
                                       int D) const {
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int t = rg + R * i;
      const bool ok = t < n;
#pragma unroll
      for (int w = 0; w < W; ++w) b.k[i][w] = b.v[i][w] = 0u;
      if (ok && dok) {
        load_words<W>(kp + (size_t)t * D + d0, b.k[i]);
        load_words<W>(vp + (size_t)t * D + d0, b.v[i]);
      }
      b.ks[i] = ok ? __ldg(ksp + t) : 0.f;
      b.vs[i] = ok ? __ldg(vsp + t) : 0.f;
    }
  }

  // Fold the tile's rows [0, n) into the lane's stream.
  __device__ __forceinline__ void fold(const Buf& b, int n, float scale) {
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
        const float pv = round_bf16(p * b.vs[i]);
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
  }

  // Sum the partials of the lane's stream across its row groups and put
  // the stream's (m, l, acc) into sm. The block's barrier follows.
  __device__ __forceinline__ void stash(Merge& sm, int D) {
#pragma unroll
    for (int o = L * Lay::kStreams; o < 32; o <<= 1) {
      l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
    }
    if (rg < Lay::kStreams) {
      const int stream = (threadIdx.x / 32) * Lay::kStreams + rg;
      if (d0 == 0) {
        sm.m[stream] = m;
        sm.l[stream] = l;
      }
      if (dok) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) sm.acc[stream * D + d0 + e] = acc[e];
      }
    }
  }

  // Output element d (< D) of the merged streams, after the barrier.
  __device__ __forceinline__ static float combine(const Merge& sm, int d,
                                                  int D) {
    float mx = kNegInf;
    for (int w = 0; w < kStreamsAll; ++w) mx = fmaxf(mx, sm.m[w]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < kStreamsAll; ++w) {
      const float c = expf(sm.m[w] - mx);
      lsum += sm.l[w] * c;
      a += sm.acc[w * D + d] * c;
    }
    return a / fmaxf(lsum, 1e-30f);
  }
};

// G, the lane-group width, for head dim D (4..128, D % 4 == 0); 0 for a
// head dim the int8 kernels do not take.
inline int group_width(int D) {
  if (D < 4 || D > 128 || D % 4) return 0;
  int g = 1;
  while (g < D / 4) g <<= 1;
  return g;
}

// The load width the head dim and the values' alignment allow
inline int load_width(const void* k, const void* v, int D) {
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  if (D % 16 == 0 && a % 16 == 0) return 16;
  if (D % 8 == 0 && a % 8 == 0) return 8;
  return 4;
}

// K::fn<G, VEC>() for lane-group width G and load width VEC, or nullptr
// where the layout has none (a row narrower than one load); K::Fn is the
// kernel's pointer type
template <class K, int VEC>
typename K::Fn kernel_for_vec(int G) {
  switch (G) {
    case 1: if constexpr (VEC == 4) return K::template fn<1, 4>();
            return nullptr;
    case 2: if constexpr (VEC <= 8) return K::template fn<2, VEC>();
            return nullptr;
    case 4: return K::template fn<4, VEC>();
    case 8: return K::template fn<8, VEC>();
    case 16: return K::template fn<16, VEC>();
    case 32: return K::template fn<32, VEC>();
    default: return nullptr;
  }
}

// The instantiation of K::fn that head dim D and the values k, v take
template <class K>
typename K::Fn kernel_for(const void* k, const void* v, int D) {
  const int G = group_width(D);
  switch (load_width(k, v, D)) {
    case 16: return kernel_for_vec<K, 16>(G);
    case 8: return kernel_for_vec<K, 8>(G);
    default: return kernel_for_vec<K, 4>(G);
  }
}

}  // namespace int8_attention
