// The int8 leg shared by decode_attention.cu and paged_attention.cu:
// one query row attends over panels of int8 K/V rows, each row with its
// own f32 scale, under an online softmax.
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
// What bounds it: bytes. A live key costs 2 D int8 bytes plus two f32
// scales and about 4 D flops plus an exp, ~2 flops per byte, under the
// card's f32-rate-to-memory-rate ratio (~20). So the layout is about
// moving those bytes in wide, coalesced loads:
//  - A warp is 32 / G groups of G lanes, G the power of two >= D / 4.
//    Lane gl of a group holds head-dim elements [4 gl, 4 gl + 4) and
//    loads them as one 4-byte vector, so a group reads a whole key row
//    and a warp reads 32 / G consecutive rows (128 bytes at D = 64) per
//    load instruction. The dot is reduced inside the group by shuffles.
//  - A tile is kUnroll loads of 32 / G rows each, all issued before any
//    is used, to keep loads in flight.
//  - Rows at or past a panel's live count are never loaded, scales
//    included: a stale tail's scale may be NaN, and nothing of it can
//    reach the sum (the Pallas kernels masked it with a where-guard).
//  - Each group keeps its own (m, l, acc) in registers; every group of
//    every warp is merged once through shared memory at the end. The
//    running max starts at -1e30 and l is clamped at 1e-30, so a row
//    with no live key gives exactly 0, as in the Pallas kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace int8_attention {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 8;  // row loads per lane issued before use
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One lane's place in the layout above and its group's softmax state.
template <int G>
struct Lane {
  static constexpr int kRows = 32 / G;           // rows per warp load
  static constexpr int kTile = kRows * kUnroll;  // rows per tile
  int grp, d0;
  bool dok;  // this lane holds head-dim elements (d0 < D)
  float qr[4];
  float m, l, acc[4];

  __device__ __forceinline__ Lane(const float* __restrict__ q, int D) {
    const int lane = threadIdx.x % 32;
    grp = lane / G;
    d0 = 4 * (lane % G);
    dok = d0 < D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[i] = dok ? round_bf16(q[d0 + i]) : 0.f;
      acc[i] = 0.f;
    }
    m = kNegInf;
    l = 0.f;
  }

  // Fold rows [0, n) (n <= kTile) of a contiguous panel: values at
  // kp/vp (row stride D), scales at ksp/vsp.
  __device__ __forceinline__ void tile(const int8_t* __restrict__ kp,
                                       const int8_t* __restrict__ vp,
                                       const float* __restrict__ ksp,
                                       const float* __restrict__ vsp, int n,
                                       int D, float scale) {
    char4 kr[kUnroll], vr[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    const char4 zero = make_char4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int t = grp + kRows * j;
      const bool ok = t < n;
      const size_t off = (size_t)t * D + d0;
      kr[j] = ok && dok ? *reinterpret_cast<const char4*>(kp + off) : zero;
      vr[j] = ok && dok ? *reinterpret_cast<const char4*>(vp + off) : zero;
      ks[j] = ok ? ksp[t] : 0.f;
      vs[j] = ok ? vsp[t] : 0.f;
    }
    float sc[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      float part = qr[0] * (float)kr[j].x;
      part = fmaf(qr[1], (float)kr[j].y, part);
      part = fmaf(qr[2], (float)kr[j].z, part);
      part = fmaf(qr[3], (float)kr[j].w, part);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      sc[j] = part * scale * ks[j];
    }
    float m_new = m;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (grp + kRows * j < n) m_new = fmaxf(m_new, sc[j]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (grp + kRows * j < n) {
        const float p = expf(sc[j] - m_new);
        l += p;
        const float pv = round_bf16(p * vs[j]);
        acc[0] = fmaf(pv, (float)vr[j].x, acc[0]);
        acc[1] = fmaf(pv, (float)vr[j].y, acc[1]);
        acc[2] = fmaf(pv, (float)vr[j].z, acc[2]);
        acc[3] = fmaf(pv, (float)vr[j].w, acc[3]);
      }
    }
    m = m_new;
  }

  // Merge every group of every warp and write out[0, D). NaN rows when
  // `bad` (read after the block's barrier) is set.
  __device__ __forceinline__ void merge_store(float* __restrict__ out, int D,
                                              const volatile int* bad) {
    constexpr int kStreams = kWarps * kRows;
    __shared__ float sm_m[kStreams];
    __shared__ float sm_l[kStreams];
    __shared__ float sm_acc[kWarps * 128];  // kStreams * D <= kWarps * 128
    const int stream = (threadIdx.x / 32) * kRows + grp;
    if (d0 == 0) {
      sm_m[stream] = m;
      sm_l[stream] = l;
    }
    if (dok) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sm_acc[stream * D + d0 + i] = acc[i];
    }
    __syncthreads();
    const int d = threadIdx.x;
    if (d < D) {
      float mx = kNegInf;
      for (int w = 0; w < kStreams; ++w) mx = fmaxf(mx, sm_m[w]);
      float lsum = 0.f, a = 0.f;
      for (int w = 0; w < kStreams; ++w) {
        const float c = expf(sm_m[w] - mx);
        lsum += sm_l[w] * c;
        a += sm_acc[w * D + d] * c;
      }
      out[d] = (bad != nullptr && *bad) ? __int_as_float(0x7fc00000)
                                        : a / fmaxf(lsum, 1e-30f);
    }
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

}  // namespace int8_attention
