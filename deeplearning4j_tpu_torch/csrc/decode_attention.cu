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
// stream over the live cache, and its design is about the bytes:
//  - The TPU kernel streamed the whole capacity T and masked keys at
//    positions >= lengths[s]. This one stops at lengths[s]: the masked
//    tiles had p = 0 and corr = 1 there, so the result is the same and
//    only live rows are read. Rows past the length are never loaded,
//    so a recycled slot's non-finite tail cannot reach the sum (the
//    TPU kernel zeroed those V rows because 0 * NaN = NaN).
//  - One block per (slot, head), 8 warps. Warp w takes keys
//    [4w, 4w + 4), then steps by 32. Each lane holds head-dim elements
//    lane, lane + 32, ... so a key row is one coalesced load per warp;
//    four rows are loaded before their dot products are reduced, to
//    keep loads in flight.
//  - Each warp keeps its own online softmax (m, l, acc) in registers;
//    the warps are merged once through shared memory at the end.
//  - bf16 caches: q and p are rounded to bf16 before their products,
//    accumulation is f32, as the TPU kernel's bf16 operands with f32
//    accumulation (decode_attention.py:113-135).
//  - A slot with length 0 gives exactly 0: l is clamped at 1e-30 as in
//    the TPU kernel, and the running max starts at -1e30, not -inf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "int8_attention.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;       // key rows loaded per warp before reducing
constexpr int kMaxPerLane = 4;   // head dim <= 128
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
decode_attention_kernel(const float* __restrict__ q,
                        const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths,
                        float* __restrict__ out,
                        int H, int T_cap, int D, float scale) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  const int sh = blockIdx.x;  // slot * H + head
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int len = lengths[sh / H];
  len = len < 0 ? 0 : (len > T_cap ? T_cap : len);
  const float* qp = q + (size_t)sh * D;
  const T* kp = k + (size_t)sh * T_cap * D;
  const T* vp = v + (size_t)sh * T_cap * D;

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

  for (int t0 = warp * kUnroll; t0 < len; t0 += kWarps * kUnroll) {
    float sc[kUnroll];
    float vr[kUnroll][kMaxPerLane];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int t = t0 + j;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        const int d = lane + 32 * i;
        const bool ok = t < len && d < D;
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
      if (t0 + j < len) m_new = fmaxf(m_new, sc[j]);
    }
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (t0 + j < len) {
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

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * kMaxPerLane];
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
    out[(size_t)sh * D + d] = a / fmaxf(lsum, 1e-30f);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           void* out, int S, int H, int T_cap, int D, float scale,
           void* stream) {
  if (D < 1 || D > 32 * kMaxPerLane || S * H == 0)
    return (int)cudaErrorInvalidValue;
  decode_attention_kernel<T><<<S * H, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const T*)k, (const T*)v, (const int*)lengths,
      (float*)out, H, T_cap, D, scale);
  return (int)cudaGetLastError();
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
