// The Winograd F(2x2, 3x3) transforms shared by K3 (csrc/winograd.cu, its
// input transform) and K6 (csrc/winograd_wgrad.cu, its input transform and
// the cotangent spread), one thread per (2x2 output tile, CPT channels):
//   V  [P][16][T][C] = B^T d B of each tile's 4x4 input patch (zeros outside
//                      the image: the SAME halo), T = B * H/2 * W/2 tiles in
//                      (b, th, tw) order;
//   dM [P][16][T][K] = the tile's 2x2 block of the cotangent spread over the
//                      16 frequencies through A (the adjoint of K3's output
//                      transform).
// Both run in fp32 from the storage type (bf16 or fp32) and round once to
// bf16: P = 1, or with SPLIT, P = 2 planes hi = bf16(v) and lo = bf16(v -
// hi), so that hi + lo carries v to about 2^-16 of its size (K6's operands
// for fp32 products). Loads and stores are CPT consecutive channels: 8 bf16
// (16 bytes) for K3's bf16 transform, else 4 (8 bytes of bf16 out; 16
// bytes of fp32 in), which keeps a SPLIT thread's two output planes in
// registers.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace rn {

// A^T's entries: row p (output phase), column k (frequency index).
__host__ __device__ constexpr int at(int p, int k) {
  return p == 0 ? (k < 3 ? 1 : 0) : (k == 0 ? 0 : (k == 1 ? 1 : -1));
}

// The 4x4 input transform of one channel, in the reference's order:
// v[4 * k1 + k2] = sum_s BT[k2, s] (sum_r BT[k1, r] d[r][s]).
__device__ __forceinline__ void input_transform(const float d[4][4], float v[16]) {
  float rt[4][4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    rt[0][s] = d[0][s] - d[2][s];
    rt[1][s] = d[1][s] + d[2][s];
    rt[2][s] = -d[1][s] + d[2][s];
    rt[3][s] = d[1][s] - d[3][s];
  }
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1) {
    v[4 * k1 + 0] = rt[k1][0] - rt[k1][2];
    v[4 * k1 + 1] = rt[k1][1] + rt[k1][2];
    v[4 * k1 + 2] = -rt[k1][1] + rt[k1][2];
    v[4 * k1 + 3] = rt[k1][1] - rt[k1][3];
  }
}

// dM[4 k1 + k2] = sum over (p1, p2) of A[p1, k1] A[p2, k2] g[p1][p2], p1
// outer, the non-zero terms left to right (the plain version's order; A
// holds 0 and +-1, so every product is exact).
__device__ __forceinline__ void cotangent_spread(const float g[2][2], float m[16]) {
#pragma unroll
  for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      float s = 0.f;
      bool first = true;
#pragma unroll
      for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
        for (int p2 = 0; p2 < 2; ++p2) {
          const int a = at(p1, k1) * at(p2, k2);
          if (a != 0) {
            const float term = a > 0 ? g[p1][p2] : -g[p1][p2];
            s = first ? term : s + term;
            first = false;
          }
        }
      m[4 * k1 + k2] = s;
    }
}

// CPT consecutive channels of the storage type In, loaded as one vector.
template <typename In, int CPT>
struct ChanVec {
  static constexpr int WORDS = CPT * static_cast<int>(sizeof(In)) / 4;
  static_assert(WORDS == 2 || WORDS == 4, "8- or 16-byte vectors");
  uint32_t w[WORDS];

  __device__ __forceinline__ void load(const In* p) {
    if constexpr (WORDS == 4) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = r.x, w[1] = r.y, w[2] = r.z, w[3] = r.w;
    } else {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = r.x, w[1] = r.y;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0u;
  }
  // channels 2 j and 2 j + 1 in fp32
  __device__ __forceinline__ float2 pair(int j) const {
    if constexpr (std::is_same<In, float>::value)
      return make_float2(__uint_as_float(w[2 * j]), __uint_as_float(w[2 * j + 1]));
    else
      return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
  }
};

// CPT / 2 bf16 pairs stored as one 8- or 16-byte vector.
template <int N>
__device__ __forceinline__ void store_words(__nv_bfloat16* p, const uint32_t (&w)[N]) {
  static_assert(N == 2 || N == 4, "8- or 16-byte vectors");
  if constexpr (N == 4)
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// Rounds (a, b) to a bf16 pair, and with SPLIT also their remainders.
template <bool SPLIT>
__device__ __forceinline__ void round_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  if constexpr (SPLIT) {
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    lo = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Thread i of the input transform: tile i / (C / CPT), channels
// (i % (C / CPT)) CPT ..; V's lo plane (with SPLIT) is v + 16 T C.
template <typename In, int CPT, bool SPLIT>
__device__ __forceinline__ void input_transform_at(const In* __restrict__ x,
                                                   __nv_bfloat16* __restrict__ v, long long i,
                                                   int B, int H, int W, int C) {
  const int nh = H / 2, nw = W / 2, cg = C / CPT;
  const long long T = static_cast<long long>(B) * nh * nw;
  if (i >= T * cg) return;
  const int c = static_cast<int>(i % cg) * CPT;
  const long long t = i / cg;
  const int tw = static_cast<int>(t % nw), th = static_cast<int>((t / nw) % nh);
  const int b = static_cast<int>(t / (static_cast<long long>(nw) * nh));
  ChanVec<In, CPT> raw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int hh = 2 * th - 1 + r, ww = 2 * tw - 1 + s;
      raw[r][s].zero();
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        raw[r][s].load(x + ((static_cast<long long>(b) * H + hh) * W + ww) * C + c);
    }
  uint32_t hi[16][CPT / 2], lo[16][CPT / 2];
#pragma unroll
  for (int pair = 0; pair < CPT / 2; ++pair) {  // channels 2 pair, 2 pair + 1
    float d0[4][4], d1[4][4], v0[16], v1[16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float2 f2 = raw[r][s].pair(pair);
        d0[r][s] = f2.x;
        d1[r][s] = f2.y;
      }
    input_transform(d0, v0);
    input_transform(d1, v1);
#pragma unroll
    for (int f = 0; f < 16; ++f) round_pair<SPLIT>(v0[f], v1[f], hi[f][pair], lo[f][pair]);
  }
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    store_words(v + (f * T + t) * C + c, hi[f]);
    if constexpr (SPLIT) store_words(v + ((16 + f) * T + t) * C + c, lo[f]);
  }
}

// Thread i of the cotangent spread: tile i / (K / CPT), output channels
// (i % (K / CPT)) CPT ..; dM's lo plane (with SPLIT) is dm + 16 T K.
template <typename In, int CPT, bool SPLIT>
__device__ __forceinline__ void cotangent_spread_at(const In* __restrict__ gy,
                                                    __nv_bfloat16* __restrict__ dm, long long i,
                                                    int B, int H, int W, int K) {
  const int nh = H / 2, nw = W / 2, kg = K / CPT;
  const long long T = static_cast<long long>(B) * nh * nw;
  if (i >= T * kg) return;
  const int k = static_cast<int>(i % kg) * CPT;
  const long long t = i / kg;
  const int tw = static_cast<int>(t % nw), th = static_cast<int>((t / nw) % nh);
  const int b = static_cast<int>(t / (static_cast<long long>(nw) * nh));
  ChanVec<In, CPT> raw[2][2];
#pragma unroll
  for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
    for (int p2 = 0; p2 < 2; ++p2)
      raw[p1][p2].load(gy + ((static_cast<long long>(b) * H + 2 * th + p1) * W + 2 * tw + p2) * K +
                       k);
  uint32_t hi[16][CPT / 2], lo[16][CPT / 2];
#pragma unroll
  for (int pair = 0; pair < CPT / 2; ++pair) {
    float g0[2][2], g1[2][2], m0[16], m1[16];
#pragma unroll
    for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
      for (int p2 = 0; p2 < 2; ++p2) {
        const float2 f2 = raw[p1][p2].pair(pair);
        g0[p1][p2] = f2.x;
        g1[p1][p2] = f2.y;
      }
    cotangent_spread(g0, m0);
    cotangent_spread(g1, m1);
#pragma unroll
    for (int f = 0; f < 16; ++f) round_pair<SPLIT>(m0[f], m1[f], hi[f][pair], lo[f][pair]);
  }
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    store_words(dm + (f * T + t) * K + k, hi[f]);
    if constexpr (SPLIT) store_words(dm + ((16 + f) * T + t) * K + k, lo[f]);
  }
}

}  // namespace rn
