// K3: fused Winograd F(2x2, 3x3) convolution, SAME, stride 1, NHWC.
//
// Replaces rendernet_tpu/ops/pallas_winograd.py:_kernel (reached through
// pl.pallas_call in _wino_call_hwnc, entry wino_conv2d). For every 2x2
// output tile: V = B^T d B over its 4x4 input tile in fp32, cast to the
// storage type; 16 per-frequency GEMMs M[f] = V[f] @ U[f] with fp32
// accumulation (U = G w G^T is computed in fp32 by a small kernel launched
// first, and cast);
// Y = A^T M A in fp32, rounded once to the storage type. Those are the
// reference's rounding points.
//
// Bound: operations. The 16 GEMMs do 2 * 16 * tiles * C * K flops (res2 at
// batch 8: 8192 tiles, C = K = 1024, 2.75e11 flops, 0.28 ms at 989 TFLOP/s
// bf16; 4.1 ms at 67 TFLOP/s fp32). The TPU kernel holds 16 fp32
// [tiles, bn] accumulators in megabytes of VMEM; an SM has 227 KB of shared
// memory and 256 KB of registers, so this kernel tiles smaller: a block owns
// one row of up to 32 Winograd tiles, 64 output channels and all 16
// frequencies, and walks C in chunks of 16. Each chunk's 4 x 66 x 16 input
// slab and [16, 16, 64] slice of U are copied into shared memory with
// cp.async, double-buffered so the next chunk's copies overlap this chunk's
// work. The slab is transformed to V in shared memory (one (tile, channel)
// per thread), then the GEMMs run: in bf16 on the tensor cores (WMMA
// 16x16x16, one warp per frequency, 2 x 4 fp32 accumulator fragments
// each), in fp32 on the CUDA cores (each thread 4 tiles x 1 channel x 16
// frequencies in registers). Row strides of V and U are padded so the
// fragment loads are free of bank conflicts. The inverse transform reads
// the accumulators (through shared memory for the fragments) and writes
// the 2x2 outputs, coalesced along K. The input is read once per 64 output
// channels and V is recomputed as often; U is read once per tile row. Both
// are the places to start making this kernel faster.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TT = 32;   // Winograd tiles per block (along W)
constexpr int BN = 64;   // output channels per block
constexpr int CK = 16;   // input channels per chunk
constexpr int NT = 512;  // threads per block
constexpr int XW = 2 * TT + 2;
// Padded shared-memory row strides: rows of V and U land on different
// banks, so the 8-row ldmatrix loads behind WMMA (and the fp32 path's
// float4 reads) are conflict-free.
constexpr int VLD = TT + 8;  // V rows [16][CK][VLD]
constexpr int ULD = BN + 8;  // U rows [16][CK][ULD]
constexpr int MLD = BN + 4;  // accumulator rows [16][TT][MLD] (floats)
constexpr int XS = 4 * XW * CK, US = 16 * CK * ULD, VS = 16 * CK * VLD;
static_assert(TT * CK == NT, "one (tile, channel) of the input transform per thread");
static_assert(16 * 32 == NT, "one warp per frequency in the tensor-core path");

// Shared memory: xs[2][4][XW][CK] and us[2][16][CK][ULD] (double-buffered,
// filled by cp.async), vs[16][CK][VLD]; the bf16 epilogue's fp32
// accumulators ms[16][TT][MLD] reuse the same bytes after the main loop.
template <typename T>
constexpr size_t smem_bytes() {
  const size_t main = sizeof(T) * (2 * XS + 2 * US + VS);
  const size_t epi = std::is_same<T, __nv_bfloat16>::value ? sizeof(float) * 16 * TT * MLD : 0;
  return main > epi ? main : epi;
}

using rn::cp_async16;
using rn::cp_async_commit;
using rn::cp_async_wait;

template <typename T>
__device__ __forceinline__ void store_tile(const float m[16], T* __restrict__ y, int b,
                                           int th, int tw, int n, int H, int W, int K) {
  float r0[4], r1[4];
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    r0[k2] = (m[k2] + m[4 + k2]) + m[8 + k2];
    r1[k2] = (m[4 + k2] - m[8 + k2]) - m[12 + k2];
  }
  const float out[2][2] = {{(r0[0] + r0[1]) + r0[2], (r0[1] - r0[2]) - r0[3]},
                           {(r1[0] + r1[1]) + r1[2], (r1[1] - r1[2]) - r1[3]}};
#pragma unroll
  for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
    for (int p2 = 0; p2 < 2; ++p2) {
      const long long pix = (static_cast<long long>(b) * H + 2 * th + p1) * W + 2 * tw + p2;
      y[pix * K + n] = rn::from_f32<T>(out[p1][p2]);
    }
}

template <typename T>
__global__ void __launch_bounds__(NT) wino_kernel(const T* __restrict__ x,
                                                  const T* __restrict__ u,
                                                  T* __restrict__ y, int H, int W, int C,
                                                  int K) {
  constexpr bool kTensorCores = std::is_same<T, __nv_bfloat16>::value;
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* us = xs + 2 * XS;
  T* vs = us + 2 * US;
  float* ms = reinterpret_cast<float*>(smem);

  const int nw = W / 2;
  const int ngroups = (nw + TT - 1) / TT;
  const int tw0 = (blockIdx.x % ngroups) * TT;
  const int n0 = (blockIdx.x / ngroups) * BN;
  const int th = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const T* xb = x + static_cast<long long>(b) * H * W * C;

  // Stage channel chunk c0 into buffer st: the 4 x XW input slab (zeros
  // outside the image: the SAME halo) and the [16, CK, BN] slice of U.
  auto prefetch = [&](int c0, int st) {
    T* xd = xs + st * XS;
    T* ud = us + st * US;
    for (int i = tid; i < XS / EPV; i += NT) {
      const int e = i * EPV;
      const int c = e % CK, col = (e / CK) % XW, r = e / (CK * XW);
      const int hh = 2 * th - 1 + r, ww = 2 * tw0 - 1 + col;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const T* src = in ? xb + (static_cast<long long>(hh) * W + ww) * C + c0 + c : xb;
      cp_async16(xd + e, src, in ? 16 : 0);
    }
    for (int i = tid; i < 16 * CK * BN / EPV; i += NT) {
      const int e = i * EPV;
      const int n = e % BN, c = (e / BN) % CK, f = e / (BN * CK);
      cp_async16(ud + (f * CK + c) * ULD + n,
                 u + (static_cast<long long>(f) * C + c0 + c) * K + n0 + n, 16);
    }
    cp_async_commit();
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[2][4];
  float acc[4][16];  // fp32 path: [tile][frequency]
  if constexpr (kTensorCores) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc_tc[i][j], 0.f);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int f = 0; f < 16; ++f) acc[t][f] = 0.f;
  }

  const int nchunks = C / CK;
  prefetch(0, 0);
  for (int k = 0; k < nchunks; ++k) {
    const int st = k & 1;
    if (k + 1 < nchunks) {
      prefetch((k + 1) * CK, st ^ 1);  // overlaps this chunk's work
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {  // V = B^T d B for tile t, channel c (fp32, the reference's order)
      const T* xc = xs + st * XS;
      const int t = tid / CK, c = tid % CK;
      float d[4][4], rt[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) d[r][s] = rn::to_f32(xc[(r * XW + 2 * t + s) * CK + c]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        rt[0][s] = d[0][s] - d[2][s];
        rt[1][s] = d[1][s] + d[2][s];
        rt[2][s] = -d[1][s] + d[2][s];
        rt[3][s] = d[1][s] - d[3][s];
      }
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) {
        const float v[4] = {rt[k1][0] - rt[k1][2], rt[k1][1] + rt[k1][2],
                            -rt[k1][1] + rt[k1][2], rt[k1][1] - rt[k1][3]};
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2)
          vs[((k1 * 4 + k2) * CK + c) * VLD + t] = rn::from_f32<T>(v[k2]);
      }
    }
    __syncthreads();
    const T* uc = us + st * US;
    if constexpr (kTensorCores) {
      const int f = tid / 32;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wmma::load_matrix_sync(a[mt], vs + f * CK * VLD + mt * 16, VLD);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {  // each U fragment loaded once
        wmma::load_matrix_sync(bm, uc + f * CK * ULD + nt * 16, ULD);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) wmma::mma_sync(acc_tc[mt][nt], a[mt], bm, acc_tc[mt][nt]);
      }
    } else {
      // thread = (channel n, tiles 4tg..4tg+3); the 4 tiles' V values are
      // one float4 (a broadcast: a warp shares tg), U is conflict-free.
      const int n = tid % BN, tg = tid / BN;
#pragma unroll 1
      for (int c = 0; c < CK; ++c)
#pragma unroll
        for (int f = 0; f < 16; ++f) {
          const float uv = rn::to_f32(uc[(f * CK + c) * ULD + n]);
          const float4 v4 = *reinterpret_cast<const float4*>(
              reinterpret_cast<const float*>(vs) + (f * CK + c) * VLD + tg * 4);
          acc[0][f] = fmaf(v4.x, uv, acc[0][f]);
          acc[1][f] = fmaf(v4.y, uv, acc[1][f]);
          acc[2][f] = fmaf(v4.z, uv, acc[2][f]);
          acc[3][f] = fmaf(v4.w, uv, acc[3][f]);
        }
    }
    __syncthreads();  // the next prefetch overwrites this chunk's buffers
  }

  if constexpr (kTensorCores) {
    const int f = tid / 32;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        wmma::store_matrix_sync(ms + (f * TT + mt * 16) * MLD + nt * 16, acc_tc[mt][nt], MLD,
                                wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < TT * BN; i += NT) {
      const int t = i / BN, n = i % BN;
      if (tw0 + t >= nw) continue;
      float m[16];
#pragma unroll
      for (int f2 = 0; f2 < 16; ++f2) m[f2] = ms[(f2 * TT + t) * MLD + n];
      store_tile(m, y, b, th, tw0 + t, n0 + n, H, W, K);
    }
  } else {
    const int n = tid % BN, tg = tid / BN;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (tw0 + tg * 4 + t < nw) store_tile(acc[t], y, b, th, tw0 + tg * 4 + t, n0 + n, H, W, K);
  }
}

// U = G w G^T for one (c, k) per thread: w [3][3][C][K] -> u [16][C][K],
// in fp32 and rounded once to the storage type. The products are exact
// (G holds 0, +-1/2, 1), so only the sums round, left to right as in the
// plain version (ops/winograd.py:transform_weights).
template <typename T>
__global__ void wino_weights_kernel(const T* __restrict__ w, T* __restrict__ u, long long ck) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ck) return;
  float g[3][3], t[4][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) g[r][s] = rn::to_f32(w[(r * 3 + s) * ck + i]);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    t[0][s] = g[0][s];
    t[1][s] = (g[0][s] * 0.5f + g[1][s] * 0.5f) + g[2][s] * 0.5f;
    t[2][s] = (g[0][s] * 0.5f + g[1][s] * -0.5f) + g[2][s] * 0.5f;
    t[3][s] = g[2][s];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float v[4] = {t[a][0], (t[a][0] * 0.5f + t[a][1] * 0.5f) + t[a][2] * 0.5f,
                        (t[a][0] * 0.5f + t[a][1] * -0.5f) + t[a][2] * 0.5f, t[a][2]};
#pragma unroll
    for (int b = 0; b < 4; ++b) u[(a * 4 + b) * ck + i] = rn::from_f32<T>(v[b]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* u, void* y, int B, int H, int W, int C, int K,
           cudaStream_t s) {
  const long long ck = static_cast<long long>(C) * K;
  wino_weights_kernel<T><<<static_cast<unsigned>((ck + 255) / 256), 256, 0, s>>>(
      static_cast<const T*>(w), static_cast<T*>(u), ck);
  const size_t smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(wino_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = W / 2;
  const dim3 grid(((nw + TT - 1) / TT) * (K / BN), H / 2, B);
  wino_kernel<T><<<grid, NT, smem, s>>>(static_cast<const T*>(x), static_cast<const T*>(u),
                                        static_cast<T*>(y), H, W, C, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C], w [3, 3, C, K], u [16, C, K] (scratch for G w G^T),
// y [B, H, W, K], all 16-byte aligned; H, W even, C % 16 == 0, K % 64 == 0
// (the wrapper's envelope guarantees them).
extern "C" int rn_winograd(const void* x, const void* w, void* u, void* y, int dtype, int B,
                           int H, int W, int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, u, y, B, H, W, C, K, s);
  return launch<__nv_bfloat16>(x, w, u, y, B, H, W, C, K, s);
}
