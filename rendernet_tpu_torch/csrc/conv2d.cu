// K5: SAME, stride-1, 3x3 convolution in HWNC layout with a fused
// res-block epilogue:
//   z = conv(x, w) + bias,  y = act(z) [+ res]
// x [H, W, B, C], w [3, 3, C, co], res / y / z [H, W, B, co]; act is none,
// PReLU (per-channel alpha) or ReLU; bias, alpha, res and z are optional.
//
// Replaces rendernet_tpu/ops/pallas_conv2d.py:_fwd_kernel (reached through
// pl.pallas_call in _conv_call; entries wc_conv2d, wc_conv2d_hwnc,
// wc_conv2d_{prelu,relu,res}_hwnc and the data gradient _dgrad, which runs
// this kernel on the flipped, io-swapped weights). The TPU kernel walks
// (co tile, batch tile, row block) on a sequential grid with bh + 2
// overlapping row views in VMEM; here it is a channels-last implicit GEMM:
// row m of the GEMM is pixel (h, w, b) with C contiguous, N = co,
// K = 9 * C, and tap (ky, kx) reads row m + ((ky - 1) W + kx - 1) B, zero
// where the shifted pixel leaves the image (masked loads, no padded copy).
// The epilogue runs on the fp32 accumulator in registers, in the TPU
// kernel's order (bias, z, activation, residual), with one rounding to the
// storage type.
//
// Bound: operations. 2 * H W B * 9 C * co flops (res2 at batch 8,
// [8, 64, 64, 1024] -> 1024: 6.18e11, 0.625 ms at 989 TFLOP/s bf16; 9.23 ms
// at 67 TFLOP/s fp32) against 2 * 67 MB of activations. A block owns 128
// pixels x 128 output channels and walks K in steps of 32 (bf16) or 16
// (fp32) channels of one tap, staging each step's [128 x 32] activation
// rows and [32 x 128] weight slice in shared memory with cp.async, four
// (bf16) or three (fp32) steps in flight. Blocks of one pixel tile are
// adjacent in launch order, so its rows come from HBM once and from L2
// for the other co / 128 tiles.
//   * bf16: tensor cores through mma.sync m16n8k16 (fp32 accumulate); 8
//     warps of 64 x 32, fragments loaded with ldmatrix from rows padded by
//     16 bytes (conflict-free).
//   * fp32: CUDA-core FMAs; each thread owns 8 pixels x 8 channels.
// wgmma and TMA (the card's full tensor-core rate) are for later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;  // pixels (GEMM rows) per block
constexpr int BN = 128;  // output channels per block
constexpr int NT = 256;  // threads per block

struct Geom {
  int H, W, B, C, co, M;  // M = H * W * B
};

struct Epi {
  const float* bias;   // [co] or null
  const float* alpha;  // [co] when act == 1
  const void* res;     // [M, co] storage type, or null
  void* z;             // [M, co] storage type (the pre-activation), or null
  int act;             // 0 none, 1 PReLU, 2 ReLU
};

using rn::cp_async16;
using rn::cp_async_commit;
using rn::cp_async_wait;
using rn::ldmatrix_x4;
using rn::ldmatrix_x4_trans;
using rn::mma_bf16;

// A GEMM row: pixel m = (h W + w) B + b, in range or not.
struct Row {
  int m, h, w;
  bool in;
};

__device__ __forceinline__ Row row_of(const Geom& g, int m) {
  Row r;
  r.m = m;
  r.in = m < g.M;
  const int hw = r.in ? m / g.B : 0;
  r.w = hw % g.W;
  r.h = hw / g.W;
  return r;
}

// The pixel that tap (ky, kx) reads for row r, and whether it is inside
// the image (outside it reads as zero: the SAME halo).
__device__ __forceinline__ bool tap_pixel(const Geom& g, const Row& r, int ky, int kx,
                                          long long& pix) {
  const int hs = r.h + ky - 1, ws = r.w + kx - 1;
  pix = r.m + (static_cast<long long>(ky - 1) * g.W + (kx - 1)) * g.B;
  return r.in && hs >= 0 && hs < g.H && ws >= 0 && ws < g.W;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float activate(const Epi& e, int n, float v) {
  if (e.act == 1) return v < 0.f ? e.alpha[n] * v : v;  // max(v, 0) + alpha min(v, 0)
  if (e.act == 2) return v < 0.f ? 0.f : v;
  return v;
}

// The epilogue of two neighbouring output channels n, n + 1 of pixel m.
template <typename T>
__device__ __forceinline__ void epilogue2(const Epi& e, T* __restrict__ y, int m, int n, int co,
                                          float v0, float v1) {
  const long long i = static_cast<long long>(m) * co + n;
  if (e.bias) {
    v0 += e.bias[n];
    v1 += e.bias[n + 1];
  }
  if (e.z) store2(static_cast<T*>(e.z) + i, v0, v1);
  v0 = activate(e, n, v0);
  v1 = activate(e, n + 1, v1);
  if (e.res) {
    const float2 r = load2(static_cast<const T*>(e.res) + i);
    v0 += r.x;
    v1 += r.y;
  }
  store2(y + i, v0, v1);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 on the tensor cores
// ---------------------------------------------------------------------------
namespace bf {
constexpr int BK = 32, STAGES = 4;
constexpr int ALD = BK + 8, BLD = BN + 8;  // padded row strides (elements)
constexpr int A_STAGE = BM * ALD, B_STAGE = BK * BLD;
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 2;
}  // namespace bf

__global__ void __launch_bounds__(NT, 2) conv2d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                            const __nv_bfloat16* __restrict__ w,
                                                            __nv_bfloat16* __restrict__ y,
                                                            Geom g, Epi e) {
  using namespace bf;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][ALD]
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;                    // [STAGES][BK][BLD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  // Each thread copies 16 bytes of two activation rows and of two weight
  // rows per step.
  const int arow = tid >> 2, acol = (tid & 3) * 8;
  const Row rows[2] = {row_of(g, m0 + arow), row_of(g, m0 + arow + 64)};
  const int brow = tid >> 4, bcol = (tid & 15) * 8;
  const int kchunks = g.C / BK, nsteps = 9 * kchunks;

  auto load = [&](int t, int st) {
    const int tap = t / kchunks, c0 = (t - tap * kchunks) * BK;
    const int ky = tap / 3, kx = tap - ky * 3;
    __nv_bfloat16* a = As + st * A_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      long long pix;
      const bool in = tap_pixel(g, rows[i], ky, kx, pix);
      cp_async16(a + (arow + 64 * i) * ALD + acol, in ? x + pix * g.C + c0 + acol : x,
                 in ? 16 : 0);
    }
    __nv_bfloat16* b = Bs + st * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = brow + 16 * i;
      cp_async16(b + k * BLD + bcol,
                 w + (static_cast<long long>(tap) * g.C + c0 + k) * g.co + n0 + bcol, 16);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step t has landed; every warp is done with step t - 1
    if (t + STAGES - 1 < nsteps) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* a = As + (t % STAGES) * A_STAGE;
    const __nv_bfloat16* b = Bs + (t % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt], a + (wm + mt * 16 + (lane & 15)) * ALD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BLD + wn +
                                 np * 16 + (lane >> 4) * 8);
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
  }
  cp_async_wait<0>();

  // accumulator (mt, nt): rows lane / 4 and + 8, channels 2 (lane % 4), + 1
  const int gq = lane >> 2, tq = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + gq + half * 8;
      if (m >= g.M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        epilogue2(e, y, m, n0 + wn + nt * 8 + tq, g.co, acc[mt][nt][2 * half],
                  acc[mt][nt][2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace f32 {
constexpr int BK = 16, STAGES = 3;
constexpr int ALD = BK + 4, BLD = BN + 4;
constexpr int A_STAGE = BM * ALD, B_STAGE = BK * BLD;
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE) * 4;
}  // namespace f32

__global__ void __launch_bounds__(NT, 2) conv2d_f32_kernel(const float* __restrict__ x,
                                                           const float* __restrict__ w,
                                                           float* __restrict__ y, Geom g,
                                                           Epi e) {
  using namespace f32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);  // [STAGES][BM][ALD]
  float* Bs = As + STAGES * A_STAGE;           // [STAGES][BK][BLD]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  const int arow = tid >> 2, acol = (tid & 3) * 4;
  const Row rows[2] = {row_of(g, m0 + arow), row_of(g, m0 + arow + 64)};
  const int brow = tid >> 5, bcol = (tid & 31) * 4;
  const int kchunks = g.C / BK, nsteps = 9 * kchunks;

  auto load = [&](int t, int st) {
    const int tap = t / kchunks, c0 = (t - tap * kchunks) * BK;
    const int ky = tap / 3, kx = tap - ky * 3;
    float* a = As + st * A_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      long long pix;
      const bool in = tap_pixel(g, rows[i], ky, kx, pix);
      cp_async16(a + (arow + 64 * i) * ALD + acol, in ? x + pix * g.C + c0 + acol : x,
                 in ? 16 : 0);
    }
    float* b = Bs + st * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = brow + 8 * i;
      cp_async16(b + k * BLD + bcol,
                 w + (static_cast<long long>(tap) * g.C + c0 + k) * g.co + n0 + bcol, 16);
    }
  };

  // thread (ty, tx): pixels ty + 16 i, channels 4 tx + 64 j + q
  const int ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nsteps; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < nsteps) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const float* a = As + (t % STAGES) * A_STAGE;
    const float* b = Bs + (t % STAGES) * B_STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = a[(ty + 16 * i) * ALD + k];
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * BLD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + k * BLD + tx * 4 + 64);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + tx * 4 + 64 * j;
      epilogue2(e, y, m, n, g.co, acc[i][4 * j], acc[i][4 * j + 1]);
      epilogue2(e, y, m, n + 2, g.co, acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
}

}  // namespace

// x [H, W, B, C], w [3, 3, C, co] (16-byte aligned, in the storage type);
// bias, alpha: fp32 [co] or null (alpha required for act 1); res, y, z:
// [H, W, B, co] in the storage type (res and z may be null). C % 32 == 0,
// co % 128 == 0.
extern "C" int rn_conv2d(const void* x, const void* w, const void* bias, const void* alpha,
                         const void* res, void* y, void* z, int dtype, int act, int H, int W,
                         int B, int C, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(H) * W * B;
  const long long mtiles = (M + BM - 1) / BM;
  if (C <= 0 || C % 32 || co <= 0 || co % BN || act < 0 || act > 2 || (act == 1 && !alpha) ||
      M <= 0 || mtiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{H, W, B, C, co, static_cast<int>(M)};
  const Epi e{static_cast<const float*>(bias), static_cast<const float*>(alpha), res, z, act};
  const dim3 grid(co / BN, static_cast<unsigned>(mtiles));
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(conv2d_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               f32::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv2d_f32_kernel<<<grid, NT, f32::SMEM, s>>>(static_cast<const float*>(x),
                                                  static_cast<const float*>(w),
                                                  static_cast<float*>(y), g, e);
  } else {
    err = cudaFuncSetAttribute(conv2d_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bf::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    conv2d_bf16_kernel<<<grid, NT, bf::SMEM, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                  static_cast<const __nv_bfloat16*>(w),
                                                  static_cast<__nv_bfloat16*>(y), g, e);
  }
  return static_cast<int>(cudaGetLastError());
}
