// K5w: weight gradient of K5's SAME, stride-1, 3x3 HWNC convolution:
//   gw[ky, kx, c, n] = sum over pixels (h, w, b) of
//                      xpad[h + ky, w + kx, b, c] * gz[h, w, b, n]
// x [H, W, B, C], gz [H, W, B, co], gw [3, 3, C, co] in fp32.
//
// Replaces rendernet_tpu/ops/pallas_conv2d.py:_wgrad_kernel (reached through
// pl.pallas_call in _wgrad, from the custom VJPs' backward). The TPU kernel
// sums into a pinned [3, 3, C, bn] VMEM block across its sequential
// (batch, row) grid; Hopper's blocks run in no order. So, as K2w does, the
// pixels are split into chunks: each block writes the fp32 partial sums of
// its chunk and a second kernel adds the chunks in a fixed order (no
// atomics: the result repeats bit for bit). The chunks also keep each
// fp32 accumulator's serial sum short, since its error grows with its
// length: on an H100, mma.sync's sum over one chunk of all 98,304 pixels
// of a batch-24 res2 step landed outside the 1e-4 of max|gw| that the
// kernel checks allow. So a chunk holds at most 8,192 pixels, and there
// are enough chunks for ~4 blocks per SM, unless the partials would pass
// 512 MiB (one fp32 [3, 3, 1024, 1024] is 37.7 MB; twelve are 0.45 GB).
// With one chunk the blocks write the result directly.
//
// As a GEMM: rows (tap, c) = 9 C, columns co, reduced over all H W B
// pixels (98,304 for the training step's res2 at batch 24). Bound:
// operations, 2 * H W B * 9 C * co flops (1.86e12 at res2, batch 24: 1.88
// ms at 989 TFLOP/s bf16). A block owns one tap, 128 input channels and
// 128 output channels over its chunk of pixels, and walks it 32 (bf16) or
// 16 (fp32) pixels a step: the shifted activation rows [32 x 128] (zero
// outside the image) and the cotangent rows [32 x 128], staged in shared
// memory with cp.async, several steps in flight.
//   * bf16: mma.sync m16n8k16; both operands are pixel-major in shared
//     memory, so ldmatrix.trans forms the fragments (A is x^T).
//   * fp32: CUDA-core FMAs; each thread owns 8 input x 8 output channels.
// Every input row is read 9 x co / 128 times and every cotangent row
// 9 x C / 128 times, mostly from L2.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;  // input channels (GEMM rows) per block
constexpr int BN = 128;  // output channels per block
constexpr int NT = 256;
constexpr long long TARGET_BLOCKS = 132 * 4;
constexpr long long MAX_PART_BYTES = 512LL << 20;
constexpr long long MAX_CHUNK_PIXELS = 8192;
constexpr long long MIN_CHUNK_PIXELS = 1024;

struct Geom {
  int H, W, B, C, co, M, nchunks;
};

using rn::cp_async16;
using rn::cp_async_commit;
using rn::cp_async_wait;
using rn::ldmatrix_x4_trans;
using rn::mma_bf16;

// Pixel p of [p_begin, p_end) as tap (ky, kx) reads it: the source pixel,
// and whether p is in the chunk and the source inside the image.
__device__ __forceinline__ bool tap_source(const Geom& g, int p, int p_end, int ky, int kx,
                                           long long& src) {
  if (p >= p_end) return false;
  const int hw = p / g.B;
  const int w = hw % g.W, h = hw / g.W;
  const int hs = h + ky - 1, ws = w + kx - 1;
  src = p + (static_cast<long long>(ky - 1) * g.W + (kx - 1)) * g.B;
  return hs >= 0 && hs < g.H && ws >= 0 && ws < g.W;
}

// Block (n tile, (tap, c tile), chunk): its tap, first input channel,
// first output channel and pixel range.
struct Tile {
  int ky, kx, c0, n0, p_begin, p_end;
  long long out;  // offset of gw[tap][c0][n0] in the partial sums
};

__device__ __forceinline__ Tile tile_of(const Geom& g) {
  Tile t;
  const int ctiles = g.C / BM;
  const int tap = blockIdx.y / ctiles;
  t.ky = tap / 3;
  t.kx = tap - t.ky * 3;
  t.c0 = (blockIdx.y - tap * ctiles) * BM;
  t.n0 = blockIdx.x * BN;
  const int chunk = blockIdx.z;
  t.p_begin = static_cast<int>(static_cast<long long>(g.M) * chunk / g.nchunks);
  t.p_end = static_cast<int>(static_cast<long long>(g.M) * (chunk + 1) / g.nchunks);
  t.out = (static_cast<long long>(chunk) * 9 * g.C + static_cast<long long>(tap) * g.C + t.c0) *
              g.co + t.n0;
  return t;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16
// ---------------------------------------------------------------------------
namespace bf {
constexpr int BK = 32, STAGES = 4, LD = 128 + 8;
constexpr int STAGE = BK * LD;  // elements of one operand's step
constexpr int SMEM = STAGES * 2 * STAGE * 2;
}  // namespace bf

__global__ void __launch_bounds__(NT, 2) wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                           const __nv_bfloat16* __restrict__ gz,
                                                           float* __restrict__ part, Geom g) {
  using namespace bf;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BK pixels][LD]
  __nv_bfloat16* Gs = Xs + STAGES * STAGE;                      // [STAGES][BK pixels][LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Tile tl = tile_of(g);
  const int nsteps = (tl.p_end - tl.p_begin + BK - 1) / BK;
  const int prow = tid >> 4, col = (tid & 15) * 8;

  auto load = [&](int t, int st) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = prow + 16 * i;
      const int p = tl.p_begin + t * BK + r;
      long long src = 0;
      const bool in = tap_source(g, p, tl.p_end, tl.ky, tl.kx, src);
      cp_async16(Xs + st * STAGE + r * LD + col, in ? x + src * g.C + tl.c0 + col : x,
                 in ? 16 : 0);
      const bool gin = p < tl.p_end;
      cp_async16(Gs + st * STAGE + r * LD + col,
                 gin ? gz + static_cast<long long>(p) * g.co + tl.n0 + col : gz, gin ? 16 : 0);
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
    __syncthreads();
    if (t + STAGES - 1 < nsteps) load(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* a = Xs + (t % STAGES) * STAGE;
    const __nv_bfloat16* b = Gs + (t % STAGES) * STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[4][4], bfr[4][2];
      // A = x^T: rows are channels, k is pixels; stored pixel-major
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4_trans(af[mt], a + (kk + (lane & 7) + (lane >> 4) * 8) * LD + wm + mt * 16 +
                                      ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned r[4];
        ldmatrix_x4_trans(r, b + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + wn +
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

  const int gq = lane >> 2, tq = (lane & 3) * 2;
  float* dst = part + tl.out;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = wm + mt * 16 + gq + half * 8;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(dst + static_cast<long long>(c) * g.co + wn + nt * 8 + tq) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs
// ---------------------------------------------------------------------------
namespace f32 {
constexpr int BK = 16, STAGES = 3, LD = 128 + 4;
constexpr int STAGE = BK * LD;
constexpr int SMEM = STAGES * 2 * STAGE * 4;
}  // namespace f32

__global__ void __launch_bounds__(NT, 2) wgrad_f32_kernel(const float* __restrict__ x,
                                                          const float* __restrict__ gz,
                                                          float* __restrict__ part, Geom g) {
  using namespace f32;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);
  float* Gs = Xs + STAGES * STAGE;
  const int tid = threadIdx.x;
  const Tile tl = tile_of(g);
  const int nsteps = (tl.p_end - tl.p_begin + BK - 1) / BK;
  const int prow = tid >> 5, col = (tid & 31) * 4;

  auto load = [&](int t, int st) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = prow + 8 * i;
      const int p = tl.p_begin + t * BK + r;
      long long src = 0;
      const bool in = tap_source(g, p, tl.p_end, tl.ky, tl.kx, src);
      cp_async16(Xs + st * STAGE + r * LD + col, in ? x + src * g.C + tl.c0 + col : x,
                 in ? 16 : 0);
      const bool gin = p < tl.p_end;
      cp_async16(Gs + st * STAGE + r * LD + col,
                 gin ? gz + static_cast<long long>(p) * g.co + tl.n0 + col : gz, gin ? 16 : 0);
    }
  };

  // thread (ty, tx): input channels 4 ty + 64 i + q, output channels 4 tx + 64 j + q
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
    const float* a = Xs + (t % STAGES) * STAGE;
    const float* b = Gs + (t % STAGES) * STAGE;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * LD + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(a + k * LD + ty * 4 + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * LD + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(b + k * LD + tx * 4 + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* dst = part + tl.out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = ty * 4 + 64 * (i / 4) + (i % 4);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<float4*>(dst + static_cast<long long>(c) * g.co + tx * 4 + 64 * j) =
          make_float4(acc[i][4 * j], acc[i][4 * j + 1], acc[i][4 * j + 2], acc[i][4 * j + 3]);
  }
}

// out[i] = sum over chunks, in chunk order, of part[chunk][i].
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    long long n, int nchunks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s += part[k * n + i];
  out[i] = s;
}

int plan_chunks(int H, int W, int B, int C, int co) {
  const long long M = static_cast<long long>(H) * W * B;
  const long long tiles = 9LL * (C / BM) * (co / BN);
  const long long bytes = 9LL * C * co * 4;
  long long n = (TARGET_BLOCKS + tiles - 1) / tiles;
  n = n < M / MIN_CHUNK_PIXELS ? n : M / MIN_CHUNK_PIXELS;
  const long long n_short = (M + MAX_CHUNK_PIXELS - 1) / MAX_CHUNK_PIXELS;
  n = n > n_short ? n : n_short;
  n = n < MAX_PART_BYTES / bytes ? n : MAX_PART_BYTES / bytes;
  n = n < 65535 ? n : 65535;
  return static_cast<int>(n < 1 ? 1 : n);
}

}  // namespace

// The chunk count; with more than one the wrapper allocates a workspace
// of nchunks * 9 * C * co floats.
extern "C" int rn_conv2d_wgrad_chunks(int H, int W, int B, int C, int co) {
  return plan_chunks(H, W, B, C, co);
}

// x [H, W, B, C], gz [H, W, B, co] (one storage type, 16-byte aligned);
// part: the workspace (unused with one chunk); out [3, 3, C, co] fp32.
// C % 128 == 0, co % 128 == 0.
extern "C" int rn_conv2d_wgrad(const void* x, const void* gz, void* part, void* out, int dtype,
                               int H, int W, int B, int C, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(H) * W * B;
  if (C <= 0 || C % BM || co <= 0 || co % BN || M <= 0 || M >= (1LL << 31) ||
      9LL * (C / BM) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nchunks = plan_chunks(H, W, B, C, co);
  const Geom g{H, W, B, C, co, static_cast<int>(M), nchunks};
  float* dst = static_cast<float*>(nchunks > 1 ? part : out);
  const dim3 grid(co / BN, 9 * (C / BM), nchunks);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               f32::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgrad_f32_kernel<<<grid, NT, f32::SMEM, s>>>(static_cast<const float*>(x),
                                                 static_cast<const float*>(gz), dst, g);
  } else {
    err = cudaFuncSetAttribute(wgrad_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bf::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgrad_bf16_kernel<<<grid, NT, bf::SMEM, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const __nv_bfloat16*>(gz), dst, g);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return static_cast<int>(err);
  const long long n = 9LL * C * co;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, nchunks);
  return static_cast<int>(cudaGetLastError());
}
