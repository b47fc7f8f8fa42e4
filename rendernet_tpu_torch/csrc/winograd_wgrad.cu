// K6: transform-domain weight gradient of the Winograd F(2x2, 3x3) conv
// (K3), SAME, stride 1, NHWC:
//   gU[f, c, k] = sum over 2x2 output tiles of V[f, tile, c] * dM[f, tile, k]
// for the 16 frequencies f, where V = B^T d B is K3's input transform of
// the tile's 4x4 input patch (fp32, then cast to the operand type) and dM
// spreads the tile's 2x2 block of gy over the 16 frequencies through A
// (the adjoint of K3's inverse transform; fp32, then cast). The fold
// gw = G^T gU G to [3, 3, C, K] is a small fp32 einsum in the wrapper.
//
// Replaces rendernet_tpu/ops/pallas_winograd.py:_wgrad_kernel (reached
// through pl.pallas_call in _wino_wgrad). The TPU kernel pins the whole
// [16, C, bnk] fp32 gU block in VMEM across its sequential (batch,
// tile-row) grid. An SM cannot hold 16 x C x K accumulators, so here a
// block owns all 16 frequencies of a 32 x 32 (C, K) tile over a slice of
// the tile rows, and writes fp32 partial sums when there is more than one
// slice; a second kernel adds the slices in a fixed order (no atomics),
// so the result is the same on every run.
//
// Bound: operations, 2 * 16 * tiles * C * K flops (res2 at batch 24:
// 24576 tiles, C = K = 1024, 0.82 TFLOP, 0.83 ms at 989 TFLOP/s bf16;
// 12.3 ms at 67 TFLOP/s fp32), 2.25x fewer than the direct weight gradient.
// Per step a block takes one row of up to 32 tiles (fixed b and tile row):
// it copies the 4 input rows and 2 cotangent rows those tiles read into
// shared memory in 16-byte loads; each thread then computes V for (tile,
// channel) pairs and dM for (tile, output channel) pairs from there, and
//   * bf16 operands (WGRAD=True with bf16 activations): tensor cores, WMMA
//     16x16x16; warp w owns frequencies 2w and 2w+1, each a 2 x 2 grid of
//     accumulator fragments over the 32 x 32 tile;
//   * fp32 operands (WGRAD="fp32", or fp32 activations): CUDA-core FMAs; a
//     thread owns 4 frequencies x 4 channels x 4 output channels.
// V is recomputed once per 32 output channels and dM once per 32 input
// channels, and the copies are not pipelined; those are the places to start
// making it faster.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TT = 32;   // tiles per step (along W)
constexpr int CT = 32;   // input channels per block
constexpr int KT = 32;   // output channels per block
constexpr int NT = 256;  // threads per block
constexpr int TARGET_BLOCKS = 132 * 4;
// Row strides (elements) of the staged V [16][TT][LD] and dM [16][TT][LD]:
// padded for the tensor-core path so that the 8-row fragment loads are
// free of bank conflicts, unpadded (float4 reads) for the fp32 path.
constexpr int LD_TC = CT + 8;
constexpr int LD_F32 = CT;
static_assert(CT == KT, "V and dM share one row stride");

constexpr int XC = 2 * TT + 2;  // input columns a step's tiles read

// Shared memory: V and dM [16][TT][LD] in the operand type, then the
// step's input rows xs[4][XC][CT] and cotangent rows gs[2][2 TT][KT] in the
// storage type.
template <typename T, bool TC>
constexpr size_t smem_bytes() {
  return (TC ? 2 * 16 * TT * LD_TC * sizeof(__nv_bfloat16) : 2 * 16 * TT * LD_F32 * sizeof(float))
         + (4 * XC * CT + 2 * 2 * TT * KT) * sizeof(T);
}

struct Geom {
  int H, W, C, K;
  long long nsteps;  // B * (H / 2) * ceil((W / 2) / TT)
  int nslices;
};

template <typename T, bool TC>
__global__ void __launch_bounds__(NT) wino_wgrad_kernel(const T* __restrict__ x,
                                                        const T* __restrict__ gy,
                                                        float* __restrict__ dst, Geom g) {
  using Op = typename std::conditional<TC, __nv_bfloat16, float>::type;
  constexpr int LD = TC ? LD_TC : LD_F32;
  extern __shared__ __align__(128) unsigned char smem[];
  Op* vs = reinterpret_cast<Op*>(smem);  // [16][TT][LD]
  Op* ds = vs + 16 * TT * LD;            // [16][TT][LD]
  T* xs = reinterpret_cast<T*>(ds + 16 * TT * LD);  // [4][XC][CT]
  T* gs = xs + 4 * XC * CT;                          // [2][2 TT][KT]
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte copy

  const int nkt = g.K / KT;
  const int c0 = (blockIdx.x / nkt) * CT, k0 = (blockIdx.x % nkt) * KT;
  const int slice = blockIdx.y;
  const int tid = threadIdx.x;
  const int nw = g.W / 2, ngroups = (nw + TT - 1) / TT;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[2][2][2];  // [f][ci][ki]
  float acc[4][4][4];                                                      // [f][c][k]
  if constexpr (TC) {
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc_tc[f][i][j], 0.f);
  } else {
#pragma unroll
    for (int f = 0; f < 4; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[f][i][j] = 0.f;
  }

  const long long s0 = g.nsteps * slice / g.nslices, s1 = g.nsteps * (slice + 1) / g.nslices;
  for (long long step = s0; step < s1; ++step) {
    const int tw0 = static_cast<int>(step % ngroups) * TT;
    const int th = static_cast<int>((step / ngroups) % (g.H / 2));
    const int b = static_cast<int>(step / (static_cast<long long>(ngroups) * (g.H / 2)));

    // Stage the step's 4 input rows (zero outside the image: the SAME
    // halo) and 2 cotangent rows, 16 bytes at a time.
    for (int i = tid; i < 4 * XC * CT / EPV; i += NT) {
      const int e = i * EPV;
      const int c = e % CT, col = (e / CT) % XC, r = e / (CT * XC);
      const int hh = 2 * th - 1 + r, ww = 2 * tw0 - 1 + col;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hh >= 0 && hh < g.H && ww >= 0 && ww < g.W)
        v = *reinterpret_cast<const uint4*>(
            x + ((static_cast<long long>(b) * g.H + hh) * g.W + ww) * g.C + c0 + c);
      *reinterpret_cast<uint4*>(xs + e) = v;
    }
    for (int i = tid; i < 2 * 2 * TT * KT / EPV; i += NT) {
      const int e = i * EPV;
      const int k = e % KT, col = (e / KT) % (2 * TT), r = e / (KT * 2 * TT);
      const int ww = 2 * tw0 + col;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ww < g.W)
        v = *reinterpret_cast<const uint4*>(
            gy + ((static_cast<long long>(b) * g.H + 2 * th + r) * g.W + ww) * g.K + k0 + k);
      *reinterpret_cast<uint4*>(gs + e) = v;
    }
    __syncthreads();
    // V = B^T d B for (tile t, channel c), in fp32 in the reference's
    // order (K3's input transform), cast to the operand type. A tile past
    // the image's last column gets a zero dM (its cotangent columns are
    // staged as zeros), so it adds nothing.
    for (int i = tid; i < TT * CT; i += NT) {
      const int t = i / CT, c = i % CT;
      float v[16];
      {
        float d[4][4], rt[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) d[r][s] = rn::to_f32(xs[(r * XC + 2 * t + s) * CT + c]);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          rt[0][s] = d[0][s] - d[2][s];
          rt[1][s] = d[1][s] + d[2][s];
          rt[2][s] = -d[1][s] + d[2][s];
          rt[3][s] = d[1][s] - d[3][s];
        }
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1) {
          v[k1 * 4 + 0] = rt[k1][0] - rt[k1][2];
          v[k1 * 4 + 1] = rt[k1][1] + rt[k1][2];
          v[k1 * 4 + 2] = -rt[k1][1] + rt[k1][2];
          v[k1 * 4 + 3] = rt[k1][1] - rt[k1][3];
        }
      }
#pragma unroll
      for (int f = 0; f < 16; ++f) vs[(f * TT + t) * LD + c] = rn::from_f32<Op>(v[f]);
    }
    // dM[k1 k2] = sum over (p1, p2) of A[p1, k1] A[p2, k2] gy[2 th + p1, 2 tw + p2],
    // p1 outer, in fp32, cast to the operand type.
    for (int i = tid; i < TT * KT; i += NT) {
      const int t = i / KT, k = i % KT;
      float gp[2][2];
#pragma unroll
      for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
        for (int p2 = 0; p2 < 2; ++p2)
          gp[p1][p2] = rn::to_f32(gs[(p1 * 2 * TT + 2 * t + p2) * KT + k]);
      // Columns of A^T = [[1, 1, 1, 0], [0, 1, -1, -1]] for k = 0..3.
      const float a0[4] = {1.f, 1.f, 1.f, 0.f}, a1[4] = {0.f, 1.f, -1.f, -1.f};
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1)
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) {
          float m = 0.f;
          if (a0[k1] * a0[k2] != 0.f) m += gp[0][0] * (a0[k1] * a0[k2]);
          if (a0[k1] * a1[k2] != 0.f) m += gp[0][1] * (a0[k1] * a1[k2]);
          if (a1[k1] * a0[k2] != 0.f) m += gp[1][0] * (a1[k1] * a0[k2]);
          if (a1[k1] * a1[k2] != 0.f) m += gp[1][1] * (a1[k1] * a1[k2]);
          ds[((k1 * 4 + k2) * TT + t) * LD + k] = rn::from_f32<Op>(m);
        }
    }
    __syncthreads();
    if constexpr (TC) {
      const int warp = tid / 32;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm[2];
#pragma unroll
      for (int fl = 0; fl < 2; ++fl) {
        const int f = 2 * warp + fl;
#pragma unroll
        for (int ks = 0; ks < TT / 16; ++ks) {
          // A(c, t) = V[f][t][c]: column-major; B(t, k) = dM[f][t][k]: row-major.
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            wmma::load_matrix_sync(a[i], vs + (f * TT + ks * 16) * LD + i * 16, LD);
            wmma::load_matrix_sync(bm[i], ds + (f * TT + ks * 16) * LD + i * 16, LD);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc_tc[fl][i][j], a[i], bm[j], acc_tc[fl][i][j]);
        }
      }
    } else {
      const int cg = tid % 8, kg = (tid / 8) % 8, fg = tid / 64;
      const float* vf = reinterpret_cast<const float*>(vs);
      const float* df = reinterpret_cast<const float*>(ds);
#pragma unroll 2
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int fl = 0; fl < 4; ++fl) {
          const int f = fg * 4 + fl;
          const float4 v4 = *reinterpret_cast<const float4*>(vf + (f * TT + t) * LD + cg * 4);
          const float4 d4 = *reinterpret_cast<const float4*>(df + (f * TT + t) * LD + kg * 4);
          const float vv[4] = {v4.x, v4.y, v4.z, v4.w}, dd[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[fl][i][j] = fmaf(vv[i], dd[j], acc[fl][i][j]);
        }
    }
    __syncthreads();  // the next step overwrites vs and ds
  }

  // dst [nslices][16][C][K]
  float* out = dst + static_cast<long long>(slice) * 16 * g.C * g.K;
  if constexpr (TC) {
    const int warp = tid / 32;
#pragma unroll
    for (int fl = 0; fl < 2; ++fl)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(
              out + (static_cast<long long>(2 * warp + fl) * g.C + c0 + i * 16) * g.K + k0 + j * 16,
              acc_tc[fl][i][j], g.K, wmma::mem_row_major);
  } else {
    const int cg = tid % 8, kg = (tid / 8) % 8, fg = tid / 64;
#pragma unroll
    for (int fl = 0; fl < 4; ++fl)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float4 r = make_float4(acc[fl][i][0], acc[fl][i][1], acc[fl][i][2], acc[fl][i][3]);
        *reinterpret_cast<float4*>(
            out + (static_cast<long long>(fg * 4 + fl) * g.C + c0 + cg * 4 + i) * g.K + k0 +
            kg * 4) = r;
      }
  }
}

// out[i] = sum over slices, in slice order, of part[slice][i].
__global__ void wino_wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                         long long n, int nslices) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nslices; ++k) s += part[k * n + i];
  out[i] = s;
}

long long steps_of(int B, int H, int W) {
  return static_cast<long long>(B) * (H / 2) * ((W / 2 + TT - 1) / TT);
}

int plan_slices(int B, int H, int W, int C, int K) {
  const long long tiles = static_cast<long long>(C / CT) * (K / KT);
  long long n = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long steps = steps_of(B, H, W);
  if (n > steps) n = steps;
  return static_cast<int>(n < 1 ? 1 : n);
}

template <typename T, bool TC>
int launch(const void* x, const void* gy, float* dst, const Geom& g, cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T, TC>();
  cudaError_t err = cudaFuncSetAttribute(wino_wgrad_kernel<T, TC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.C / CT) * (g.K / KT), g.nslices);
  wino_wgrad_kernel<T, TC><<<grid, NT, smem, s>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(gy), dst, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Slices of the tile rows, and so the partial-sum workspace the wrapper
// allocates: nslices * 16 * C * K floats when nslices > 1, none otherwise.
extern "C" int rn_wino_wgrad_slices(int B, int H, int W, int C, int K) {
  return plan_slices(B, H, W, C, K);
}

// x [B, H, W, C], gy [B, H, W, K] (one storage type); fp32_ops: 1 for fp32
// GEMM operands, 0 for the storage type's (bf16 storage only); part: the
// workspace (unused for one slice); gu [16, C, K] fp32. H, W even; C and K
// multiples of 32 (the wrapper's envelope guarantees them).
extern "C" int rn_wino_wgrad(const void* x, const void* gy, void* part, void* gu, int dtype,
                             int fp32_ops, int B, int H, int W, int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % 2 || W % 2 || C % CT || K % KT) return static_cast<int>(cudaErrorInvalidValue);
  const int nslices = plan_slices(B, H, W, C, K);
  const Geom g{H, W, C, K, steps_of(B, H, W), nslices};
  float* dst = static_cast<float*>(nslices > 1 ? part : gu);
  int rc;
  if (dtype == 0)
    rc = launch<float, false>(x, gy, dst, g, s);
  else if (fp32_ops)
    rc = launch<__nv_bfloat16, false>(x, gy, dst, g, s);
  else
    rc = launch<__nv_bfloat16, true>(x, gy, dst, g, s);
  if (rc != 0 || nslices == 1) return rc;
  const long long n = 16LL * C * K;
  wino_wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(gu), n, nslices);
  return static_cast<int>(cudaGetLastError());
}
