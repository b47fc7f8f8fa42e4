// K2: SAME, stride-1, 3x3x3 convolution, channels last, for the narrow
// (16/32/64 output channel) 3D stack: [B, H, W, D, C] @ [3, 3, 3, C, co].
//
// Replaces rendernet_tpu/ops/pallas_conv3d.py:_fwd_kernel (reached through
// pl.pallas_call in _conv_call, entry nc_conv3d). The TPU kernel packs
// 128/co depth positions into the MXU's 128 lanes (_pack_mid, _pack_combo,
// _combo_view); that packing only fills a TPU systolic array and is not
// carried over. This kernel is a channels-last implicit GEMM:
// M = output positions, N = co, K = 27 * C, fp32 accumulation.
//
// Bound: operations. 2 * M * co * 27 * C flops (a 32 -> 32 res1 conv at
// batch 8 on 64 x 64 x 32: 5.8e10 flops, 59 us at 989 TFLOP/s bf16; 0.87 ms
// at 67 TFLOP/s fp32), against ~34 MB of traffic (10 us). A block owns one
// (b, h), 4 positions along W and 16 along D, and all co. It walks C in
// chunks and stages the 3 x 6 x 18 halo tile of each chunk in shared memory,
// so the 27 taps read shared memory and each input value is read from
// device memory ~5x (halo) instead of 27x.
//   * bf16: tensor cores through WMMA 16x16x16 fragments. Warp i computes
//     the 16 D-positions at W-offset i; for tap (kh, kw, kd) its A fragment
//     is 16 consecutive halo rows (d + kd) of 16 channels, a plain
//     row-major tile of the staged halo, and its B fragments come from the
//     chunk's weights, staged in shared memory beside the halo (zero-padded
//     by the wrapper to a channel count that is a multiple of 16). Both are
//     copied with 16-byte loads.
//   * fp32: CUDA-core FMAs. Each thread owns one position and co/4 output
//     channels in registers; the weights of the chunk sit in shared memory
//     and every warp reads the same weight (a broadcast).
// Bias stays outside the kernel, as in the reference's layer.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 4;    // output positions along W per block
constexpr int TD = 16;   // output positions along D per block
constexpr int HW = TW + 2, HD = TD + 2;

struct Geom {
  int H, W, D, C, Cp;
};

__device__ __forceinline__ long long pix(const Geom& g, int b, int h, int w, int d) {
  return ((static_cast<long long>(b) * g.H + h) * g.W + w) * g.D + d;
}

// bf16 tensor-core kernel: 128 threads, NF = co / 16 fragments per warp.
// Dynamic shared memory: the halo tile xs[3][HW][HD][CK] and the chunk's
// weights ws[27][CK][co + 8] (row stride padded against bank conflicts);
// the epilogue's fp32 tile os[4 warps][16][co + 4] reuses the same bytes.
template <int NF>
constexpr int bf16_smem_bytes() {
  const int main = 2 * (3 * HW * HD * 16 + 27 * 16 * (NF * 16 + 8));
  const int epi = 4 * 4 * 16 * (NF * 16 + 4);
  return main > epi ? main : epi;
}

template <int NF>
__global__ void __launch_bounds__(128) conv3d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                          const __nv_bfloat16* __restrict__ w,
                                                          __nv_bfloat16* __restrict__ y,
                                                          Geom g) {
  constexpr int CK = 16, CO = NF * 16, WLD = CO + 8, OLD = CO + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = xs + 3 * HW * HD * CK;
  float* os = reinterpret_cast<float*>(smem);
  const int ndt = (g.D + TD - 1) / TD;
  const int w0 = (blockIdx.x / ndt) * TW, d0 = (blockIdx.x % ndt) * TD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[j], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;

  for (int c0 = 0; c0 < g.Cp; c0 += CK) {
    if (g.C % 8 == 0) {  // 16-byte loads of 8 channels
      for (int i = tid; i < 3 * HW * HD * 2; i += 128) {
        const int c = (i % 2) * 8, p = i / 2;
        const int dd = p % HD, ww = (p / HD) % HW, kh = p / (HD * HW);
        const int hh = h + kh - 1, wi = w0 + ww - 1, di = d0 + dd - 1;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (hh >= 0 && hh < g.H && wi >= 0 && wi < g.W && di >= 0 && di < g.D && c0 + c < g.C)
          v = *reinterpret_cast<const uint4*>(x + pix(g, b, hh, wi, di) * g.C + c0 + c);
        *reinterpret_cast<uint4*>(xs + p * CK + c) = v;
      }
    } else {
      for (int i = tid; i < 3 * HW * HD * CK; i += 128) {
        const int c = i % CK, dd = (i / CK) % HD, ww = (i / (CK * HD)) % HW, kh = i / (CK * HD * HW);
        const int hh = h + kh - 1, wi = w0 + ww - 1, di = d0 + dd - 1;
        __nv_bfloat16 v = __float2bfloat16_rn(0.f);
        if (hh >= 0 && hh < g.H && wi >= 0 && wi < g.W && di >= 0 && di < g.D && c0 + c < g.C)
          v = x[pix(g, b, hh, wi, di) * g.C + c0 + c];
        xs[i] = v;
      }
    }
    for (int i = tid; i < 27 * CK * CO / 8; i += 128) {
      const int e = i * 8;
      const int n = e % CO, c = (e / CO) % CK, tap = e / (CO * CK);
      *reinterpret_cast<uint4*>(ws + (tap * CK + c) * WLD + n) =
          *reinterpret_cast<const uint4*>(w + (static_cast<long long>(tap) * g.Cp + c0 + c) * CO + n);
    }
    __syncthreads();
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          wmma::load_matrix_sync(a, xs + ((kh * HW + warp + kw) * HD + kd) * CK, CK);
          const int tap = (kh * 3 + kw) * 3 + kd;
#pragma unroll
          for (int j = 0; j < NF; ++j) {
            wmma::load_matrix_sync(bm, ws + tap * CK * WLD + j * 16, WLD);
            wmma::mma_sync(acc[j], a, bm, acc[j]);
          }
        }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
    wmma::store_matrix_sync(os + warp * 16 * OLD + j * 16, acc[j], OLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < 4 * 16 * CO; i += 128) {
    const int n = i % CO, dd = (i / CO) % 16, wi = i / (CO * 16);
    const int wo = w0 + wi, dO = d0 + dd;
    if (wo < g.W && dO < g.D)
      y[pix(g, b, h, wo, dO) * CO + n] = __float2bfloat16_rn(os[(wi * 16 + dd) * OLD + n]);
  }
}

template <int NF>
void launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, __nv_bfloat16* y,
                 const Geom& g, dim3 grid, cudaStream_t s) {
  constexpr int smem = bf16_smem_bytes<NF>();
  if (cudaFuncSetAttribute(conv3d_bf16_kernel<NF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return;  // the error stays pending for cudaGetLastError()
  conv3d_bf16_kernel<NF><<<grid, 128, smem, s>>>(x, w, y, g);
}

// fp32 CUDA-core kernel: 256 threads; thread = (position p, channel group ng).
template <int CO>
__global__ void __launch_bounds__(256) conv3d_f32_kernel(const float* __restrict__ x,
                                                         const float* __restrict__ w,
                                                         float* __restrict__ y, Geom g) {
  constexpr int CK = 4, NPT = CO / 4;
  __shared__ float xs[3 * HW * CK * HD];  // [kh][w][c][d]: consecutive d, consecutive banks
  __shared__ float ws[27 * CK * CO];      // [tap][c][n]
  const int ndt = (g.D + TD - 1) / TD;
  const int w0 = (blockIdx.x / ndt) * TW, d0 = (blockIdx.x % ndt) * TD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int p = tid % 64, ng = tid / 64;
  const int wi = p / TD, dd = p % TD;

  float acc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < g.Cp; c0 += CK) {
    for (int i = tid; i < 3 * HW * CK * HD; i += 256) {
      const int di = i % HD, c = (i / HD) % CK, ww = (i / (HD * CK)) % HW, kh = i / (HD * CK * HW);
      const int hh = h + kh - 1, wx = w0 + ww - 1, dx = d0 + di - 1;
      float v = 0.f;
      if (hh >= 0 && hh < g.H && wx >= 0 && wx < g.W && dx >= 0 && dx < g.D && c0 + c < g.C)
        v = x[pix(g, b, hh, wx, dx) * g.C + c0 + c];
      xs[i] = v;
    }
    for (int i = tid; i < 27 * CK * CO; i += 256) {
      const int n = i % CO, c = (i / CO) % CK, tap = i / (CO * CK);
      ws[i] = w[(static_cast<long long>(tap) * g.Cp + c0 + c) * CO + n];
    }
    __syncthreads();
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh)
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int kd = 0; kd < 3; ++kd)
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            const float av = xs[((kh * HW + wi + kw) * CK + c) * HD + dd + kd];
            const float* wr = ws + (((kh * 3 + kw) * 3 + kd) * CK + c) * CO + ng * NPT;
#pragma unroll
            for (int j = 0; j < NPT; ++j) acc[j] = fmaf(av, wr[j], acc[j]);
          }
    __syncthreads();
  }
  const int wo = w0 + wi, dO = d0 + dd;
  if (wo < g.W && dO < g.D) {
    float* out = y + pix(g, b, h, wo, dO) * CO + ng * NPT;
#pragma unroll
    for (int j = 0; j < NPT; ++j) out[j] = acc[j];
  }
}

}  // namespace

// x [B, H, W, D, C]; w [27, Cp, co] with Cp = C rounded up to 16 and zero
// rows past C; y [B, H, W, D, co]; co in {16, 32, 64}.
extern "C" int rn_conv3d(const void* x, const void* w, void* y, int dtype, int B, int H,
                         int W, int D, int C, int Cp, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{H, W, D, C, Cp};
  const dim3 grid(((W + TW - 1) / TW) * ((D + TD - 1) / TD), H, B);
  if (co != 16 && co != 32 && co != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto yf = static_cast<float*>(y);
    if (co == 16) conv3d_f32_kernel<16><<<grid, 256, 0, s>>>(xf, wf, yf, g);
    if (co == 32) conv3d_f32_kernel<32><<<grid, 256, 0, s>>>(xf, wf, yf, g);
    if (co == 64) conv3d_f32_kernel<64><<<grid, 256, 0, s>>>(xf, wf, yf, g);
  } else {
    auto xb = static_cast<const __nv_bfloat16*>(x);
    auto wb = static_cast<const __nv_bfloat16*>(w);
    auto yb = static_cast<__nv_bfloat16*>(y);
    if (co == 16) launch_bf16<1>(xb, wb, yb, g, grid, s);
    if (co == 32) launch_bf16<2>(xb, wb, yb, g, grid, s);
    if (co == 64) launch_bf16<4>(xb, wb, yb, g, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}
