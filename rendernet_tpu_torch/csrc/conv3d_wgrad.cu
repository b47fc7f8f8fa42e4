// K2w: weight gradient of the SAME, stride-1, 3x3x3 channels-last conv (K2):
//   gw[kh, kw, kd, c, o] = sum over (b, h, w, d) of
//                          xpad[b, h + kh, w + kw, d + kd, c] * gy[b, h, w, d, o]
// with fp32 accumulation, for co in {16, 32, 64}.
//
// Replaces rendernet_tpu/ops/pallas_conv3d.py:_wgrad_kernel (reached through
// pl.pallas_call in _nc_bwd). The TPU kernel carries the [3, 3, f*C, 128]
// sums across its sequential grid in pinned VMEM and works on depth-packed
// operands (_pack_mid, _pack_combo), a device of the MXU's 128 lanes. Here
// the blocks run in no order, so the positions are split into chunks: each
// block writes fp32 partial sums of its chunk, and a second kernel adds the
// chunks in a fixed order (no atomics), so the result is the same on every
// run.
//
// As a GEMM: M = 27 * C, N = co, and the reduction runs over all B*H*W*D
// positions (3.1 M at res1, batch 24). Bound: operations, 2 * 27 * C * co
// flops per position (174 GFLOP at res1 batch 24 with C = co = 32: 0.18 ms
// at 989 TFLOP/s bf16) against ~0.4 GB of reads. A block owns one kh, a
// slice of the input channels and all co, and walks its chunk of position
// tiles (one (b, h), 4 positions along W, 16 along D, as K2's forward
// tile). Per tile it stages the 6 x 18 halo rows of its kh and the gy tile
// in shared memory; the 9 (kw, kd) taps then read shared memory only.
//   * bf16: tensor cores through WMMA 16x16x16. A fragment of x^T is 16
//     channels x 16 consecutive D positions of the halo (column-major
//     view of the staged rows), its B fragment the same 16 positions x 16
//     output channels of gy. 9 taps x (channels / 16) x (co / 16)
//     accumulator fragments per block, spread over its 4 warps.
//   * fp32: CUDA-core FMAs. A thread owns one input channel, co / 16
//     output channels and all 9 taps of the block's kh in registers.
// Each block stages x once per tile for its kh, in 16-byte loads, so x is
// read ~5x (3 kh x the halo) and gy 3x per channel slice; the staging is
// not pipelined. Both are the places to start making it faster.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 4, TD = 16;  // positions of a tile along W and D
constexpr int HW = TW + 2, HD = TD + 2;
constexpr int TARGET_BLOCKS = 132 * 8;  // chunks are sized for ~8 blocks per SM

struct Geom {
  int H, W, D, C, co, cpad;
  long long ntiles;  // B * H * ceil(W / TW) * ceil(D / TD)
  int nchunks;
};

__device__ __forceinline__ long long pix(const Geom& g, int b, int h, int w, int d) {
  return ((static_cast<long long>(b) * g.H + h) * g.W + w) * g.D + d;
}

// Tile t -> (b, h, w0, d0).
__device__ __forceinline__ void tile_origin(const Geom& g, long long t, int& b, int& h, int& w0,
                                            int& d0) {
  const int ndt = (g.D + TD - 1) / TD, nwt = (g.W + TW - 1) / TW;
  d0 = static_cast<int>(t % ndt) * TD;
  t /= ndt;
  w0 = static_cast<int>(t % nwt) * TW;
  t /= nwt;
  h = static_cast<int>(t % g.H);
  b = static_cast<int>(t / g.H);
}

// Stage the kh halo rows xs[HW][HD][CB] (zero outside the volume and past
// C) and the gy tile gs[TW * TD][co] (zero past W and D), in 16-byte
// vectors of V = 16 / sizeof(T) channels (x: when C % V == 0; gy always,
// since co is a multiple of 16), else element by element.
template <typename T, int CB>
__device__ __forceinline__ void stage(const Geom& g, const T* __restrict__ x,
                                      const T* __restrict__ gy, T* xs, T* gs, int b, int h,
                                      int w0, int d0, int kh, int c0, int tid, int nthreads) {
  constexpr int V = 16 / sizeof(T);
  const int hh = h + kh - 1;
  const bool hin = hh >= 0 && hh < g.H;
  if (g.C % V == 0) {
    for (int i = tid; i < HW * HD * CB / V; i += nthreads) {
      const int c = (i % (CB / V)) * V, p = i / (CB / V);
      const int dd = p % HD, ww = p / HD;
      const int wi = w0 + ww - 1, di = d0 + dd - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && c0 + c < g.C)
        v = *reinterpret_cast<const uint4*>(x + pix(g, b, hh, wi, di) * g.C + c0 + c);
      *reinterpret_cast<uint4*>(xs + p * CB + c) = v;
    }
  } else {
    for (int i = tid; i < HW * HD * CB; i += nthreads) {
      const int c = i % CB, dd = (i / CB) % HD, ww = i / (CB * HD);
      const int wi = w0 + ww - 1, di = d0 + dd - 1;
      T v = rn::from_f32<T>(0.f);
      if (hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && c0 + c < g.C)
        v = x[pix(g, b, hh, wi, di) * g.C + c0 + c];
      xs[i] = v;
    }
  }
  for (int i = tid; i < TW * TD * g.co / V; i += nthreads) {
    const int o = (i % (g.co / V)) * V, p = i / (g.co / V);
    const int dd = p % TD, ww = p / TD;
    const int wo = w0 + ww, dO = d0 + dd;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (wo < g.W && dO < g.D) v = *reinterpret_cast<const uint4*>(gy + pix(g, b, h, wo, dO) * g.co + o);
    *reinterpret_cast<uint4*>(gs + p * g.co + o) = v;
  }
}

// bf16 tensor-core kernel: 128 threads. NF = co / 16 output fragments, CM
// channel fragments (CB = 16 * CM input channels per block). Grid: (chunk,
// kh, channel slice). Partial sums: part[chunk][27][cpad][co] in fp32.
template <int NF, int CM>
__global__ void __launch_bounds__(128, 4) wgrad_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                                         const __nv_bfloat16* __restrict__ gy,
                                                         float* __restrict__ part, Geom g) {
  constexpr int CB = 16 * CM, CO = 16 * NF;
  constexpr int NFRAG = 9 * CM * NF;          // (tap, channel fragment, output fragment)
  constexpr int PER_WARP = (NFRAG + 3) / 4;
  __shared__ __align__(128) __nv_bfloat16 xs[HW * HD * CB];
  __shared__ __align__(128) __nv_bfloat16 gs[TW * TD * CO];
  const int chunk = blockIdx.x, kh = blockIdx.y, c0 = blockIdx.z * CB;
  const int tid = threadIdx.x, warp = tid / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER_WARP];
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) wmma::fill_fragment(acc[i], 0.f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bm;

  const long long t0 = g.ntiles * chunk / g.nchunks, t1 = g.ntiles * (chunk + 1) / g.nchunks;
  for (long long t = t0; t < t1; ++t) {
    int b, h, w0, d0;
    tile_origin(g, t, b, h, w0, d0);
    stage<__nv_bfloat16, CB>(g, x, gy, xs, gs, b, h, w0, d0, kh, c0, tid, 128);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < PER_WARP; ++i) {
      const int f = warp + 4 * i;
      if (f < NFRAG) {
        const int n = f % NF, cm = (f / NF) % CM, tap = f / (NF * CM);
        const int kw = tap / 3, kd = tap % 3;
#pragma unroll
        for (int wi = 0; wi < TW; ++wi) {
          // A(c, p) = x[w0 + wi + kw - 1, d0 + p + kd - 1, c0 + 16 cm + c]
          wmma::load_matrix_sync(a, xs + ((wi + kw) * HD + kd) * CB + cm * 16, CB);
          wmma::load_matrix_sync(bm, gs + wi * TD * CO + n * 16, CO);
          wmma::mma_sync(acc[i], a, bm, acc[i]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int f = warp + 4 * i;
    if (f < NFRAG) {
      const int n = f % NF, cm = (f / NF) % CM, tap = f / (NF * CM);
      float* dst = part + ((static_cast<long long>(chunk) * 27 + kh * 9 + tap) * g.cpad + c0 +
                           cm * 16) * CO + n * 16;
      wmma::store_matrix_sync(dst, acc[i], CO, wmma::mem_row_major);
    }
  }
}

// fp32 CUDA-core kernel: 256 threads = (channel c in 16) x (output group og
// in 16); a thread owns outputs og + 16 j, j < co / 16, for all 9 taps.
template <int CO>
__global__ void __launch_bounds__(256) wgrad_f32_kernel(const float* __restrict__ x,
                                                        const float* __restrict__ gy,
                                                        float* __restrict__ part, Geom g) {
  constexpr int CB = 16, NO = CO / 16;
  __shared__ __align__(16) float xs[HW * HD * CB];
  __shared__ __align__(16) float gs[TW * TD * CO];
  const int chunk = blockIdx.x, kh = blockIdx.y, c0 = blockIdx.z * CB;
  const int tid = threadIdx.x, c = tid % CB, og = tid / CB;

  float acc[9][NO];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < NO; ++j) acc[tap][j] = 0.f;

  const long long t0 = g.ntiles * chunk / g.nchunks, t1 = g.ntiles * (chunk + 1) / g.nchunks;
  for (long long t = t0; t < t1; ++t) {
    int b, h, w0, d0;
    tile_origin(g, t, b, h, w0, d0);
    stage<float, CB>(g, x, gy, xs, gs, b, h, w0, d0, kh, c0, tid, 256);
    __syncthreads();
#pragma unroll 1
    for (int wi = 0; wi < TW; ++wi)
#pragma unroll 2
      for (int dd = 0; dd < TD; ++dd) {
        float gv[NO];
#pragma unroll
        for (int j = 0; j < NO; ++j) gv[j] = gs[(wi * TD + dd) * CO + og + 16 * j];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
#pragma unroll
          for (int kd = 0; kd < 3; ++kd) {
            const float xv = xs[((wi + kw) * HD + dd + kd) * CB + c];
#pragma unroll
            for (int j = 0; j < NO; ++j) acc[kw * 3 + kd][j] = fmaf(xv, gv[j], acc[kw * 3 + kd][j]);
          }
      }
    __syncthreads();
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < NO; ++j)
      part[((static_cast<long long>(chunk) * 27 + kh * 9 + tap) * g.cpad + c0 + c) * CO + og +
           16 * j] = acc[tap][j];
}

// out[tap][c][o] = sum over chunks, in chunk order, of part[chunk][tap][c][o]
// for c < C.
__global__ void wgrad_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int C, int cpad, int co, int nchunks) {
  const long long n = 27LL * C * co;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int o = static_cast<int>(i % co);
  const int c = static_cast<int>((i / co) % C);
  const int tap = static_cast<int>(i / (static_cast<long long>(co) * C));
  const long long stride = 27LL * cpad * co;
  const float* p = part + (static_cast<long long>(tap) * cpad + c) * co + o;
  float s = 0.f;
  for (int k = 0; k < nchunks; ++k) s += p[k * stride];
  out[i] = s;
}

// Channels per block: bf16 keeps 9 * CM * NF = 9 * 4 fragments at most
// (CM = 4 / NF), and no more channel fragments than C needs; fp32 takes 16.
int channels_per_block(int dtype, int C, int co) {
  if (dtype == 0) return 16;
  int cm = 4 / (co / 16);
  const int need = (C + 15) / 16;
  while (cm > 1 && cm / 2 >= need) cm /= 2;
  return 16 * cm;
}

void plan(int dtype, int B, int H, int W, int D, int C, int co, int* nchunks, int* cpad) {
  const int cb = channels_per_block(dtype, C, co);
  const int nslices = (C + cb - 1) / cb;
  const long long ntiles =
      static_cast<long long>(B) * H * ((W + TW - 1) / TW) * ((D + TD - 1) / TD);
  long long n = (TARGET_BLOCKS + 3LL * nslices - 1) / (3LL * nslices);
  if (n > ntiles) n = ntiles;
  *nchunks = static_cast<int>(n < 1 ? 1 : n);
  *cpad = nslices * cb;
}

template <int NF, int CM>
void launch_bf16(const void* x, const void* gy, float* part, const Geom& g, int nslices,
                 cudaStream_t s) {
  const dim3 grid(g.nchunks, 3, nslices);
  wgrad_bf16_kernel<NF, CM><<<grid, 128, 0, s>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const __nv_bfloat16*>(gy), part,
                                                 g);
}

}  // namespace

// The partial-sum workspace the wrapper allocates: nchunks * 27 * cpad * co
// floats.
extern "C" void rn_conv3d_wgrad_plan(int dtype, int B, int H, int W, int D, int C, int co,
                                     int* nchunks, int* cpad) {
  plan(dtype, B, H, W, D, C, co, nchunks, cpad);
}

// x [B, H, W, D, C], gy [B, H, W, D, co] (one storage type); part: the
// workspace of rn_conv3d_wgrad_plan; out [27, C, co] fp32.
extern "C" int rn_conv3d_wgrad(const void* x, const void* gy, void* part, void* out, int dtype,
                               int B, int H, int W, int D, int C, int co, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co != 16 && co != 32 && co != 64) return static_cast<int>(cudaErrorInvalidValue);
  int nchunks, cpad;
  plan(dtype, B, H, W, D, C, co, &nchunks, &cpad);
  const int cb = channels_per_block(dtype, C, co);
  const Geom g{H, W, D, C, co, cpad,
               static_cast<long long>(B) * H * ((W + TW - 1) / TW) * ((D + TD - 1) / TD),
               nchunks};
  const int nslices = cpad / cb;
  float* pf = static_cast<float*>(part);
  if (dtype == 0) {
    const dim3 grid(nchunks, 3, nslices);
    auto xf = static_cast<const float*>(x);
    auto gf = static_cast<const float*>(gy);
    if (co == 16) wgrad_f32_kernel<16><<<grid, 256, 0, s>>>(xf, gf, pf, g);
    if (co == 32) wgrad_f32_kernel<32><<<grid, 256, 0, s>>>(xf, gf, pf, g);
    if (co == 64) wgrad_f32_kernel<64><<<grid, 256, 0, s>>>(xf, gf, pf, g);
  } else {
    const int cm = cb / 16;
    if (co == 16 && cm == 4) launch_bf16<1, 4>(x, gy, pf, g, nslices, s);
    if (co == 16 && cm == 2) launch_bf16<1, 2>(x, gy, pf, g, nslices, s);
    if (co == 16 && cm == 1) launch_bf16<1, 1>(x, gy, pf, g, nslices, s);
    if (co == 32 && cm == 2) launch_bf16<2, 2>(x, gy, pf, g, nslices, s);
    if (co == 32 && cm == 1) launch_bf16<2, 1>(x, gy, pf, g, nslices, s);
    if (co == 64) launch_bf16<4, 1>(x, gy, pf, g, nslices, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 27LL * C * co;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      pf, static_cast<float*>(out), C, cpad, co, nchunks);
  return static_cast<int>(cudaGetLastError());
}
