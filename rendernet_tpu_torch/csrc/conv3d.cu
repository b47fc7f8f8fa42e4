// K2: SAME, stride-1, 3x3x3 convolution, channels last, for the narrow
// (16/32/64 output channel) 3D stack: [B, H, W, D, C] @ [3, 3, 3, C, co].
// The data gradient runs the same kernel on the flipped, io-swapped weights.
//
// Replaces rendernet_tpu/ops/pallas_conv3d.py:_fwd_kernel (reached through
// pl.pallas_call in _conv_call, entry nc_conv3d). The TPU kernel packs
// 128/co depth positions into the MXU's 128 lanes (_pack_mid, _pack_combo,
// _combo_view); that packing only fills a TPU systolic array and is not
// carried over. This kernel is a channels-last implicit GEMM:
// M = output positions, N = co, K = 27 * C, fp32 accumulation.
//
// Bound: operations. 2 * M * co * 27 * C flops (a 32 -> 32 res1 conv at
// batch 24 on 64 x 64 x 32: 1.74e11 flops, 0.176 ms at 989 TFLOP/s bf16)
// against 0.40 GB of compulsory traffic (x in, y out: 0.12 ms).
//
// bf16, C <= 32 (every conv of the models): persistent CTAs, one per SM,
// 8 warps. A CTA loads the weights [27, C, co] into shared memory once
// (zero rows past C; 55 KB at 32 -> 32) and keeps them there while it walks
// its range of rows (conv3d_tile.cuh): per row, one output plane of 8 W x
// 32 D positions of one (b, h), from the three halo planes h - 1, h, h + 1
// of a cp.async ring (each plane loaded once per column). Warp i computes
// the 32 D positions at W offset i: for each tap (kh, kw, kd) and 16-channel
// chunk its A fragments are two 16-row ldmatrix loads of the halo plane kh
// at rows (i + kw, kd + ...), its B fragments ldmatrix.trans loads of the
// resident weights, and the products mma.sync m16n8k16 (bf16 in, fp32
// accumulate). mma.sync and not wgmma: the A rows shift by one position per
// kd, so A cannot be a wgmma shared-memory operand (its 8-row core matrices
// start on 16-byte rows of one swizzle atom), and from registers it would
// need a warpgroup-wide 64-row tile per (tap, chunk), four warps' lines at
// once, for no fewer shared-memory reads. The epilogue rounds the fp32 sums
// once to bf16 and stores them. Shared memory: 27 * 32 * co * 2 bytes of
// weights + 5 ring slots of 10 x 34 x 32 x 2 bytes (164 KB at 32 -> 32,
// 219 KB at 32 -> 64). C % 8 != 0 (a ragged channel count) stages the
// planes element by element instead of by cp.async, in the same kernel.
//
// fp32, C <= 32 (every fp32 conv of the models: the render CLI, the fp32
// forward and recon step, the gradient checks): the same persistent row
// walk on the TF32 tensor cores, mma.sync m16n8k8 with every product as
// three passes, hi.hi + hi.lo + lo.hi (hi = tf32(v), lo = tf32(v - hi),
// split in registers: 3 * 2^-22 of each product), into fp32 sums of the
// 27 * C products. Shared memory decides the tile: in fp32 the bf16 tile's
// weights and ring would double to 328 KB. So a row is F_TW = 4 W x 32 D
// positions (four warps, a W line each), the ring holds F_RING = 4 planes
// (the row's three and one loading: 26 KB a slot at 32 channels), and a
// CTA keeps at most 32 output channels' weights resident (110.6 KB at 32
// -> 32; co = 64 runs two slices of 32, blockIdx.y): 215 KB at most, and
// at 16 channels two CTAs fit an SM (cuda_conv3d.conv3d_plan). The weights
// sit in shared memory in mma's B fragment order (one 8-byte load per lane
// and n8 block). The A fragments are ldmatrix loads of the swizzled planes:
// a b16 pair is one 32-bit value, so an x4 load of rows 0-7 / 8-15 at two
// 16-byte chunks is mma's m16n8k8 TF32 A fragment (one instruction for
// four 32-bit ld.shared). Each B fragment is split once per tap and chunk
// and feeds both m16 fragments. The tensor cores' fp32
// sums do not round to nearest at each step: their error grew with the
// chain (one chain over all 27 taps: 7e-6 of max|y| at res1, half that at
// C = 16, and the fp32 forward's logits moved 7e-5 of their spread), so
// each (kh, kw) sums its three taps into fresh registers (a chain of 9 C /
// 8) added to the row's totals with ordinary fp32 adds (9e-7 at res1;
// chains of one tap gave 5e-7 at 1.41 ms against 1.29).
// Bound at res1 batch 8: 3 * 5.8e10 flops, 0.35 ms at 495 TFLOP/s TF32.
//
// Shapes whose weights and ring do not fit shared memory (C > 32, either
// dtype; no model has one) run the CUDA-core kernel: a block owns one
// (b, h), 4 W x 16 D positions and all co, walks C in chunks of 4 channels
// (the weights stream through shared memory chunk by chunk), and each
// thread keeps one position x co/4 channels in fp32 registers.
// Bias stays outside the kernel, as in the reference's layer.
#include "conv3d_tile.cuh"
#include "hopper.cuh"

namespace {

using rn3::bf16;
using rn3::Geom;
using rn3::HD;
using rn3::R;
using rn3::TD;
using rn3::TW;

constexpr int MMA_THREADS = 32 * TW;  // one warp per W line of a row

template <int CO, int CP>
constexpr int mma_smem_bytes() {
  return 128 + 27 * CP * CO * 2 + R * rn3::HW * HD * CP * 2;
}

// bf16 tensor-core kernel for C <= CP (CP = 16 or 32), co = CO.
template <int CO, int CP, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    conv3d_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ y, Geom g, int grid) {
  constexpr int NX = CP / 8, NW = CO / 8;  // 16-byte chunks per plane row, weight row
  constexpr int SLOT = rn3::HW * HD * CP * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (rn3::smem_u32(smem_raw) & 127)) & 127);
  unsigned char* ws = base;                        // [27 * CP rows][CO], swizzled
  unsigned char* ring = base + 27 * CP * CO * 2;   // R slots of [HW * HD rows][CP]
  const uint32_t ws_u = rn3::smem_u32(ws), ring_u = rn3::smem_u32(ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lq = lane / 8, lr = lane % 8;  // ldmatrix: matrix and row of this lane

  for (int i = tid; i < 27 * CP * NW; i += MMA_THREADS) {
    const int ch = i % NW, row = i / NW, c = row % CP, tap = row / CP;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (c < g.C)
      v = *reinterpret_cast<const uint4*>(w + (static_cast<long long>(tap) * g.C + c) * CO +
                                          ch * 8);
    *reinterpret_cast<uint4*>(ws + rn3::swz<NW>(row, ch)) = v;
  }

  auto issue = [&](rn3::PlaneSeq& seq, int slot) {
    long long col;
    int q;
    bool own;
    if (!seq.next(col, q, own)) return false;
    rn3::load_plane<NX, VEC>(x, g, rn3::column(g, col), q, 0, ring_u + slot * SLOT,
                             ring + slot * SLOT, tid, MMA_THREADS);
    rn::cp_async_commit();
    return true;
  };

  auto row = [&](long long col, int h, int m) {
    const rn3::Column c = rn3::column(g, col);
    const int wo = c.w0 + warp;
    if (wo >= g.W) return;  // warp-uniform: a ragged last W tile
    float acc[2][CO / 8][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int n = 0; n < CO / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][n][e] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
      const uint32_t plane = ring_u + ((m - 2 + kh) % R) * SLOT;
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const int tap = (kh * 3 + kw) * 3 + kd;
#pragma unroll
          for (int kc = 0; kc < CP / 16; ++kc) {
            unsigned a[2][4];
#pragma unroll
            for (int mf = 0; mf < 2; ++mf)
              rn3::ldsm_x4(a[mf], plane + rn3::swz<NX>((warp + kw) * HD + kd + mf * 16 +
                                                           (lq & 1) * 8 + lr,
                                                       kc * 2 + (lq >> 1)));
#pragma unroll
            for (int nj = 0; nj < CO / 16; ++nj) {
              unsigned b[4];
              rn3::ldsm_x4_t(b, ws_u + rn3::swz<NW>(tap * CP + kc * 16 + (lq & 1) * 8 + lr,
                                                    nj * 2 + (lq >> 1)));
#pragma unroll
              for (int mf = 0; mf < 2; ++mf) {
                rn::mma_bf16(acc[mf][2 * nj], a[mf], b);
                rn::mma_bf16(acc[mf][2 * nj + 1], a[mf], b + 2);
              }
            }
          }
        }
      }
    }
    // Fragment rows: D positions d0 + 16 mf + lane / 4 (+ 8); columns:
    // output channels 8 n + 2 (lane % 4) (+ 1).
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = c.d0 + mf * 16 + half * 8 + lane / 4;
        if (d >= g.D) continue;
        bf16* out = y + rn3::pix(g, c.b, h, wo, d) * CO + 2 * (lane % 4);
#pragma unroll
        for (int n = 0; n < CO / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) =
              __floats2bfloat162_rn(acc[mf][n][2 * half], acc[mf][n][2 * half + 1]);
      }
  };

  const long long r0 = g.rows * blockIdx.x / grid, r1 = g.rows * (blockIdx.x + 1) / grid;
  rn3::walk_rows(r0, r1, g.H, issue, row);
}

template <int CO, int CP>
cudaError_t launch_mma(const bf16* x, const bf16* w, bf16* y, const Geom& g, int grid,
                       cudaStream_t s) {
  constexpr int smem = mma_smem_bytes<CO, CP>();
  const bool vec = g.C % 8 == 0;
  auto kernel = vec ? &conv3d_mma_kernel<CO, CP, true> : &conv3d_mma_kernel<CO, CP, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, MMA_THREADS, smem, s>>>(x, w, y, g, grid);
  return cudaGetLastError();
}

template <int CO>
cudaError_t launch_mma_c(const bf16* x, const bf16* w, bf16* y, const Geom& g, int grid,
                         cudaStream_t s) {
  if (g.C <= 16) return launch_mma<CO, 16>(x, w, y, g, grid, s);
  return launch_mma<CO, 32>(x, w, y, g, grid, s);
}

// fp32 tensor-core kernel: rows of F_TW W x TD D positions, a ring of
// F_RING halo planes, at most F_CO output channels per CTA.
constexpr int F_TW = 4;
constexpr int F_RING = 4;
constexpr int F_CO = 32;
constexpr int F_HW = F_TW + 2;
constexpr int F_THREADS = 32 * F_TW;  // one warp per W line of a row

template <int CO, int CP>
constexpr int tf32_smem_bytes() {
  return 128 + 27 * CP * CO * 4 + F_RING * F_HW * HD * CP * 4;
}
static_assert(tf32_smem_bytes<F_CO, 32>() <= 232448, "a CTA's shared memory");

// C <= CP (16 or 32) input channels, CO (16 or 32) of the co output
// channels from CO * blockIdx.y.
template <int CO, int CP, bool VEC>
__global__ void __launch_bounds__(F_THREADS)
    conv3d_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ y, Geom g, int co, int grid) {
  constexpr int NX = CP / 4, KC = CP / 8, NF = CO / 8;  // plane chunks, k8 chunks, n8 blocks
  constexpr int SLOT = F_HW * HD * CP * 4;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (rn3::smem_u32(smem_raw) & 127)) & 127);
  float* ws = reinterpret_cast<float*>(base);      // [27][KC][NF][32 lanes][2]
  unsigned char* ring = base + 27 * CP * CO * 4;   // F_RING slots of [F_HW * HD rows][CP]
  const uint32_t ring_u = rn3::smem_u32(ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, thread in group
  const int a_hi = lane / 16;              // ldmatrix: this lane's row is in chunk 2 kc + a_hi
  const int n0 = CO * blockIdx.y;

  // B fragments: lane 4 g + t of block (tap, kc, nf) holds w[tap][8 kc + t
  // (+ 4)][n0 + 8 nf + g]; zeros past C.
  for (int i = tid; i < 27 * CP * CO; i += F_THREADS) {
    const int n = i % CO, c = (i / CO) % CP, tap = i / (CO * CP);
    const float v = c < g.C ? w[(static_cast<long long>(tap) * g.C + c) * co + n0 + n] : 0.f;
    const int t = c % 8;
    ws[(((tap * KC + c / 8) * NF + n / 8) * 32 + (n % 8) * 4 + t % 4) * 2 + t / 4] = v;
  }

  auto issue = [&](rn3::PlaneSeq& seq, int slot) {
    long long col;
    int q;
    bool own;
    if (!seq.next(col, q, own)) return false;
    rn3::load_plane<NX, VEC, float, F_HW>(x, g, rn3::column<F_TW>(g, col), q, 0,
                                          ring_u + slot * SLOT, ring + slot * SLOT, tid,
                                          F_THREADS);
    rn::cp_async_commit();
    return true;
  };

  auto row = [&](long long col, int h, int m) {
    const rn3::Column c = rn3::column<F_TW>(g, col);
    const int wo = c.w0 + warp;
    if (wo >= g.W) return;  // warp-uniform: a ragged last W tile
    float acc[2][NF][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int n = 0; n < NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][n][e] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < 3; ++kh) {
      const uint32_t plane = ring_u + ((m - 2 + kh) % F_RING) * SLOT;
#pragma unroll 1
      for (int kw = 0; kw < 3; ++kw) {
        // ldmatrix: lanes 8 q .. 8 q + 7 address rows (warp + kw, kd + 8 (q
        // % 2) + lane % 8 (+ 16 mf)) at chunk 2 kc + q / 2
        const int a_row = (warp + kw) * HD + 8 * ((lane / 8) & 1) + lane % 8;
        float part[2][NF][4];  // (kh, kw)'s sums: a chain of 9 KC mma per value
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int n = 0; n < NF; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mf][n][e] = 0.f;
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          const int tap = (kh * 3 + kw) * 3 + kd;
#pragma unroll
          for (int kc = 0; kc < KC; ++kc) {
            // A: rows (warp + kw, kd + 16 mf + g (+ 8)), channels 8 kc + t (+ 4)
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int mf = 0; mf < 2; ++mf) {
              uint32_t v[4];
              rn::ldsm_x4_b32(v, plane + rn3::swz<NX>(a_row + kd + 16 * mf, 2 * kc + a_hi));
#pragma unroll
              for (int e = 0; e < 4; ++e)
                rn::tf32_split(__uint_as_float(v[e]), ah[mf][e], al[mf][e]);
            }
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) {
              const float2 b = *reinterpret_cast<const float2*>(
                  ws + (((tap * KC + kc) * NF + nf) * 32 + lane) * 2);
              uint32_t bh[2], bl[2];
              rn::tf32_split(b.x, bh[0], bl[0]);
              rn::tf32_split(b.y, bh[1], bl[1]);
#pragma unroll
              for (int mf = 0; mf < 2; ++mf) {
                rn::mma_tf32(part[mf][nf], ah[mf], bh);
                rn::mma_tf32(part[mf][nf], ah[mf], bl);
                rn::mma_tf32(part[mf][nf], al[mf], bh);
              }
            }
          }
        }
#pragma unroll
        for (int mf = 0; mf < 2; ++mf)
#pragma unroll
          for (int n = 0; n < NF; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mf][n][e] += part[mf][n][e];
      }
    }
    // Fragment rows: D positions d0 + 16 mf + lane / 4 (+ 8); columns:
    // output channels n0 + 8 n + 2 (lane % 4) (+ 1).
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = c.d0 + mf * 16 + half * 8 + gq;
        if (d >= g.D) continue;
        float* out = y + rn3::pix(g, c.b, h, wo, d) * co + n0 + 2 * tq;
#pragma unroll
        for (int n = 0; n < NF; ++n)
          *reinterpret_cast<float2*>(out + 8 * n) =
              make_float2(acc[mf][n][2 * half], acc[mf][n][2 * half + 1]);
      }
  };

  const long long r0 = g.rows * blockIdx.x / grid, r1 = g.rows * (blockIdx.x + 1) / grid;
  rn3::walk_rows<F_RING, F_RING - 3>(r0, r1, g.H, issue, row);
}

template <int CO, int CP>
cudaError_t launch_tf32(const float* x, const float* w, float* y, const Geom& g, int co, int grid,
                        cudaStream_t s) {
  constexpr int smem = tf32_smem_bytes<CO, CP>();
  auto kernel = g.C % 4 == 0 ? &conv3d_tf32_kernel<CO, CP, true>
                             : &conv3d_tf32_kernel<CO, CP, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(grid, co / CO), F_THREADS, smem, s>>>(x, w, y, g, co, grid);
  return cudaGetLastError();
}

template <int CO>
cudaError_t launch_tf32_c(const float* x, const float* w, float* y, const Geom& g, int co,
                          int grid, cudaStream_t s) {
  if (g.C <= 16) return launch_tf32<CO, 16>(x, w, y, g, co, grid, s);
  return launch_tf32<CO, 32>(x, w, y, g, co, grid, s);
}

// CUDA-core kernel (C > 32, either dtype): 256 threads; thread =
// (position p, channel group ng). Tile: one (b, h), 4 W x 16 D positions.
constexpr int CTW = 4, CTD = 16, CHW = CTW + 2, CHD = CTD + 2;

template <typename T, int CO>
__global__ void __launch_bounds__(256) conv3d_core_kernel(const T* __restrict__ x,
                                                          const T* __restrict__ w,
                                                          T* __restrict__ y, Geom g) {
  constexpr int CK = 4, NPT = CO / 4;
  __shared__ float xs[3 * CHW * CK * CHD];  // [kh][w][c][d]: consecutive d, consecutive banks
  __shared__ float ws[27 * CK * CO];        // [tap][c][n]
  const int ndt = (g.D + CTD - 1) / CTD;
  const int w0 = (blockIdx.x / ndt) * CTW, d0 = (blockIdx.x % ndt) * CTD;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int p = tid % 64, ng = tid / 64;
  const int wi = p / CTD, dd = p % CTD;

  float acc[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < g.C; c0 += CK) {
    for (int i = tid; i < 3 * CHW * CK * CHD; i += 256) {
      const int di = i % CHD, c = (i / CHD) % CK, ww = (i / (CHD * CK)) % CHW,
                kh = i / (CHD * CK * CHW);
      const int hh = h + kh - 1, wx = w0 + ww - 1, dx = d0 + di - 1;
      float v = 0.f;
      if (hh >= 0 && hh < g.H && wx >= 0 && wx < g.W && dx >= 0 && dx < g.D && c0 + c < g.C)
        v = rn::to_f32(x[rn3::pix(g, b, hh, wx, dx) * g.C + c0 + c]);
      xs[i] = v;
    }
    for (int i = tid; i < 27 * CK * CO; i += 256) {
      const int n = i % CO, c = (i / CO) % CK, tap = i / (CO * CK);
      ws[i] = c0 + c < g.C ? rn::to_f32(w[(static_cast<long long>(tap) * g.C + c0 + c) * CO + n])
                           : 0.f;
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
            const float av = xs[((kh * CHW + wi + kw) * CK + c) * CHD + dd + kd];
            const float* wr = ws + (((kh * 3 + kw) * 3 + kd) * CK + c) * CO + ng * NPT;
#pragma unroll
            for (int j = 0; j < NPT; ++j) acc[j] = fmaf(av, wr[j], acc[j]);
          }
    __syncthreads();
  }
  const int wo = w0 + wi, dO = d0 + dd;
  if (wo < g.W && dO < g.D) {
    T* out = y + rn3::pix(g, b, h, wo, dO) * CO + ng * NPT;
#pragma unroll
    for (int j = 0; j < NPT; ++j) out[j] = rn::from_f32<T>(acc[j]);
  }
}

template <typename T>
cudaError_t launch_core(const void* x, const void* w, void* y, const Geom& g, int co,
                        cudaStream_t s) {
  const dim3 grid(((g.W + CTW - 1) / CTW) * ((g.D + CTD - 1) / CTD), g.H, g.B);
  auto xt = static_cast<const T*>(x);
  auto wt = static_cast<const T*>(w);
  auto yt = static_cast<T*>(y);
  if (co == 16) conv3d_core_kernel<T, 16><<<grid, 256, 0, s>>>(xt, wt, yt, g);
  if (co == 32) conv3d_core_kernel<T, 32><<<grid, 256, 0, s>>>(xt, wt, yt, g);
  if (co == 64) conv3d_core_kernel<T, 64><<<grid, 256, 0, s>>>(xt, wt, yt, g);
  return cudaGetLastError();
}

}  // namespace

// x [B, H, W, D, C], w [27, C, co] (contiguous), y [B, H, W, D, co]; co in
// {16, 32, 64}; all 16-byte aligned. grid: the CTAs that split the rows on
// the tensor-core paths (C <= 32; per 32-channel slice of co in fp32), at
// most the number of rows of the dtype's columns (cuda_conv3d.conv3d_plan);
// C > 32 ignores it.
extern "C" int rn_conv3d(const void* x, const void* w, void* y, int dtype, int B, int H,
                         int W, int D, int C, int co, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co != 16 && co != 32 && co != 64) return static_cast<int>(cudaErrorInvalidValue);
  if (C > 32) {
    const Geom g = rn3::make_geom(B, H, W, D, C);
    return static_cast<int>(dtype == 0 ? launch_core<float>(x, w, y, g, co, s)
                                       : launch_core<bf16>(x, w, y, g, co, s));
  }
  if (dtype == 0) {
    const Geom g = rn3::make_geom<F_TW>(B, H, W, D, C);
    if (grid < 1 || grid > g.rows) return static_cast<int>(cudaErrorInvalidValue);
    auto xf = static_cast<const float*>(x);
    auto wf = static_cast<const float*>(w);
    auto yf = static_cast<float*>(y);
    return static_cast<int>(co == 16 ? launch_tf32_c<16>(xf, wf, yf, g, co, grid, s)
                                     : launch_tf32_c<F_CO>(xf, wf, yf, g, co, grid, s));
  }
  const Geom g = rn3::make_geom(B, H, W, D, C);
  if (grid < 1 || grid > g.rows) return static_cast<int>(cudaErrorInvalidValue);
  auto xb = static_cast<const bf16*>(x);
  auto wb = static_cast<const bf16*>(w);
  auto yb = static_cast<bf16*>(y);
  cudaError_t err = cudaErrorInvalidValue;
  if (co == 16) err = launch_mma_c<16>(xb, wb, yb, g, grid, s);
  if (co == 32) err = launch_mma_c<32>(xb, wb, yb, g, grid, s);
  if (co == 64) err = launch_mma_c<64>(xb, wb, yb, g, grid, s);
  return static_cast<int>(err);
}
