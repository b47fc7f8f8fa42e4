// K2w: weight gradient of the SAME, stride-1, 3x3x3 channels-last conv (K2):
//   gw[kh, kw, kd, c, o] = sum over (b, h, w, d) of
//                          xpad[b, h + kh, w + kw, d + kd, c] * gy[b, h, w, d, o]
// with fp32 accumulation, for co in {16, 32, 64}.
//
// Replaces rendernet_tpu/ops/pallas_conv3d.py:_wgrad_kernel (reached through
// pl.pallas_call in _nc_bwd). The TPU kernel carries the [3, 3, f*C, 128]
// sums across its sequential grid in pinned VMEM and works on depth-packed
// operands (_pack_mid, _pack_combo), a device of the MXU's 128 lanes. Here
// the CTAs run in no order, so each writes fp32 partial sums of its share of
// the positions, and a second kernel adds them in a fixed order (no
// atomics): every run gives the same bits.
//
// As a GEMM: M = 27 * C, N = co, and the reduction runs over all B*H*W*D
// positions (3.1 M at res1, batch 24). Bound: operations, 2 * 27 * C * co
// flops per position (174 GFLOP at res1 batch 24 with C = co = 32: 0.18 ms
// at 989 TFLOP/s bf16) against ~0.4 GB of reads.
//
// bf16: persistent CTAs (one per SM, 9 warps), each owning a contiguous
// range of rows (conv3d_tile.cuh: a row is 8 W x 32 D positions of one
// (b, h)) and, for a slice of up to 32 input channels x 32 output channels
// (the whole of C and co on the models' path), all 27 taps' sums in
// registers: warp (kh, kw) holds its 3 kd taps, 96 fp32 values a thread at
// 32 x 32. Per row the CTA reads the halo planes h - 1, h, h + 1 of x and
// the gy row h from a cp.async ring that loads each plane and each gy row
// once per column, so x and gy are each read ~once from device memory
// (x ~1.33x from L2). The products are mma.sync m16n8k16:
// A = x^T (16 channels x 16 positions), ldmatrix.trans of the halo plane
// kh at rows shifted by (kw, kd); B = gy (16 positions x 16 channels),
// ldmatrix.trans of the gy row. mma.sync and not wgmma: the kd shift of A
// is one 16-byte-aligned row (64 B at C = 32), which no wgmma shared-memory
// descriptor can express inside a 128-byte swizzle atom, and wgmma with A
// from registers would tie four warps to one 64-channel M tile that C = 32
// does not fill. Per barrier a warp issues 8 W lines x 2 D halves x 24
// MMAs = 384. Each CTA writes its [27, slice] sums to
// part[cta]; conv3d_wgrad_reduce_kernel adds the CTAs in index order. Wider
// shapes take a grid of channel slices (C in 32s, co in 32s), each a
// persistent set of CTAs over all positions.
//
// fp32: CUDA-core FMAs. A block owns one kh, 16 input channels and all co,
// walks its chunk of position tiles (one (b, h), 4 W x 16 D) and keeps one
// input channel x co / 16 outputs x the 9 taps of its kh in registers.
#include "conv3d_tile.cuh"

namespace {

using rn3::bf16;

constexpr int MMA_THREADS = 9 * 32;  // warp (kh, kw) owns taps (kh, kw, 0..2)

template <int CS, int OS>
__host__ __device__ constexpr int mma_slot_bytes() {
  return rn3::HW * rn3::HD * CS * 2 + rn3::TW * rn3::TD * OS * 2;
}

template <int CS, int OS>
constexpr int mma_smem_bytes() {
  return 128 + rn3::R * mma_slot_bytes<CS, OS>();
}

// bf16 tensor-core kernel. Grid (parts, C slices of CS, co slices of OS);
// part[blockIdx.x][27][cpad][co] receives this CTA's sums for its slices.
template <int CS, int OS, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    conv3d_wgrad_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                     float* __restrict__ part, rn3::Geom g, int co, int cpad, int parts) {
  constexpr int NX = CS / 8, NG = OS / 8;  // 16-byte chunks per plane row, gy row
  constexpr int XBYTES = rn3::HW * rn3::HD * CS * 2, SLOT = mma_slot_bytes<CS, OS>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (rn3::smem_u32(smem_raw) & 127)) & 127);
  const uint32_t ring_u = rn3::smem_u32(ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lq = lane / 8, lr = lane % 8;
  const int kh = warp / 3, kw = warp % 3;
  const int c0 = blockIdx.y * CS, o0 = blockIdx.z * OS;

  float acc[3][CS / 16][OS / 8][4];
#pragma unroll
  for (int kd = 0; kd < 3; ++kd)
#pragma unroll
    for (int cf = 0; cf < CS / 16; ++cf)
#pragma unroll
      for (int of = 0; of < OS / 8; ++of)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kd][cf][of][e] = 0.f;

  // A plane of x (channels c0..) and, for the run's own rows, the gy row of
  // the same h (channels o0..), zero past W and D.
  auto issue = [&](rn3::PlaneSeq& seq, int slot) {
    long long col;
    int q;
    bool own;
    if (!seq.next(col, q, own)) return false;
    const rn3::Column c = rn3::column(g, col);
    rn3::load_plane<NX, VEC>(x, g, c, q, c0, ring_u + slot * SLOT, ring + slot * SLOT, tid,
                             MMA_THREADS);
    if (own) {
      const uint32_t dst = ring_u + slot * SLOT + XBYTES;
      for (int i = tid; i < rn3::TW * rn3::TD * NG; i += MMA_THREADS) {
        const int ch = i % NG, p = i / NG;
        const int wo = c.w0 + p / rn3::TD, dO = c.d0 + p % rn3::TD;
        const bool ok = wo < g.W && dO < g.D;
        const bf16* src = ok ? gy + rn3::pix(g, c.b, q, wo, dO) * co + o0 + ch * 8 : gy;
        rn3::cp_async16(dst + rn3::swz<NG>(p, ch), src, ok ? 16 : 0);
      }
    }
    rn::cp_async_commit();
    return true;
  };

  auto row = [&](long long col, int, int m) {
    const rn3::Column c = rn3::column(g, col);
    const uint32_t xp = ring_u + ((m - 2 + kh) % rn3::R) * SLOT;
    const uint32_t gp = ring_u + ((m - 1) % rn3::R) * SLOT + XBYTES;
#pragma unroll 1
    for (int wi = 0; wi < rn3::TW && c.w0 + wi < g.W; ++wi) {
#pragma unroll
      for (int dh = 0; dh < rn3::TD / 16; ++dh) {
        if (c.d0 + dh * 16 >= g.D) break;
        unsigned b[OS / 16][4];  // gy: [o fragment 2 oj | 2 oj + 1][b0, b1]
#pragma unroll
        for (int oj = 0; oj < OS / 16; ++oj)
          rn3::ldsm_x4_t(b[oj], gp + rn3::swz<NG>(wi * rn3::TD + dh * 16 + (lq & 1) * 8 + lr,
                                                  oj * 2 + (lq >> 1)));
#pragma unroll
        for (int kd = 0; kd < 3; ++kd)
#pragma unroll
          for (int cf = 0; cf < CS / 16; ++cf) {
            unsigned a[4];  // x^T: rows = channels, columns = positions
            const int xrow = (wi + kw) * rn3::HD + dh * 16 + kd + (lq >> 1) * 8 + lr;
            rn3::ldsm_x4_t(a, xp + rn3::swz<NX>(xrow, cf * 2 + (lq & 1)));
#pragma unroll
            for (int of = 0; of < OS / 8; ++of)
              rn::mma_bf16(acc[kd][cf][of], a, b[of / 2] + (of % 2) * 2);
          }
      }
    }
  };

  const long long r0 = g.rows * blockIdx.x / parts, r1 = g.rows * (blockIdx.x + 1) / parts;
  rn3::walk_rows(r0, r1, g.H, issue, row);

  // Fragment rows: channels c0 + 16 cf + lane / 4 (+ 8); columns: outputs
  // o0 + 8 of + 2 (lane % 4) (+ 1).
#pragma unroll
  for (int kd = 0; kd < 3; ++kd)
#pragma unroll
    for (int cf = 0; cf < CS / 16; ++cf)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = c0 + cf * 16 + half * 8 + lane / 4;
        float* dst = part + ((static_cast<long long>(blockIdx.x) * 27 + (kh * 3 + kw) * 3 + kd) *
                                 cpad + cc) * co + o0 + 2 * (lane % 4);
#pragma unroll
        for (int of = 0; of < OS / 8; ++of)
          *reinterpret_cast<float2*>(dst + 8 * of) =
              make_float2(acc[kd][cf][of][2 * half], acc[kd][cf][of][2 * half + 1]);
      }
}

template <int CS, int OS>
cudaError_t launch_mma(const bf16* x, const bf16* gy, float* part, const rn3::Geom& g, int co,
                       int cpad, int parts, cudaStream_t s) {
  constexpr int smem = mma_smem_bytes<CS, OS>();
  auto kernel = g.C % 8 == 0 ? &conv3d_wgrad_mma_kernel<CS, OS, true>
                              : &conv3d_wgrad_mma_kernel<CS, OS, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(parts, cpad / CS, co / OS);
  kernel<<<grid, MMA_THREADS, smem, s>>>(x, gy, part, g, co, cpad, parts);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------
constexpr int TW = 4, TD = 16;  // positions of a tile along W and D
constexpr int HW = TW + 2, HD = TD + 2;

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
// vectors of 4 channels (x: when C % 4 == 0; gy always, since co is a
// multiple of 16), else element by element.
template <int CB>
__device__ __forceinline__ void stage(const Geom& g, const float* __restrict__ x,
                                      const float* __restrict__ gy, float* xs, float* gs, int b,
                                      int h, int w0, int d0, int kh, int c0, int tid,
                                      int nthreads) {
  constexpr int V = 4;
  const int hh = h + kh - 1;
  const bool hin = hh >= 0 && hh < g.H;
  if (g.C % V == 0) {
    for (int i = tid; i < HW * HD * CB / V; i += nthreads) {
      const int c = (i % (CB / V)) * V, p = i / (CB / V);
      const int dd = p % HD, ww = p / HD;
      const int wi = w0 + ww - 1, di = d0 + dd - 1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && c0 + c < g.C)
        v = *reinterpret_cast<const float4*>(x + pix(g, b, hh, wi, di) * g.C + c0 + c);
      *reinterpret_cast<float4*>(xs + p * CB + c) = v;
    }
  } else {
    for (int i = tid; i < HW * HD * CB; i += nthreads) {
      const int c = i % CB, dd = (i / CB) % HD, ww = i / (CB * HD);
      const int wi = w0 + ww - 1, di = d0 + dd - 1;
      float v = 0.f;
      if (hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && c0 + c < g.C)
        v = x[pix(g, b, hh, wi, di) * g.C + c0 + c];
      xs[i] = v;
    }
  }
  for (int i = tid; i < TW * TD * g.co / V; i += nthreads) {
    const int o = (i % (g.co / V)) * V, p = i / (g.co / V);
    const int dd = p % TD, ww = p / TD;
    const int wo = w0 + ww, dO = d0 + dd;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (wo < g.W && dO < g.D)
      v = *reinterpret_cast<const float4*>(gy + pix(g, b, h, wo, dO) * g.co + o);
    *reinterpret_cast<float4*>(gs + p * g.co + o) = v;
  }
}

// fp32 CUDA-core kernel: 256 threads = (channel c in 16) x (output group og
// in 16); a thread owns outputs og + 16 j, j < co / 16, for all 9 taps.
template <int CO>
__global__ void __launch_bounds__(256)
    conv3d_wgrad_f32_kernel(const float* __restrict__ x, const float* __restrict__ gy,
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
    stage<CB>(g, x, gy, xs, gs, b, h, w0, d0, kh, c0, tid, 256);
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
__global__ void conv3d_wgrad_reduce_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int C, int cpad, int co,
                                           int nchunks) {
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

}  // namespace

// x [B, H, W, D, C], gy [B, H, W, D, co] (one storage type, 16-byte
// aligned); out [27, C, co] fp32; part: the workspace, parts * 27 * cpad *
// co floats, with (parts, cpad) from cuda_conv3d.wgrad_plan: bf16, the
// persistent CTAs per slice and C rounded up to the slice width (16 for
// C <= 16, else 32); fp32, the position chunks and C rounded up to 16.
extern "C" int rn_conv3d_wgrad(const void* x, const void* gy, void* part, void* out, int dtype,
                               int B, int H, int W, int D, int C, int co, int parts, int cpad,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co != 16 && co != 32 && co != 64) return static_cast<int>(cudaErrorInvalidValue);
  float* pf = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    const Geom g{H, W, D, C, co, cpad,
                 static_cast<long long>(B) * H * ((W + TW - 1) / TW) * ((D + TD - 1) / TD),
                 parts};
    if (cpad != (C + 15) / 16 * 16 || parts < 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(parts, 3, cpad / 16);
    auto xf = static_cast<const float*>(x);
    auto gf = static_cast<const float*>(gy);
    if (co == 16) conv3d_wgrad_f32_kernel<16><<<grid, 256, 0, s>>>(xf, gf, pf, g);
    if (co == 32) conv3d_wgrad_f32_kernel<32><<<grid, 256, 0, s>>>(xf, gf, pf, g);
    if (co == 64) conv3d_wgrad_f32_kernel<64><<<grid, 256, 0, s>>>(xf, gf, pf, g);
    err = cudaGetLastError();
  } else {
    const rn3::Geom g = rn3::make_geom(B, H, W, D, C);
    const int cs = C <= 16 ? 16 : 32;
    if (cpad != (C + cs - 1) / cs * cs || parts < 1 || parts > g.rows)
      return static_cast<int>(cudaErrorInvalidValue);
    auto xb = static_cast<const bf16*>(x);
    auto gb = static_cast<const bf16*>(gy);
    if (cs == 16 && co == 16) err = launch_mma<16, 16>(xb, gb, pf, g, co, cpad, parts, s);
    if (cs == 16 && co != 16) err = launch_mma<16, 32>(xb, gb, pf, g, co, cpad, parts, s);
    if (cs == 32 && co == 16) err = launch_mma<32, 16>(xb, gb, pf, g, co, cpad, parts, s);
    if (cs == 32 && co != 16) err = launch_mma<32, 32>(xb, gb, pf, g, co, cpad, parts, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = 27LL * C * co;
  conv3d_wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      pf, static_cast<float*>(out), C, cpad, co, parts);
  return static_cast<int>(cudaGetLastError());
}
