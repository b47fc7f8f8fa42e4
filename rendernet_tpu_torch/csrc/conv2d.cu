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
// K = 9 * C. The epilogue runs on the fp32 accumulator in registers, in the
// TPU kernel's order (bias, z, activation, residual), with one rounding to
// the storage type.
//
// Bound: operations. 2 * H W B * 9 C * co flops (res2 at batch 8,
// [8, 64, 64, 1024] -> 1024: 6.18e11, 0.625 ms at 989 TFLOP/s bf16; 9.23 ms
// at 67 TFLOP/s fp32) against 2 * 67 MB of activations and 19 MB of
// weights.
//
// bf16 (the main path): a persistent, warp-specialized wgmma GEMM fed by
// TMA (conv2d_wgmma_kernel). One CTA per SM, in clusters of two (the grid
// comes from cuda_conv2d.conv2d_plan, cut to the clusters the card holds
// at once); cluster k walks tile pairs k, k + clusters, ... A tile is BM =
// 128 pixels of one image row h (the flattened W * B axis m0 .. m0 + 127)
// by BN output channels (BN = 256 where co % 256 == 0, else 128). A pair
// is two pixel tiles (one per CTA) of one output tile: each CTA loads its
// own activation box and half of the weight boxes, multicast into both
// CTAs, so a stage takes 32 KB, not 48 KB, from L2. Pairs are numbered
// with the co / BN output tiles of one pixel-tile pair adjacent, so that
// activations come from HBM once and from L2 for the others.
//   * Activations: one 3-D tensor map over x as [H][W * B][C], box (64
//     channels, 128 rows, 1). Tap (ky, kx) of the tile reads the box at
//     (c0, m0 + (kx - 1) B, h + ky - 1): a shift by whole pixels along the
//     W * B axis and by a row along H. TMA zero-fills coordinates outside
//     [0, W B) and [0, H), which is exactly the SAME halo, because a tile
//     never straddles two rows h (W * B / 128 tiles per row, the last one
//     masked on store), and channels past C (C % 64 == 32).
//   * Weights: [3, 3, C, co] as it lies, a 3-D map [9][C][co] with box (64
//     output channels, 64 input channels, 1); BN / 64 boxes per stage. They
//     are the MN-major B operand (co contiguous), read with wgmma's
//     transpose bit; the activations are the K-major A operand.
//   * Pipeline: warp 8 is the producer; one of its threads walks the K
//     steps (tap, 64-channel chunk) of every tile of the CTA and keeps a
//     ring of STAGES stages (16 KB of activations + BN / 64 * 8 KB of
//     weights, 128-byte swizzle) full, guarded by full / empty mbarriers.
//     Warpgroups 0 and 1 each own 64 of the 128 rows and all BN columns:
//     per stage 4 wgmma.m64nBNk16, one wgmma group left in flight, a stage
//     released once the group that read it has retired, by lane 0 of each
//     consumer warp on both CTAs' empty barriers (a slot is refilled only
//     when both CTAs are done with it: either CTA's multicast writes into
//     both), by predicate, not by branch: a branch on the thread index
//     between a wgmma and its wait serializes them.
//   * Epilogue: from the accumulator registers (BN / 2 per thread), bias,
//     z, activation, residual, one rounding, two channels per store;
//     meanwhile the producer is already loading the next tile's stages.
//   * 288 threads (two consumer warpgroups and one producer warp). ptxas
//     gives them 168 registers a thread, as it does 384: BN = 256 keeps its
//     128 accumulators in them, and the epilogue works four column pairs
//     at a time so as not to spill.
// fp32: CUDA-core FMAs; a block owns 128 pixels x 128 output channels,
// walks K in steps of 16 channels of one tap staged with cp.async (three
// steps in flight), each thread owning 8 pixels x 8 channels; tap (ky, kx)
// reads row m + ((ky - 1) W + kx - 1) B, masked to zero outside the image.
#include <cuda_bf16.h>

#include "hopper.cuh"

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
// bf16: persistent wgmma GEMM fed by TMA
// ---------------------------------------------------------------------------
namespace wg {
constexpr int BM = 128;                  // pixels per tile: two consumer warpgroups x 64
constexpr int BK = 64;                   // input channels per stage: one 128-byte swizzle row
constexpr int A_BYTES = BM * BK * 2;     // activation box, 16 KB
constexpr int W_BOX = 64 * BK * 2;       // one 64-output-channel weight box, 8 KB
constexpr int THREADS = 288;             // warpgroups 0, 1 consume; warp 8 produces
// Arrivals that free a stage: every consumer warp of both CTAs of the pair
// (either CTA's multicast writes into both).
constexpr int RELEASES = 2 * 8;
template <int TN>
struct Cfg {
  static constexpr int STAGE_BYTES = A_BYTES + TN / 64 * W_BOX;
  static constexpr int STAGES = TN == 256 ? 4 : 6;  // 192 KB of ring either way
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzled boxes start on 1024-byte boundaries");
};
}  // namespace wg

// Tile pair q of the persistent walk, as CTA `rank` of a cluster takes it
// (cuda_conv2d.conv2d_tile): the image row h, the first pixel m0 of the
// row's W * B pixels, the first output channel n0. The pair's two pixel
// tiles 2 (q / ntiles_n) + rank share n0; past the last pixel tile (an odd
// count) h is H, a tile that loads and stores nothing of the image.
struct Tile {
  int h, m0, n0;
};
__device__ __forceinline__ Tile tile_of(int q, int rank, int tiles_per_row, int ntiles_n,
                                        int bn) {
  const int mt = 2 * (q / ntiles_n) + rank;
  return {mt / tiles_per_row, (mt % tiles_per_row) * wg::BM, (q % ntiles_n) * bn};
}

// The epilogue of one consumer thread's wgmma accumulators: rows r (valid
// r0) and r + 8 (valid r1), element offsets i0 and i0 + dr of their first
// column n; columns n + 8 j (+ 1). Four column pairs at a time (more spill
// at BN = 256: ptxas holds the kernel to 168 registers a thread), every
// read-only load (bias, alpha, residual) issued before the stores, so that
// their latencies overlap.
template <int TN>
__device__ __forceinline__ void epilogue_rows(const Epi& e, __nv_bfloat16* __restrict__ y,
                                              const float (&acc)[TN / 2], long long i0,
                                              long long dr, bool r0, bool r1, int n) {
  const float* __restrict__ bias = e.bias;
  const float* __restrict__ alpha = e.alpha;
  const __nv_bfloat162* __restrict__ res = static_cast<const __nv_bfloat162*>(e.res);
  __nv_bfloat162* z = static_cast<__nv_bfloat162*>(e.z);
  const bool ok[2] = {r0, r1};
#pragma unroll
  for (int jb = 0; jb < TN / 32; ++jb) {
    float2 b[4], a[4];
    __nv_bfloat162 rv[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n + 8 * (4 * jb + j);
      b[j] = bias ? make_float2(__ldg(bias + c), __ldg(bias + c + 1)) : make_float2(0.f, 0.f);
      a[j] = e.act == 1 ? make_float2(__ldg(alpha + c), __ldg(alpha + c + 1))
                        : make_float2(0.f, 0.f);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (res && ok[h]) rv[h][j] = res[(i0 + h * dr) / 2 + 4 * (4 * jb + j)];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!ok[h]) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int jj = 4 * jb + j;
        const long long i = i0 + h * dr + 8 * jj;
        float v0 = acc[4 * jj + 2 * h] + b[j].x, v1 = acc[4 * jj + 2 * h + 1] + b[j].y;
        if (z) z[i / 2] = __floats2bfloat162_rn(v0, v1);
        if (e.act == 1) {
          v0 = v0 < 0.f ? a[j].x * v0 : v0;
          v1 = v1 < 0.f ? a[j].y * v1 : v1;
        } else if (e.act == 2) {
          v0 = v0 < 0.f ? 0.f : v0;
          v1 = v1 < 0.f ? 0.f : v1;
        }
        if (res) {
          const float2 r = __bfloat1622float2(rv[h][j]);
          v0 += r.x;
          v1 += r.y;
        }
        reinterpret_cast<__nv_bfloat162*>(y)[i / 2] = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <int TN>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(wg::THREADS, 1)
    conv2d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        __nv_bfloat16* __restrict__ y, Geom g, Epi e, int tiles_per_row) {
  using Cf = wg::Cfg<TN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + Cf::STAGES * Cf::STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * Cf::STAGES;               // empty[s]: empty + 8 s
  const int wb = g.W * g.B;
  const int ntiles_n = g.co / TN;
  const int npairs = (g.H * tiles_per_row + 1) / 2 * ntiles_n;
  const int nc = (g.C + wg::BK - 1) / wg::BK;  // channel chunks per tap
  const int nk = 9 * nc;                        // K steps per tile
  const int cluster = blockIdx.x / 2, nclusters = gridDim.x / 2;
  const uint32_t rank = rn::cluster_rank();
  // The warp index, broadcast from lane 0 so that the compiler sees the
  // branch between the roles as uniform across each warp.
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      rn::mbar_init(full + 8 * s, 1);
      rn::mbar_init(empty + 8 * s, wg::RELEASES);
    }
    rn::fence_mbar_init();
  }
  // Both CTAs' barriers exist before either multicasts or arrives remotely.
  rn::cluster_sync();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      int it = 0;  // stages filled, over all tiles
      for (int q = cluster; q < npairs; q += nclusters) {
        const Tile tl = tile_of(q, rank, tiles_per_row, ntiles_n, TN);
        for (int k = 0; k < nk; ++k, ++it) {
          const int tap = k / nc, c0 = (k - tap * nc) * wg::BK;
          const int ky = tap / 3, kx = tap - 3 * ky;
          const uint32_t slot = it % Cf::STAGES;
          // Slot reuse: both CTAs' consumers have released stage it - STAGES.
          if (it >= Cf::STAGES) rn::mbar_wait(empty + 8 * slot, ((it / Cf::STAGES) - 1) & 1);
          const uint32_t st = ring + slot * Cf::STAGE_BYTES, bar = full + 8 * slot;
          rn::mbar_expect_tx(bar, Cf::STAGE_BYTES);
          rn::tma_load_3d(st, &xmap, c0, tl.m0 + (kx - 1) * g.B, tl.h + ky - 1, bar);
          // this CTA's half of the weight boxes, into both CTAs of the pair
#pragma unroll
          for (int b = 0; b < TN / 128; ++b) {
            const int qb = static_cast<int>(rank) * (TN / 128) + b;
            rn::tma_load_3d_multicast(st + wg::A_BYTES + qb * wg::W_BOX, &wmap, tl.n0 + 64 * qb,
                                      c0, tap, bar, 3);
          }
        }
      }
      // Let every release of the last stages, the peer's remote ones
      // included, land before this CTA exits.
      for (int d = 0; d < Cf::STAGES; ++d, ++it)
        if (it >= Cf::STAGES)
          rn::mbar_wait(empty + 8 * (it % Cf::STAGES), ((it / Cf::STAGES) - 1) & 1);
    }
    return;
  }

  // consumers: warpgroup wgi owns rows 64 wgi .. 64 wgi + 63 of each tile
  const int wgi = warp / 4;
  const uint32_t lane = threadIdx.x % 32;
  const int row = wgi * 64 + (warp % 4) * 16 + static_cast<int>(lane) / 4;
  // the peer CTA's empty[0], as a shared::cluster address
  const uint32_t peer_empty = rn::cluster_address(empty, rank ^ 1);
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  int it = 0;  // stages consumed, over all tiles
  for (int q = cluster; q < npairs; q += nclusters) {
    const Tile tl = tile_of(q, rank, tiles_per_row, ntiles_n, TN);
    for (int k = 0; k < nk; ++k, ++it) {
      const uint32_t slot = it % Cf::STAGES;
      rn::mbar_wait(full + 8 * slot, (it / Cf::STAGES) & 1);
      const uint32_t st = ring + slot * Cf::STAGE_BYTES;
      const uint64_t da = rn::sw128_desc(st + wgi * (wg::A_BYTES / 2));
      const uint64_t db = rn::sw128_mn_desc(st + wg::A_BYTES, wg::W_BOX);
      rn::wgmma_fence();
#pragma unroll
      for (int j = 0; j < wg::BK / 16; ++j)
        rn::wgmma<TN, 0, 1>(acc, da + 2 * j, db + 128 * j, k | j);
      rn::wgmma_commit();
      rn::wgmma_wait<1>();  // stage it - 1's group has retired: release its slot
      if (k > 0) {
        const uint32_t off = 8 * ((it - 1) % Cf::STAGES);
        rn::mbar_arrive_pair_lane0(empty + off, peer_empty + off, lane);
      }
    }
    rn::wgmma_wait<0>();
    const uint32_t off = 8 * ((it - 1) % Cf::STAGES);
    rn::mbar_arrive_pair_lane0(empty + off, peer_empty + off, lane);
    rn::fence_regs(acc);
    if (tl.h >= g.H) continue;  // the odd pixel tile's partner
    // rows row, row + 8 (past the end of the image row: masked); the
    // thread's columns n0 + 8 j + 2 (lane % 4) (+ 1)
    const int m = tl.m0 + row;
    const long long i0 = (static_cast<long long>(tl.h) * wb + m) * g.co + tl.n0 +
                         2 * static_cast<int>(lane % 4);
    epilogue_rows<TN>(e, y, acc, i0, 8LL * g.co, m < wb, m + 8 < wb, tl.n0 + 2 * (lane % 4));
  }
}

// x as [H][W * B][C] (box 64 channels x 128 pixels x 1 row) and w as
// [9][C][co] (box 64 output x 64 input channels x 1 tap), both bf16 with
// 128-byte swizzle, zeros past every edge.
template <int TN>
int launch_wgmma(const void* x, const void* w, __nv_bfloat16* y, const Geom& g, const Epi& e,
                 int grid, cudaStream_t s) {
  using Cf = wg::Cfg<TN>;
  const long long wb = static_cast<long long>(g.W) * g.B;
  const long long xdims[3] = {g.C, wb, g.H}, xstr[2] = {2LL * g.C, 2LL * g.C * wb};
  const int xbox[3] = {wg::BK, wg::BM, 1};
  const long long wdims[3] = {g.co, g.C, 9}, wstr[2] = {2LL * g.co, 2LL * g.C * g.co};
  const int wbox[3] = {64, wg::BK, 1};
  CUtensorMap xmap, wmap;
  if (!rn::make_bf16_map(&xmap, x, 3, xdims, xstr, xbox) ||
      !rn::make_bf16_map(&wmap, w, 3, wdims, wstr, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      conv2d_wgmma_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int pairs = rn::max_active_pairs(conv2d_wgmma_kernel<TN>, wg::THREADS, Cf::SMEM);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid = grid < 2 * pairs ? grid : 2 * pairs;
  const int tiles_per_row = static_cast<int>((wb + wg::BM - 1) / wg::BM);
  conv2d_wgmma_kernel<TN><<<grid, wg::THREADS, Cf::SMEM, s>>>(xmap, wmap, y, g, e, tiles_per_row);
  return static_cast<int>(cudaGetLastError());
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
// co % 128 == 0. grid: the bf16 kernel's persistent CTAs, an even count (2
// per cluster; cuda_conv2d.conv2d_plan), cut to the clusters the card can
// hold at once; the fp32 kernel takes one block per 128 x 128 tile and
// ignores it.
extern "C" int rn_conv2d(const void* x, const void* w, const void* bias, const void* alpha,
                         const void* res, void* y, void* z, int dtype, int act, int H, int W,
                         int B, int C, int co, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(H) * W * B;
  const long long mtiles = (M + BM - 1) / BM;
  if (C <= 0 || C % 32 || co <= 0 || co % BN || act < 0 || act > 2 || (act == 1 && !alpha) ||
      M <= 0 || M >= (1LL << 31) || mtiles > 65535 || (dtype != 0 && (grid < 2 || grid % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{H, W, B, C, co, static_cast<int>(M)};
  const Epi e{static_cast<const float*>(bias), static_cast<const float*>(alpha), res, z, act};
  if (dtype != 0) {
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    return co % 256 == 0 ? launch_wgmma<256>(x, w, yb, g, e, grid, s)
                         : launch_wgmma<128>(x, w, yb, g, e, grid, s);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      conv2d_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f32::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  conv2d_f32_kernel<<<dim3(co / BN, static_cast<unsigned>(mtiles)), NT, f32::SMEM, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y), g, e);
  return static_cast<int>(cudaGetLastError());
}
