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
// fp32 (conv2d_tf32_kernel): the same persistent pipeline with every
// product on the TF32 tensor cores as three passes, hi.hi + hi.lo + lo.hi
// (hi = tf32(a), lo = tf32(a - hi): 3 * 2^-22 of each product). TF32 wgmma
// has no transpose mode, so both shared-memory operands are K-major: a
// pre-pass (tf32_split_kernel) writes x's split as two planes [H][W B][C]
// (the same 3-D maps and SAME halo as bf16) and the weights', which the
// wrapper lays out K-major as [9][co][C] (C contiguous), as two planes.
// All three passes then read shared memory, and a wgmma group stays in
// flight as in bf16. A k8 slice is 32 bytes of a 128-byte swizzled row, so
// a stage is 32 channels of one tap: both activation planes' boxes (128
// pixels, 16 KB each) and both weight planes' (128 output channels, 16 KB
// each; CTA rank r of the pair loads plane r into both), 64 KB, three
// stages. The tensor cores' fp32 sums lose precision along an accumulator
// chain (as winograd.cu's fp32 GEMM found), so the accumulators
// restart every `chain` stages (cuda_conv2d.CHAIN_STAGES_F32) and the
// chains are summed in fp32 adds beside them (tot): 2 x 64 registers a
// thread, which holds the tile to BN = 128 output channels. The epilogue is
// the bf16 one's arithmetic on tot, stored as fp32.
// Bound: three TF32 passes, 3 * 6.18e11 flops at res2 batch 8, 3.75 ms at
// 495 TFLOP/s; the split reads x once and writes it twice (0.12 ms).
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

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

__device__ __forceinline__ float activate(const Epi& e, int n, float v) {
  if (e.act == 1) return v < 0.f ? e.alpha[n] * v : v;  // max(v, 0) + alpha min(v, 0)
  if (e.act == 2) return v < 0.f ? 0.f : v;
  return v;
}

// The fp32 epilogue of two neighbouring output channels n, n + 1 of pixel m.
__device__ __forceinline__ void epilogue2(const Epi& e, float* __restrict__ y, int m, int n,
                                          int co, float v0, float v1) {
  const long long i = static_cast<long long>(m) * co + n;
  if (e.bias) {
    v0 += e.bias[n];
    v1 += e.bias[n + 1];
  }
  if (e.z) *reinterpret_cast<float2*>(static_cast<float*>(e.z) + i) = make_float2(v0, v1);
  v0 = activate(e, n, v0);
  v1 = activate(e, n + 1, v1);
  if (e.res) {
    const float2 r = *reinterpret_cast<const float2*>(static_cast<const float*>(e.res) + i);
    v0 += r.x;
    v1 += r.y;
  }
  *reinterpret_cast<float2*>(y + i) = make_float2(v0, v1);
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
// fp32: the same persistent GEMM on the TF32 tensor cores, three passes
// ---------------------------------------------------------------------------
namespace tf {
constexpr int BN = 128;                   // output channels per tile (acc + tot: 128 registers)
constexpr int BK = 32;                    // input channels per stage: one 128-byte row of fp32
constexpr int A_BYTES = wg::BM * BK * 4;  // one activation plane's box, 16 KB
constexpr int W_BYTES = BN * BK * 4;      // one weight plane's box, 16 KB
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * W_BYTES;
constexpr int STAGES = 3;                 // 192 KB of ring
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
static_assert(A_BYTES % 1024 == 0 && W_BYTES % 1024 == 0, "swizzled boxes on 1024-byte lines");
}  // namespace tf

// The pre-pass: the TF32 split of x (nx values) and of the K-major weights
// (nw values; both counts multiples of 4, both 16-byte aligned), hi =
// tf32(a) and lo = tf32(a - hi) (rn::tf32_split): x's hi planes at dst,
// its lo planes nx values later, then the weights' the same way from dst +
// 2 nx.
__global__ void __launch_bounds__(256) tf32_split_kernel(const float* __restrict__ x, long long nx,
                                                        const float* __restrict__ w, long long nw,
                                                        float* __restrict__ dst) {
  const long long n4 = (nx + nw) / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool is_x = i < nx / 4;
    const long long j = is_x ? i : i - nx / 4;
    const float4 v = reinterpret_cast<const float4*>(is_x ? x : w)[j];
    float* base = is_x ? dst : dst + 2 * nx;
    uint4 hi, lo;
    rn::tf32_split(v.x, hi.x, lo.x);
    rn::tf32_split(v.y, hi.y, lo.y);
    rn::tf32_split(v.z, hi.z, lo.z);
    rn::tf32_split(v.w, hi.w, lo.w);
    reinterpret_cast<uint4*>(base)[j] = hi;
    reinterpret_cast<uint4*>(base + (is_x ? nx : nw))[j] = lo;
  }
}

// As conv2d_wgmma_kernel, on the TF32 split planes of x ([H][W * B][C] hi
// and lo maps) and of the weights (K-major, one map [18][co][C]: taps 0-8
// hi, 9-17 lo): a
// stage is one tap's 32 channels, the activation boxes of both planes (128
// pixels each) and the two weight boxes (128 output channels each; CTA
// rank r loads plane r, multicast into both CTAs). Per stage and k8 slice
// three wgmma.m64n128k8 TF32, hi.hi + hi.lo + lo.hi. The accumulators
// restart every `chain` stages; the chains' sums are added in fp32 in
// `tot`, in stage order, and the epilogue runs on that total.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(wg::THREADS, 1)
    conv2d_tf32_kernel(const __grid_constant__ CUtensorMap xhi,
                       const __grid_constant__ CUtensorMap xlo,
                       const __grid_constant__ CUtensorMap wmap, float* __restrict__ y, Geom g,
                       Epi e, int tiles_per_row, int chain) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + tf::STAGES * tf::STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * tf::STAGES;               // empty[s]: empty + 8 s
  const int wb = g.W * g.B;
  const int ntiles_n = g.co / tf::BN;
  const int npairs = (g.H * tiles_per_row + 1) / 2 * ntiles_n;
  const int nc = g.C / tf::BK;  // channel chunks per tap
  const int nk = 9 * nc;        // stages per tile
  const int cluster = blockIdx.x / 2, nclusters = gridDim.x / 2;
  const uint32_t rank = rn::cluster_rank();
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < tf::STAGES; ++s) {
      rn::mbar_init(full + 8 * s, 1);
      rn::mbar_init(empty + 8 * s, wg::RELEASES);
    }
    rn::fence_mbar_init();
  }
  rn::cluster_sync();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      int it = 0;
      for (int q = cluster; q < npairs; q += nclusters) {
        const Tile tl = tile_of(q, rank, tiles_per_row, ntiles_n, tf::BN);
        for (int k = 0; k < nk; ++k, ++it) {
          const int tap = k / nc, c0 = (k - tap * nc) * tf::BK;
          const int ky = tap / 3, kx = tap - 3 * ky;
          const uint32_t slot = it % tf::STAGES;
          if (it >= tf::STAGES) rn::mbar_wait(empty + 8 * slot, ((it / tf::STAGES) - 1) & 1);
          const uint32_t st = ring + slot * tf::STAGE_BYTES, bar = full + 8 * slot;
          rn::mbar_expect_tx(bar, tf::STAGE_BYTES);
          const int m = tl.m0 + (kx - 1) * g.B, h = tl.h + ky - 1;
          rn::tma_load_3d(st, &xhi, c0, m, h, bar);
          rn::tma_load_3d(st + tf::A_BYTES, &xlo, c0, m, h, bar);
          rn::tma_load_3d_multicast(st + 2 * tf::A_BYTES + rank * tf::W_BYTES, &wmap, c0, tl.n0,
                                    9 * rank + tap, bar, 3);
        }
      }
      for (int d = 0; d < tf::STAGES; ++d, ++it)
        if (it >= tf::STAGES)
          rn::mbar_wait(empty + 8 * (it % tf::STAGES), ((it / tf::STAGES) - 1) & 1);
    }
    return;
  }

  const int wgi = warp / 4;
  const uint32_t lane = threadIdx.x % 32;
  const int row = wgi * 64 + (warp % 4) * 16 + static_cast<int>(lane) / 4;
  const uint32_t peer_empty = rn::cluster_address(empty, rank ^ 1);
  float acc[tf::BN / 2], tot[tf::BN / 2];
#pragma unroll
  for (int i = 0; i < tf::BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int q = cluster; q < npairs; q += nclusters) {
    const Tile tl = tile_of(q, rank, tiles_per_row, ntiles_n, tf::BN);
    for (int k0 = 0; k0 < nk; k0 += chain) {
      const int k1 = k0 + chain < nk ? k0 + chain : nk;
      for (int k = k0; k < k1; ++k, ++it) {
        const uint32_t slot = it % tf::STAGES;
        rn::mbar_wait(full + 8 * slot, (it / tf::STAGES) & 1);
        const uint32_t st = ring + slot * tf::STAGE_BYTES;
        const uint64_t ah = rn::sw128_desc(st + wgi * (tf::A_BYTES / 2));
        const uint64_t al = rn::sw128_desc(st + tf::A_BYTES + wgi * (tf::A_BYTES / 2));
        const uint64_t bh = rn::sw128_desc(st + 2 * tf::A_BYTES);
        const uint64_t bl = rn::sw128_desc(st + 2 * tf::A_BYTES + tf::W_BYTES);
        rn::wgmma_fence();
#pragma unroll
        for (int j = 0; j < tf::BK / 8; ++j)
          rn::wgmma_tf32x3<tf::BN>(acc, ah + 2 * j, al + 2 * j, bh + 2 * j, bl + 2 * j,
                                   (k - k0) | j);
        rn::wgmma_commit();
        rn::wgmma_wait<1>();  // stage it - 1's group has retired: release its slot
        if (k > k0) {
          const uint32_t off = 8 * ((it - 1) % tf::STAGES);
          rn::mbar_arrive_pair_lane0(empty + off, peer_empty + off, lane);
        }
      }
      rn::wgmma_wait<0>();
      const uint32_t off = 8 * ((it - 1) % tf::STAGES);
      rn::mbar_arrive_pair_lane0(empty + off, peer_empty + off, lane);
      rn::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < tf::BN / 2; ++i) tot[i] = k0 == 0 ? acc[i] : tot[i] + acc[i];
    }
    if (tl.h >= g.H) continue;  // the odd pixel tile's partner
    const int m = tl.m0 + row;
    const int p = tl.h * wb + m;
    const int n = tl.n0 + 2 * static_cast<int>(lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (m + 8 * h >= wb) continue;
#pragma unroll
      for (int j = 0; j < tf::BN / 8; ++j)
        epilogue2(e, y, p + 8 * h, n + 8 * j, g.co, tot[4 * j + 2 * h], tot[4 * j + 2 * h + 1]);
    }
  }
}

// The fp32 form: x and w split into TF32 hi / lo planes in `split` (x's
// [2][H * W * B][C], then w's [2][9][co][C]), then the GEMM on their maps
// (boxes of 32 channels x 128 pixels or output channels x 1, 128-byte
// swizzle, zeros past every edge).
int launch_tf32(const float* x, const float* w, float* split, float* y, const Geom& g,
                const Epi& e, int grid, int chain, cudaStream_t s) {
  const long long wb = static_cast<long long>(g.W) * g.B;
  const long long nx = static_cast<long long>(g.M) * g.C, nw = 9LL * g.co * g.C;
  float* xs = split;
  float* ws = split + 2 * nx;
  const long long blocks = ((nx + nw) / 4 + 255) / 256;
  tf32_split_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      x, nx, w, nw, split);
  const long long xdims[3] = {g.C, wb, g.H}, xstr[2] = {4LL * g.C, 4LL * g.C * wb};
  const long long wdims[3] = {g.C, g.co, 18}, wstr[2] = {4LL * g.C, 4LL * g.co * g.C};
  const int xbox[3] = {tf::BK, wg::BM, 1}, wbox[3] = {tf::BK, tf::BN, 1};
  CUtensorMap xhi, xlo, wmap;
  if (!rn::make_f32_map(&xhi, xs, 3, xdims, xstr, xbox) ||
      !rn::make_f32_map(&xlo, xs + nx, 3, xdims, xstr, xbox) ||
      !rn::make_f32_map(&wmap, ws, 3, wdims, wstr, wbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      conv2d_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tf::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int pairs = rn::max_active_pairs(conv2d_tf32_kernel, wg::THREADS, tf::SMEM);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid = grid < 2 * pairs ? grid : 2 * pairs;
  const int tiles_per_row = static_cast<int>((wb + wg::BM - 1) / wg::BM);
  conv2d_tf32_kernel<<<grid, wg::THREADS, tf::SMEM, s>>>(xhi, xlo, wmap, y, g, e, tiles_per_row,
                                                         chain);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [H, W, B, C], w (16-byte aligned, in the storage type): bf16 [3, 3, C,
// co] as it lies, fp32 K-major [9][co][C] (cuda_conv2d.kernel_weights);
// bias, alpha: fp32 [co] or null (alpha required for act 1); res, y, z:
// [H, W, B, co] in the storage type (res and z may be null). C % 32 == 0,
// co % 128 == 0. grid: the persistent CTAs, an even count (2 per cluster;
// cuda_conv2d.conv2d_plan), cut to the clusters the card can hold at once.
// fp32: split, the scratch for the TF32 planes (2 (H W B C + 9 co C)
// floats), and chain, the stages per accumulator chain.
extern "C" int rn_conv2d(const void* x, const void* w, const void* bias, const void* alpha,
                         const void* res, void* y, void* z, void* split, int dtype, int act,
                         int H, int W, int B, int C, int co, int grid, int chain, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(H) * W * B;
  if (C <= 0 || C % 32 || co <= 0 || co % 128 || act < 0 || act > 2 || (act == 1 && !alpha) ||
      M <= 0 || M >= (1LL << 31) || grid < 2 || grid % 2 || (dtype == 0 && (!split || chain < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{H, W, B, C, co, static_cast<int>(M)};
  const Epi e{static_cast<const float*>(bias), static_cast<const float*>(alpha), res, z, act};
  if (dtype == 0)
    return launch_tf32(static_cast<const float*>(x), static_cast<const float*>(w),
                       static_cast<float*>(split), static_cast<float*>(y), g, e, grid, chain, s);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  return co % 256 == 0 ? launch_wgmma<256>(x, w, yb, g, e, grid, s)
                       : launch_wgmma<128>(x, w, yb, g, e, grid, s);
}
