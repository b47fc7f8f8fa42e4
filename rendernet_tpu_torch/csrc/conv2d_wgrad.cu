// K5w: weight gradient of K5's SAME, stride-1, 3x3 HWNC convolution:
//   gw[ky, kx, c, n] = sum over pixels (h, w, b) of
//                      xpad[h + ky, w + kx, b, c] * gz[h, w, b, n]
// x [H, W, B, C], gz [H, W, B, co], gw [3, 3, C, co] in fp32.
//
// Replaces rendernet_tpu/ops/pallas_conv2d.py:_wgrad_kernel (reached through
// pl.pallas_call in _wgrad, from the custom VJPs' backward). The TPU kernel
// sums into a pinned [3, 3, C, bn] VMEM block across its sequential
// (batch, row) grid; Hopper's blocks run in no order. So the pixels are
// split into parts: each part's fp32 partial sums go to a workspace and a
// second kernel adds the parts in a fixed order (no atomics: the result
// repeats bit for bit). With one part the kernel writes the result.
//
// As a GEMM: rows (tap, c) = 9 C, columns co, reduced over all H W B
// pixels (98,304 for the training step's res2 at batch 24). Bound:
// operations, 2 * H W B * 9 C * co flops (1.86e12 at res2, batch 24: 1.88
// ms at 989 TFLOP/s bf16).
//
// bf16 (the main path): a persistent, warp-specialized wgmma GEMM fed by
// TMA (wgrad_wgmma_kernel), built like K5's (csrc/conv2d.cu) with the
// roles of the operands turned round. One CTA per SM, in clusters of two;
// cluster k walks work items k, k + clusters, ...; an item is (part, pair
// of row pairs, output tile), a row pair per CTA, the two sharing the
// cotangent boxes (each CTA loads half of them, multicast into both). A
// CTA's share of an item:
//   * rows: 128 of the 9 C, two 64-channel row blocks taken in (channel
//     block, tap) order, so that a CTA mostly holds two taps of one channel
//     block and each cotangent box it loads feeds both. More taps per CTA
//     would need more accumulators than the 2 x 64 x BN fp32 that two
//     consumer warpgroups hold (BN / 2 = 128 registers a thread at BN =
//     256, of the 168 that ptxas gives these kernels);
//   * columns: BN = 256 output channels where co % 256 == 0, else 128;
//   * K: the part's pixels, 64 a step, along one image row h at a time
//     (the last step of a row masked: its cotangent box reads zeros past
//     W * B). The plan (parts, grid) comes from cuda_conv2d.wgrad_plan.
// Operands: x through the same 3-D tensor map as K5's ([H][W * B][C]) with
// a box of 64 channels x 64 pixels, so tap (ky, kx) reads the box at (c0,
// m0 + (kx - 1) B, h + ky - 1) and TMA's zero fill is the SAME halo; gz
// through a map [H][W * B][co] with boxes of 64 output channels x 64
// pixels. Both are MN-major in shared memory (channels contiguous, pixels
// down the rows), read with wgmma's two transpose bits, no ldmatrix.trans
// copy. Pipeline and release as in K5: a producer warp fills a ring of
// STAGES stages (two 8 KB activation boxes + BN / 64 cotangent boxes, half
// of them from the peer CTA), each of warpgroups 0 and 1 runs 4
// wgmma.m64nBNk16 per stage on its row block and releases the stage on
// both CTAs' empty barriers.
// Accumulator chains: an fp32 accumulator's error grows with the length of
// its serial sum (on an H100 one chain over all 98,304 pixels of a
// batch-24 res2 step missed the 1e-4 of max|gw| that the kernel checks
// allow). So the accumulators restart every <= 8,192 pixels (128 steps):
// a CTA splits its item into that many equal chains, stores the first
// chain's sums into its partial and adds each later chain's to it, in
// order, from the same threads.
// fp32 (wgrad_tf32_kernel): the same items, parts, chains and pipeline with
// every product on the TF32 tensor cores as three passes, hi.hi + hi.lo +
// lo.hi (hi = tf32(a), lo = tf32(a - hi)). TF32 wgmma has no transpose
// mode, so both shared-memory operands must be K-major, with the pixels
// along the rows: a pre-pass (tf32_split_cmajor) writes x and gz
// channel-major, [C][H][W Bp] and [co][H][W Bp] with the batch padded to
// Bp, a multiple of 4 (zeros), each as hi and lo planes (at res2 batch 8,
// 268 MB read and 537 MB written). x's 3-D map over that layout, boxes of
// 32 pixels x 1 row x 64 channels, reads tap (ky, kx) at a shift of (kx -
// 1) Bp along W Bp (now the inner axis: a TMA box's inner coordinate must
// fall on 16 bytes, hence Bp) and ky - 1 along H, so the zeros outside the
// image are still the SAME halo. A stage is 32 pixels
// (a k8 slice is 32 bytes of a 128-byte swizzled row): the two row
// blocks' boxes in both planes (32 KB) and the BN cotangent rows in both
// planes (BN / 64 boxes a plane, CTA rank r of the pair loading plane r
// into both), 96 KB at BN = 256, so two stages (three at BN = 128). The
// chains restart every cuda_conv2d.MAX_CHAIN_STEPS_F32 steps, its own
// length: the tensor cores' fp32 sums lose precision along a chain.
// Bound: three TF32 passes, 3 * 6.18e11 flops at res2 batch 8, 3.75 ms at
// 495 TFLOP/s.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

struct Geom {
  int H, W, B, C, co, M, parts;  // parts: pixel parts, added in order
};

// ---------------------------------------------------------------------------
// bf16: persistent wgmma GEMM fed by TMA
// ---------------------------------------------------------------------------
namespace wg {
constexpr int BKP = 64;                  // pixels per stage (the GEMM's K)
constexpr int BOX = 64 * BKP * 2;        // one 64-channel x 64-pixel box, 8 KB
constexpr int A_BYTES = 2 * BOX;         // the two row blocks' activation boxes
constexpr int THREADS = 288;             // warpgroups 0, 1 consume; warp 8 produces
// Arrivals that free a stage: every consumer warp of both CTAs of the pair
// (either CTA's multicast writes into both).
constexpr int RELEASES = 2 * 8;
constexpr int MAX_CHAIN_STEPS = 8192 / BKP;
template <int TN>
struct Cfg {
  static constexpr int STAGE_BYTES = A_BYTES + TN / 64 * BOX;
  static constexpr int STAGES = TN == 256 ? 4 : 6;  // 192 KB of ring either way
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzled boxes start on 1024-byte boundaries");
};
}  // namespace wg

// Work item q of the persistent walk as CTA `rank` of a cluster takes it
// (cuda_conv2d.wgrad_item): parts outermost, then pairs of row pairs, then
// output tiles; the CTA's row pair is 2 (pair index) + rank (past the last
// row pair, an odd count: 9 C / 128, its channels past C, zero-filled and
// not stored), both CTAs share the part and the output tile. Its steps are
// [s_begin, s_end) of the H * steps_per_row steps of the whole image.
struct Item {
  int p, rp, n0, s_begin, s_end;
};
__device__ __forceinline__ Item item_of(int q, int rank, int rpairs, int ntiles_n, int tn,
                                        int parts, int steps) {
  const int per_part = (rpairs + 1) / 2 * ntiles_n;
  const int p = q / per_part, r = q - p * per_part;
  return {p, 2 * (r / ntiles_n) + rank, (r % ntiles_n) * tn,
          static_cast<int>(static_cast<long long>(steps) * p / parts),
          static_cast<int>(static_cast<long long>(steps) * (p + 1) / parts)};
}

// Row block rb of the 9 C / 64: its tap and first channel.
__device__ __forceinline__ void row_block(int rb, int& tap, int& c0) {
  tap = rb % 9;
  c0 = (rb / 9) * 64;
}

template <int TN>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(wg::THREADS, 1)
    wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap gmap, float* __restrict__ dst,
                       Geom g) {
  using Cf = wg::Cfg<TN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + Cf::STAGES * Cf::STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * Cf::STAGES;               // empty[s]: empty + 8 s
  const int wb = g.W * g.B;
  const int steps_per_row = (wb + wg::BKP - 1) / wg::BKP;
  const int steps = g.H * steps_per_row;
  const int rpairs = 9 * g.C / 128, ntiles_n = g.co / TN;
  const int nitems = g.parts * ((rpairs + 1) / 2) * ntiles_n;
  const int cluster = blockIdx.x / 2, nclusters = gridDim.x / 2;
  const uint32_t rank = rn::cluster_rank();
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
      int it = 0;  // stages filled, over all items
      for (int q = cluster; q < nitems; q += nclusters) {
        const Item itm = item_of(q, rank, rpairs, ntiles_n, TN, g.parts, steps);
        int tap[2], c0[2];
        row_block(2 * itm.rp, tap[0], c0[0]);
        row_block(2 * itm.rp + 1, tap[1], c0[1]);
        for (int s = itm.s_begin; s < itm.s_end; ++s, ++it) {
          const int h = s / steps_per_row, m0 = (s - h * steps_per_row) * wg::BKP;
          const uint32_t slot = it % Cf::STAGES;
          // Slot reuse: both CTAs' consumers have released stage it - STAGES.
          if (it >= Cf::STAGES) rn::mbar_wait(empty + 8 * slot, ((it / Cf::STAGES) - 1) & 1);
          const uint32_t st = ring + slot * Cf::STAGE_BYTES, bar = full + 8 * slot;
          rn::mbar_expect_tx(bar, Cf::STAGE_BYTES);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ky = tap[r] / 3, kx = tap[r] - 3 * ky;
            rn::tma_load_3d(st + r * wg::BOX, &xmap, c0[r], m0 + (kx - 1) * g.B, h + ky - 1, bar);
          }
          // this CTA's half of the cotangent boxes, into both CTAs of the pair
#pragma unroll
          for (int b = 0; b < TN / 128; ++b) {
            const int qb = static_cast<int>(rank) * (TN / 128) + b;
            rn::tma_load_3d_multicast(st + wg::A_BYTES + qb * wg::BOX, &gmap, itm.n0 + 64 * qb,
                                      m0, h, bar, 3);
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

  // consumers: warpgroup wgi owns row block 2 rp + wgi of each item
  const int wgi = warp / 4;
  const uint32_t lane = threadIdx.x % 32;
  const int row = (warp % 4) * 16 + static_cast<int>(lane) / 4;
  // the peer CTA's empty[0], as a shared::cluster address
  const uint32_t peer_empty = rn::cluster_address(empty, rank ^ 1);
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  int it = 0;  // stages consumed, over all items
  for (int q = cluster; q < nitems; q += nclusters) {
    const Item itm = item_of(q, rank, rpairs, ntiles_n, TN, g.parts, steps);
    int tap, c0;
    row_block(2 * itm.rp + wgi, tap, c0);
    float* out = dst + static_cast<long long>(itm.p) * 9 * g.C * g.co +
                 (static_cast<long long>(tap) * g.C + c0 + row) * g.co + itm.n0 +
                 2 * static_cast<int>(lane % 4);
    const int len = itm.s_end - itm.s_begin;
    const int nchains = (len + wg::MAX_CHAIN_STEPS - 1) / wg::MAX_CHAIN_STEPS;
    for (int ch = 0; ch < nchains; ++ch) {
      const int nk = itm.s_begin + len * (ch + 1) / nchains - (itm.s_begin + len * ch / nchains);
      for (int k = 0; k < nk; ++k, ++it) {
        const uint32_t slot = it % Cf::STAGES;
        rn::mbar_wait(full + 8 * slot, (it / Cf::STAGES) & 1);
        const uint32_t st = ring + slot * Cf::STAGE_BYTES;
        const uint64_t da = rn::sw128_mn_desc(st + wgi * wg::BOX, wg::BOX);
        const uint64_t db = rn::sw128_mn_desc(st + wg::A_BYTES, wg::BOX);
        rn::wgmma_fence();
#pragma unroll
        for (int j = 0; j < wg::BKP / 16; ++j)
          rn::wgmma<TN, 1, 1>(acc, da + 128 * j, db + 128 * j, k | j);
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
      if (itm.rp >= rpairs) continue;  // the odd row pair's partner
      // rows row and row + 8 of the block, columns 8 j + 2 (lane % 4) (+ 1).
      // The first chain stores; each later one adds with red.global.add,
      // which returns nothing (no load latency), and, from the same thread
      // to the same address, lands in program order: the same sums in the
      // same order on every run.
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          float* o = out + 8LL * half * g.co + 8 * j;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (ch == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            rn::red_add(o, v0);
            rn::red_add(o + 1, v1);
          }
        }
    }
  }
}

// x as [H][W * B][C] and gz as [H][W * B][co], bf16, boxes of 64 channels x
// 64 pixels x 1 row, 128-byte swizzle, zeros past every edge.
template <int TN>
int launch_wgmma(const void* x, const void* gz, float* dst, const Geom& g, int grid,
                 cudaStream_t s) {
  using Cf = wg::Cfg<TN>;
  const long long wb = static_cast<long long>(g.W) * g.B;
  const long long xdims[3] = {g.C, wb, g.H}, xstr[2] = {2LL * g.C, 2LL * g.C * wb};
  const long long gdims[3] = {g.co, wb, g.H}, gstr[2] = {2LL * g.co, 2LL * g.co * wb};
  const int box[3] = {64, wg::BKP, 1};
  CUtensorMap xmap, gmap;
  if (!rn::make_bf16_map(&xmap, x, 3, xdims, xstr, box) ||
      !rn::make_bf16_map(&gmap, gz, 3, gdims, gstr, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_wgmma_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int pairs = rn::max_active_pairs(wgrad_wgmma_kernel<TN>, wg::THREADS, Cf::SMEM);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid = grid < 2 * pairs ? grid : 2 * pairs;
  wgrad_wgmma_kernel<TN><<<grid, wg::THREADS, Cf::SMEM, s>>>(xmap, gmap, dst, g);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// fp32: the same persistent GEMM on the TF32 tensor cores, three passes
// ---------------------------------------------------------------------------
namespace tf {
constexpr int BKP = 32;             // pixels per stage: one 128-byte row of fp32
constexpr int BOX = 64 * BKP * 4;   // one 64-channel x 32-pixel box, 8 KB
constexpr int A_BYTES = 4 * BOX;    // the two row blocks' hi and lo boxes
template <int TN>
struct Cfg {
  static constexpr int STAGE_BYTES = A_BYTES + 2 * (TN / 64) * BOX;
  static constexpr int STAGES = TN == 256 ? 2 : 3;  // 192 KB of ring either way
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzled boxes start on 1024-byte boundaries");
};
}  // namespace tf

// K5w's pre-pass: x [H][W B][C] and gz [H][W B][co] -> their TF32 splits,
// channel-major with the batch padded to Bp (a multiple of 4): x's hi as
// [C][H][Rp] (a row's pixel w Bp + b) and its lo after it, so [2 C][H][Rp],
// then gz's as [2 co][H][Rp]; zeros at b >= B and past W Bp (Rp, a
// multiple of 32). Block rows blockIdx.y < C / 32 take x, the others gz; a
// block turns a 32 x 32 (pixel, channel) tile through shared memory, so
// that reads run along the channels and writes along the pixels. A tap's
// shift along the pixels, (kx - 1) Bp, is then a multiple of 16 bytes,
// which a TMA box's inner coordinate must be (an illegal instruction
// otherwise).
__global__ void __launch_bounds__(256) tf32_split_cmajor(const float* __restrict__ x,
                                                        const float* __restrict__ gz,
                                                        float* __restrict__ dst, int W, int B,
                                                        int Bp, int C, int co, int Rp) {
  __shared__ float tile[32][33];
  const bool is_x = static_cast<int>(blockIdx.y) < C / 32;
  const float* __restrict__ src = is_x ? x : gz;
  const int S = is_x ? C : co;
  const int s0 = (is_x ? blockIdx.y : blockIdx.y - C / 32) * 32;
  const int r0 = blockIdx.x * 32, h = blockIdx.z, H = gridDim.z;
  if (!is_x) dst += 2LL * C * H * Rp;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int w = (r0 + i) / Bp, b = (r0 + i) - w * Bp;
    tile[i][tx] = w < W && b < B
                      ? src[((static_cast<long long>(h) * W + w) * B + b) * S + s0 + tx]
                      : 0.f;
  }
  __syncthreads();
  const long long plane = static_cast<long long>(S) * H * Rp;
  for (int i = ty; i < 32; i += 8) {
    uint32_t hi, lo;
    rn::tf32_split(tile[tx][i], hi, lo);
    const long long o = (static_cast<long long>(s0 + i) * H + h) * Rp + r0 + tx;
    dst[o] = __uint_as_float(hi);
    dst[plane + o] = __uint_as_float(lo);
  }
}

// As wgrad_wgmma_kernel, on the TF32 split planes, channel-major: x as a
// map [2 C][H][Rp] (hi, then lo from channel C) and gz as [2 co][H][Rp], a
// row's pixels w Bp + b, boxes of 32 pixels x 1 row x 64 channels (an odd
// row pair's partner, at channels past C, reads lo values or zeros and
// stores nothing). Both operands are then
// K-major (pixels along the 128-byte rows, TF32 wgmma has no transpose
// mode); tap (ky, kx) reads x's boxes at (m0 + (kx - 1) Bp, h + ky - 1,
// c0), so the zeros outside [0, W Bp) x [0, H) (TMA's fill, and the
// pre-pass's padding) are still the SAME halo, and padded pixels meet
// zero cotangents. A stage is 32 pixels: the CTA's two
// row blocks in both planes and the BN cotangent rows in both planes (CTA
// rank r of the pair loads plane r into both). Per stage and k8 slice
// three wgmma.m64nBNk8 TF32, hi.hi + hi.lo + lo.hi. Chains of at most
// `chain` steps, stored and added as in bf16.
template <int TN>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(wg::THREADS, 1)
    wgrad_tf32_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap gmap, float* __restrict__ dst, Geom g,
                      int chain) {
  using Cf = tf::Cfg<TN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + Cf::STAGES * Cf::STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * Cf::STAGES;               // empty[s]: empty + 8 s
  const int bp = (g.B + 3) / 4 * 4;
  const int steps_per_row = (g.W * bp + tf::BKP - 1) / tf::BKP;
  const int steps = g.H * steps_per_row;
  const int rpairs = 9 * g.C / 128, ntiles_n = g.co / TN;
  const int nitems = g.parts * ((rpairs + 1) / 2) * ntiles_n;
  const int cluster = blockIdx.x / 2, nclusters = gridDim.x / 2;
  const uint32_t rank = rn::cluster_rank();
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      rn::mbar_init(full + 8 * s, 1);
      rn::mbar_init(empty + 8 * s, wg::RELEASES);
    }
    rn::fence_mbar_init();
  }
  rn::cluster_sync();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      int it = 0;
      for (int q = cluster; q < nitems; q += nclusters) {
        const Item itm = item_of(q, rank, rpairs, ntiles_n, TN, g.parts, steps);
        int tap[2], c0[2];
        row_block(2 * itm.rp, tap[0], c0[0]);
        row_block(2 * itm.rp + 1, tap[1], c0[1]);
        for (int s = itm.s_begin; s < itm.s_end; ++s, ++it) {
          const int h = s / steps_per_row, m0 = (s - h * steps_per_row) * tf::BKP;
          const uint32_t slot = it % Cf::STAGES;
          if (it >= Cf::STAGES) rn::mbar_wait(empty + 8 * slot, ((it / Cf::STAGES) - 1) & 1);
          const uint32_t st = ring + slot * Cf::STAGE_BYTES, bar = full + 8 * slot;
          rn::mbar_expect_tx(bar, Cf::STAGE_BYTES);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int ky = tap[r] / 3, kx = tap[r] - 3 * ky;
            const int m = m0 + (kx - 1) * bp, hs = h + ky - 1;
            rn::tma_load_3d(st + r * tf::BOX, &xmap, m, hs, c0[r], bar);
            rn::tma_load_3d(st + (2 + r) * tf::BOX, &xmap, m, hs, g.C + c0[r], bar);
          }
          // this CTA's plane of the cotangent boxes, into both CTAs of the pair
#pragma unroll
          for (int b = 0; b < TN / 64; ++b)
            rn::tma_load_3d_multicast(st + tf::A_BYTES + (rank * (TN / 64) + b) * tf::BOX, &gmap,
                                      m0, h, rank * g.co + itm.n0 + 64 * b, bar, 3);
        }
      }
      for (int d = 0; d < Cf::STAGES; ++d, ++it)
        if (it >= Cf::STAGES)
          rn::mbar_wait(empty + 8 * (it % Cf::STAGES), ((it / Cf::STAGES) - 1) & 1);
    }
    return;
  }

  // consumers: warpgroup wgi owns row block 2 rp + wgi of each item
  const int wgi = warp / 4;
  const uint32_t lane = threadIdx.x % 32;
  const int row = (warp % 4) * 16 + static_cast<int>(lane) / 4;
  const uint32_t peer_empty = rn::cluster_address(empty, rank ^ 1);
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  for (int q = cluster; q < nitems; q += nclusters) {
    const Item itm = item_of(q, rank, rpairs, ntiles_n, TN, g.parts, steps);
    int tap, c0;
    row_block(2 * itm.rp + wgi, tap, c0);
    float* out = dst + static_cast<long long>(itm.p) * 9 * g.C * g.co +
                 (static_cast<long long>(tap) * g.C + c0 + row) * g.co + itm.n0 +
                 2 * static_cast<int>(lane % 4);
    const int len = itm.s_end - itm.s_begin;
    const int nchains = (len + chain - 1) / chain;
    for (int ch = 0; ch < nchains; ++ch) {
      const int nk = itm.s_begin + len * (ch + 1) / nchains - (itm.s_begin + len * ch / nchains);
      for (int k = 0; k < nk; ++k, ++it) {
        const uint32_t slot = it % Cf::STAGES;
        rn::mbar_wait(full + 8 * slot, (it / Cf::STAGES) & 1);
        const uint32_t st = ring + slot * Cf::STAGE_BYTES;
        const uint64_t ah = rn::sw128_desc(st + wgi * tf::BOX);
        const uint64_t al = rn::sw128_desc(st + (2 + wgi) * tf::BOX);
        const uint64_t bh = rn::sw128_desc(st + tf::A_BYTES);
        const uint64_t bl = rn::sw128_desc(st + tf::A_BYTES + (TN / 64) * tf::BOX);
        rn::wgmma_fence();
#pragma unroll
        for (int j = 0; j < tf::BKP / 8; ++j)
          rn::wgmma_tf32x3<TN>(acc, ah + 2 * j, al + 2 * j, bh + 2 * j, bl + 2 * j, k | j);
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
      if (itm.rp >= rpairs) continue;  // the odd row pair's partner
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          float* o = out + 8LL * half * g.co + 8 * j;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (ch == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            rn::red_add(o, v0);
            rn::red_add(o + 1, v1);
          }
        }
    }
  }
}

// The fp32 form: x and gz split into channel-major TF32 planes in `split`
// (x's [2 C][H][Rp], then gz's [2 co][H][Rp]; Bp = B rounded up to 4, Rp =
// W Bp rounded up to 32), then the GEMM on their maps (boxes of 32 pixels
// x 1 row x 64 channels, 128-byte swizzle, zeros past every edge).
template <int TN>
int launch_tf32(const float* x, const float* gz, float* split, float* dst, const Geom& g,
                int grid, int chain, cudaStream_t s) {
  using Cf = tf::Cfg<TN>;
  const int bp = (g.B + 3) / 4 * 4, rp = (g.W * bp + 31) / 32 * 32;
  tf32_split_cmajor<<<dim3(rp / 32, (g.C + g.co) / 32, g.H), 256, 0, s>>>(x, gz, split, g.W, g.B,
                                                                          bp, g.C, g.co, rp);
  const long long xdims[3] = {rp, g.H, 2 * g.C}, gdims[3] = {rp, g.H, 2 * g.co};
  const long long str[2] = {4LL * rp, 4LL * rp * g.H};
  const int box[3] = {tf::BKP, 1, 64};
  CUtensorMap xmap, gmap;
  if (!rn::make_f32_map(&xmap, split, 3, xdims, str, box) ||
      !rn::make_f32_map(&gmap, split + 2LL * g.C * g.H * rp, 3, gdims, str, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      wgrad_tf32_kernel<TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int pairs = rn::max_active_pairs(wgrad_tf32_kernel<TN>, wg::THREADS, Cf::SMEM);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid = grid < 2 * pairs ? grid : 2 * pairs;
  wgrad_tf32_kernel<TN><<<grid, wg::THREADS, Cf::SMEM, s>>>(xmap, gmap, dst, g, chain);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// x [H, W, B, C], gz [H, W, B, co] (one storage type, 16-byte aligned);
// part: the workspace of parts * 9 * C * co floats (unused with one part);
// out [3, 3, C, co] fp32. C % 128 == 0, co % 128 == 0. parts and grid come
// from cuda_conv2d.wgrad_plan: the pixel parts (at most the H * ceil(W B /
// 64) steps in bf16, H * ceil(W Bp / 32) in fp32) and the persistent CTAs, an
// even count (2 per cluster), cut to the clusters the card can hold at
// once. fp32: split, the scratch of the TF32 planes (2 (C + co) H Rp
// floats: launch_tf32), and chain, the most steps of an
// accumulator chain (bf16's is wg::MAX_CHAIN_STEPS).
extern "C" int rn_conv2d_wgrad(const void* x, const void* gz, void* part, void* out, void* split,
                               int dtype, int H, int W, int B, int C, int co, int parts, int grid,
                               int chain, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(H) * W * B;
  const long long steps = dtype == 0 ? H * ((W * ((B + 3LL) / 4 * 4) + tf::BKP - 1) / tf::BKP)
                                     : H * ((static_cast<long long>(W) * B + wg::BKP - 1) / wg::BKP);
  if (C <= 0 || C % 128 || co <= 0 || co % 128 || M <= 0 || M >= (1LL << 31) || parts < 1 ||
      parts > steps || grid < 2 || grid % 2 || H > 65535 ||
      (dtype == 0 && (!split || chain < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{H, W, B, C, co, static_cast<int>(M), parts};
  float* dst = static_cast<float*>(parts > 1 ? part : out);
  cudaError_t err;
  if (dtype == 0) {
    const float *xf = static_cast<const float*>(x), *gf = static_cast<const float*>(gz);
    float* sf = static_cast<float*>(split);
    err = static_cast<cudaError_t>(co % 256 == 0
                                       ? launch_tf32<256>(xf, gf, sf, dst, g, grid, chain, s)
                                       : launch_tf32<128>(xf, gf, sf, dst, g, grid, chain, s));
  } else {
    err = static_cast<cudaError_t>(co % 256 == 0 ? launch_wgmma<256>(x, gz, dst, g, grid, s)
                                                 : launch_wgmma<128>(x, gz, dst, g, grid, s));
  }
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const long long n = 9LL * C * co;
  wgrad_reduce_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, parts);
  return static_cast<int>(cudaGetLastError());
}
