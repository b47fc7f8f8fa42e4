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
// fp32: the CUDA-core kernel of the first port: a block owns one tap, 128
// input and 128 output channels over a chunk of pixels (the same chunk
// plan as the parts) and walks it 16 pixels a step, the shifted activation
// rows (zero outside the image) and the cotangent rows staged in shared
// memory with cp.async, each thread owning 8 input x 8 output channels.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // input channels (GEMM rows) per block
constexpr int BN = 128;  // output channels per block
constexpr int NT = 256;

struct Geom {
  int H, W, B, C, co, M, parts;  // parts: pixel parts (bf16) or chunks (fp32)
};

using rn::cp_async16;
using rn::cp_async_commit;
using rn::cp_async_wait;

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
  t.p_begin = static_cast<int>(static_cast<long long>(g.M) * chunk / g.parts);
  t.p_end = static_cast<int>(static_cast<long long>(g.M) * (chunk + 1) / g.parts);
  t.out = (static_cast<long long>(chunk) * 9 * g.C + static_cast<long long>(tap) * g.C + t.c0) *
              g.co + t.n0;
  return t;
}

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

}  // namespace

// x [H, W, B, C], gz [H, W, B, co] (one storage type, 16-byte aligned);
// part: the workspace of parts * 9 * C * co floats (unused with one part);
// out [3, 3, C, co] fp32. C % 128 == 0, co % 128 == 0. parts and grid come
// from cuda_conv2d.wgrad_plan: bf16, the pixel parts (at most the H *
// ceil(W B / 64) steps) and the persistent CTAs, an even count (2 per
// cluster), cut to the clusters the card can hold at once; fp32, the pixel
// chunks (the grid is one block per (tap, 128 x 128 tile, chunk), and
// `grid` is ignored).
extern "C" int rn_conv2d_wgrad(const void* x, const void* gz, void* part, void* out, int dtype,
                               int H, int W, int B, int C, int co, int parts, int grid,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long M = static_cast<long long>(H) * W * B;
  const long long steps = H * ((static_cast<long long>(W) * B + wg::BKP - 1) / wg::BKP);
  if (C <= 0 || C % BM || co <= 0 || co % BN || M <= 0 || M >= (1LL << 31) ||
      9LL * (C / BM) > 65535 || parts < 1 || parts > 65535 ||
      (dtype != 0 && (parts > steps || grid < 2 || grid % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geom g{H, W, B, C, co, static_cast<int>(M), parts};
  float* dst = static_cast<float*>(parts > 1 ? part : out);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(wgrad_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               f32::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    wgrad_f32_kernel<<<dim3(co / BN, 9 * (C / BM), parts), NT, f32::SMEM, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gz), dst, g);
    err = cudaGetLastError();
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
