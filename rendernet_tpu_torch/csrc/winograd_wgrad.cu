// K6: transform-domain weight gradient of the Winograd F(2x2, 3x3) conv
// (K3), SAME, stride 1, NHWC:
//   gU[f, c, k] = sum over 2x2 output tiles of V[f, tile, c] * dM[f, tile, k]
//   gw = G^T gU G  -> [3, 3, C, K] fp32
// for the 16 frequencies f, where V = B^T d B is K3's input transform of
// the tile's 4x4 input patch and dM spreads the tile's 2x2 block of gy over
// the 16 frequencies through A (the adjoint of K3's output transform); both
// in fp32 from the stored values, rounded once to the operand type.
//
// Replaces rendernet_tpu/ops/pallas_winograd.py:342 (_wgrad_kernel, reached
// through pl.pallas_call in _wino_wgrad). The TPU kernel pins the whole
// [16, C, bnk] fp32 gU block in VMEM across its sequential (batch, tile-row)
// grid and recomputes V and dM in VMEM. Hopper's blocks run in no order and
// an SM holds no 16 x C x K accumulator, so the work is cut the way K3's
// forward (csrc/winograd.cu, design (a)) and K5w (csrc/conv2d_wgrad.cu) cut
// theirs: transforms first, through device memory, then 16 GEMMs.
//
//   k6_input_transform  x  -> V  [P][16][T][C] bf16, T = B H/2 W/2 tiles in
//   k6_spread           gy -> dM [P][16][T][K] bf16  K3's order (b, th, tw);
//                       one thread per (tile, 4 or 8 channels), vector loads
//                       and stores (winograd_transform.cuh, K3's own input
//                       transform).
//   k6_gemm             gU[f] = V[f]^T dM[f]: M = C, N = K, reduced over T.
//   k6_fold             the parts' fp32 partials added in part order, then
//                       the fold G^T gU G, written as [3, 3, C, K] fp32.
//
// Operand forms. bf16 operands (WGRAD=True on bf16 activations): P = 1,
// V and dM rounded to bf16 as the reference rounds them. fp32 operands
// (WGRAD="fp32", or fp32 storage): P = 2, each value as two bf16 planes hi =
// bf16(v), lo = bf16(v - hi), and the GEMM runs three wgmma per k-step into
// one fp32 accumulator, hi.hi + hi.lo + lo.hi (the 3-pass product; the lo.lo
// term it drops, and lo's rounding, are about 2^-16 of each product).
//
// The GEMM (k6_gemm) is K5w's pipeline on plain 2-D operands: persistent,
// one CTA per SM in clusters of two, 288 threads (two consumer warpgroups,
// one producer warp). V[f] and dM[f] are read through one 3-D tensor map
// each ([16 P][T][C], [16 P][T][K]; plane lo of frequency f is map index 16
// + f) with boxes of 64 channels x BKP tiles, 128-byte swizzle: both
// operands are MN-major in shared memory (channels contiguous, tiles down
// the rows), read through wgmma's transpose bits. A work item is (part of
// T, frequency, pair of 128-channel C blocks, output tile of TN = 256
// channels, or 128 where K % 256 != 0); each CTA of a cluster takes one C
// block (its two warpgroups 64 channels each, m64nTNk16) and half of the
// dM boxes, multicast into both. Items are numbered parts outermost, then
// frequency, then the (C, K) tiles, so the clusters running at once hold
// the tiles of a few frequencies and walk T in step: V[f] and dM[f] (50 MB
// each at res2, batch 24) come from L2 after their first read. The TMA box
// zero-fills tiles past T (a ragged last step adds nothing) and channels
// past C (the partner of an odd last C block, which stores nothing).
// Fixed-order sums: the parts' fp32 partials are added in part order by
// k6_fold, and each item restarts its accumulators every <= 8,192 tiles
// (the first chain stores, later ones red.global.add from the same
// threads), so the result repeats bit for bit. The schedule is a table
// from cuda_winograd.wino_wgrad_table (items, then their chains in steps):
// the kernel decodes nothing but its rank's C block and a step's tiles.
//
// Bound: operations. The 16 GEMMs do 2 * 16 * T * C * K flops (res2 at
// batch 24: T = 24,576, C = K = 1024: 0.82 TFLOP, 0.834 ms at 989 TFLOP/s
// bf16), three times that in the split form. The transforms move x and gy
// once and write V and dM (805 MB each at res2 in bf16, twice that split),
// which the GEMM reads back about once.
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "winograd_transform.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CB = 128;                // C channels (GEMM rows) per CTA
constexpr int THREADS = 288;           // warpgroups 0, 1 consume; warp 8 produces
constexpr int RELEASES = 2 * 8;        // consumer warps of both CTAs of a pair
constexpr int ITEM_INTS = 6;           // cuda_winograd.WGRAD_ITEM_INTS

template <int TN, bool SPLIT>
struct Cfg {
  static constexpr int P = SPLIT ? 2 : 1;       // operand planes (hi, lo)
  static constexpr int BKP = SPLIT ? 32 : 64;   // tiles per stage (the GEMM's K)
  static constexpr int BOX = 64 * BKP * 2;      // 64 channels x BKP tiles, bf16
  static constexpr int A_BYTES = 2 * P * BOX;   // each warpgroup's V box per plane
  static constexpr int NB = TN / 64;            // dM boxes per plane
  static constexpr int STAGE_BYTES = A_BYTES + P * NB * BOX;
  static constexpr int STAGES = TN == 256 ? 4 : 6;  // 192 KB of ring in every form
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(BOX % 1024 == 0, "swizzled boxes start on 1024-byte boundaries");
};

struct Geom {
  int C, K, nitems;
};

// Work item q of the table (cuda_winograd.wino_wgrad_table): row q holds
// (part, frequency, C-block pair, n0, first chain, end chain); chain j's
// (first step, end step) follow the nitems rows. The CTA's C block is
// 2 (pair) + rank.
struct Item {
  int p, f, cb, n0, c_begin, c_end;
};
__device__ __forceinline__ Item item_of(const int* __restrict__ sched, int q, int rank) {
  const int* r = sched + ITEM_INTS * q;
  return {__ldg(r), __ldg(r + 1), 2 * __ldg(r + 2) + rank, __ldg(r + 3), __ldg(r + 4),
          __ldg(r + 5)};
}

template <int TN, bool SPLIT>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
    k6_gemm(const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap dmap,
            float* __restrict__ dst, const int* __restrict__ sched, Geom g) {
  using Cf = Cfg<TN, SPLIT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + Cf::STAGES * Cf::STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * Cf::STAGES;               // empty[s]: empty + 8 s
  const int cblocks = g.C / CB;
  const int* __restrict__ chains = sched + ITEM_INTS * g.nitems;
  const int cluster = blockIdx.x / 2, nclusters = gridDim.x / 2;
  const uint32_t rank = rn::cluster_rank();
  const int warp = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 32, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cf::STAGES; ++s) {
      rn::mbar_init(full + 8 * s, 1);
      rn::mbar_init(empty + 8 * s, RELEASES);
    }
    rn::fence_mbar_init();
  }
  // Both CTAs' barriers exist before either multicasts or arrives remotely.
  rn::cluster_sync();

  if (warp == 8) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      int it = 0;  // stages filled, over all items
      for (int q = cluster; q < g.nitems; q += nclusters) {
        const Item itm = item_of(sched, q, static_cast<int>(rank));
        for (int ch = itm.c_begin; ch < itm.c_end; ++ch) {
          const int s_end = __ldg(chains + 2 * ch + 1);
          for (int s = __ldg(chains + 2 * ch); s < s_end; ++s, ++it) {
            const int t0 = s * Cf::BKP;
            const uint32_t slot = it % Cf::STAGES;
            // Slot reuse: both CTAs' consumers have released stage it - STAGES.
            if (it >= Cf::STAGES) rn::mbar_wait(empty + 8 * slot, ((it / Cf::STAGES) - 1) & 1);
            const uint32_t st = ring + slot * Cf::STAGE_BYTES, bar = full + 8 * slot;
            rn::mbar_expect_tx(bar, Cf::STAGE_BYTES);
#pragma unroll
            for (int pl = 0; pl < Cf::P; ++pl) {
              // this CTA's V boxes, one per consumer warpgroup
#pragma unroll
              for (int w = 0; w < 2; ++w)
                rn::tma_load_3d(st + (w * Cf::P + pl) * Cf::BOX, &vmap, itm.cb * CB + 64 * w, t0,
                                itm.f + 16 * pl, bar);
              // this CTA's half of the dM boxes, into both CTAs of the pair
#pragma unroll
              for (int b = 0; b < Cf::NB / 2; ++b) {
                const int qb = static_cast<int>(rank) * (Cf::NB / 2) + b;
                rn::tma_load_3d_multicast(st + Cf::A_BYTES + (pl * Cf::NB + qb) * Cf::BOX, &dmap,
                                          itm.n0 + 64 * qb, t0, itm.f + 16 * pl, bar, 3);
              }
            }
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

  // consumers: warpgroup wgi owns channels cb * 128 + 64 wgi .. + 63 of each item
  const int wgi = warp / 4;
  const uint32_t lane = threadIdx.x % 32;
  const int row = (warp % 4) * 16 + static_cast<int>(lane) / 4;
  // the peer CTA's empty[0], as a shared::cluster address
  const uint32_t peer_empty = rn::cluster_address(empty, rank ^ 1);
  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  int it = 0;  // stages consumed, over all items
  for (int q = cluster; q < g.nitems; q += nclusters) {
    const Item itm = item_of(sched, q, static_cast<int>(rank));
    float* out = dst + static_cast<long long>(itm.p) * 16 * g.C * g.K +
                 (static_cast<long long>(itm.f) * g.C + itm.cb * CB + 64 * wgi + row) * g.K +
                 itm.n0 + 2 * static_cast<int>(lane % 4);
    for (int ch = itm.c_begin; ch < itm.c_end; ++ch) {
      const int nk = __ldg(chains + 2 * ch + 1) - __ldg(chains + 2 * ch);
      for (int k = 0; k < nk; ++k, ++it) {
        const uint32_t slot = it % Cf::STAGES;
        rn::mbar_wait(full + 8 * slot, (it / Cf::STAGES) & 1);
        const uint32_t st = ring + slot * Cf::STAGE_BYTES;
        const uint64_t da = rn::sw128_mn_desc(st + wgi * Cf::P * Cf::BOX, Cf::BOX);
        const uint64_t db = rn::sw128_mn_desc(st + Cf::A_BYTES, Cf::BOX);
        rn::wgmma_fence();
#pragma unroll
        for (int j = 0; j < Cf::BKP / 16; ++j) {
          rn::wgmma<TN, 1, 1>(acc, da + 128 * j, db + 128 * j, k | j);
          if constexpr (SPLIT) {
            // the lo planes: V's next box, dM's NB boxes later
            constexpr uint64_t lo_a = Cf::BOX >> 4, lo_b = (Cf::NB * Cf::BOX) >> 4;
            rn::wgmma<TN, 1, 1>(acc, da + 128 * j, db + lo_b + 128 * j, 1);
            rn::wgmma<TN, 1, 1>(acc, da + lo_a + 128 * j, db + 128 * j, 1);
          }
        }
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
      if (itm.cb >= cblocks) continue;  // the partner of an odd last C block
      // rows row and row + 8 of the warpgroup's 64, columns 8 j + 2 (lane %
      // 4) (+ 1); the first chain stores, each later one adds in order.
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < TN / 8; ++j) {
          float* o = out + 8LL * half * g.K + 8 * j;
          const float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
          if (ch == itm.c_begin) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            rn::red_add(o, v0);
            rn::red_add(o + 1, v1);
          }
        }
    }
  }
}

// The transforms, one thread each per (tile, CPT channels).
template <typename In, int CPT, bool SPLIT>
__global__ void __launch_bounds__(256) k6_input_transform(const In* __restrict__ x,
                                                          bf16* __restrict__ v, int B, int H,
                                                          int W, int C) {
  rn::input_transform_at<In, CPT, SPLIT>(
      x, v, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x, B, H, W, C);
}

template <typename In, int CPT, bool SPLIT>
__global__ void __launch_bounds__(256) k6_spread(const In* __restrict__ gy, bf16* __restrict__ dm,
                                                 int B, int H, int W, int K) {
  rn::cotangent_spread_at<In, CPT, SPLIT>(
      gy, dm, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x, B, H, W, K);
}

// gU[f][i] = sum over parts, in part order, of part[p][f][i] (i = c K + k);
// then gw[r][s][i] = sum_a G[a, r] sum_b G[b, s] gU[4 a + b][i] (G's rows
// (1, 0, 0), (1/2, 1/2, 1/2), (1/2, -1/2, 1/2), (0, 0, 1)).
__global__ void __launch_bounds__(256) k6_fold(const float* __restrict__ part,
                                               float* __restrict__ out, long long ck, int parts) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ck) return;
  float u[16];
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    float s = part[f * ck + i];
    for (int p = 1; p < parts; ++p) s += part[(static_cast<long long>(p) * 16 + f) * ck + i];
    u[f] = s;
  }
  float t[4][3];  // t[a][s] = sum_b G[b, s] u[4 a + b]
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const float* ua = u + 4 * a;
    t[a][0] = (ua[0] + 0.5f * ua[1]) + 0.5f * ua[2];
    t[a][1] = 0.5f * ua[1] - 0.5f * ua[2];
    t[a][2] = (0.5f * ua[1] + 0.5f * ua[2]) + ua[3];
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    out[(0 * 3 + s) * ck + i] = (t[0][s] + 0.5f * t[1][s]) + 0.5f * t[2][s];
    out[(1 * 3 + s) * ck + i] = 0.5f * t[1][s] - 0.5f * t[2][s];
    out[(2 * 3 + s) * ck + i] = (0.5f * t[1][s] + 0.5f * t[2][s]) + t[3][s];
  }
}

// V or dM, [16 P][T][N] bf16, as a 3-D map with boxes of 64 channels x BKP
// tiles x 1 plane-frequency, 128-byte swizzle, zeros past T.
bool make_map(CUtensorMap* map, const void* base, int planes, long long T, int N, int bkp) {
  const long long dims[3] = {N, T, 16LL * planes}, strides[2] = {2LL * N, 2LL * T * N};
  const int box[3] = {64, bkp, 1};
  return rn::make_bf16_map(map, base, 3, dims, strides, box);
}

template <typename In, bool SPLIT>
int launch_transforms(const void* x, const void* gy, bf16* v, bf16* dm, int B, int H, int W, int C,
                      int K, cudaStream_t s) {
  constexpr int CPT = (SPLIT || sizeof(In) == 4) ? 4 : 8;
  const long long T = static_cast<long long>(B) * (H / 2) * (W / 2);
  k6_input_transform<In, CPT, SPLIT><<<static_cast<unsigned>((T * (C / CPT) + 255) / 256), 256, 0,
                                       s>>>(static_cast<const In*>(x), v, B, H, W, C);
  k6_spread<In, CPT, SPLIT><<<static_cast<unsigned>((T * (K / CPT) + 255) / 256), 256, 0, s>>>(
      static_cast<const In*>(gy), dm, B, H, W, K);
  return static_cast<int>(cudaGetLastError());
}

template <int TN, bool SPLIT>
int launch_gemm(const bf16* v, const bf16* dm, float* dst, const int* sched, long long T,
                const Geom& g, int grid, cudaStream_t s) {
  using Cf = Cfg<TN, SPLIT>;
  CUtensorMap vmap, dmap;
  if (!make_map(&vmap, v, Cf::P, T, g.C, Cf::BKP) || !make_map(&dmap, dm, Cf::P, T, g.K, Cf::BKP))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      k6_gemm<TN, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize, Cf::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const int pairs = rn::max_active_pairs(k6_gemm<TN, SPLIT>, THREADS, Cf::SMEM);
  if (pairs < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  grid = grid < 2 * pairs ? grid : 2 * pairs;
  k6_gemm<TN, SPLIT><<<grid, THREADS, Cf::SMEM, s>>>(vmap, dmap, dst, sched, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C], gy [B, H, W, K] (one storage type, 16-byte aligned); H, W
// even, C % 128 == 0, K % 128 == 0 (the wrapper's envelope guarantees
// them). split: 1 for the hi / lo operand planes (fp32 operands; always
// with fp32 storage), 0 for bf16 operands. Scratch from the wrapper: v
// [P][16][T][C] and dm [P][16][T][K] bf16 (P = 1 + split), part [parts][16]
// [C][K] fp32; out is gw [3, 3, C, K] fp32. sched (device int32), parts,
// nitems and grid come from cuda_winograd: the schedule table
// (wino_wgrad_table, nitems item rows, then chains in steps of bkp tiles,
// which must be this form's BKP), the parts of T and the persistent CTAs,
// an even count, cut to the clusters the card can hold at once.
extern "C" int rn_wino_wgrad(const void* x, const void* gy, void* v, void* dm, void* part,
                             void* out, const void* sched, int dtype, int split, int bkp, int B,
                             int H, int W, int C, int K, int parts, int nitems, int grid,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long T = static_cast<long long>(B) * (H / 2) * (W / 2);
  if (H % 2 || W % 2 || C <= 0 || C % CB || K <= 0 || K % 128 || T <= 0 || T >= (1LL << 31) ||
      (dtype == 0 && !split) || bkp != (split ? Cfg<256, true>::BKP : Cfg<256, false>::BKP) ||
      parts < 1 || nitems < 1 || grid < 2 || grid % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* vb = static_cast<bf16*>(v);
  bf16* db = static_cast<bf16*>(dm);
  int rc;
  if (dtype == 0)
    rc = launch_transforms<float, true>(x, gy, vb, db, B, H, W, C, K, s);
  else if (split)
    rc = launch_transforms<bf16, true>(x, gy, vb, db, B, H, W, C, K, s);
  else
    rc = launch_transforms<bf16, false>(x, gy, vb, db, B, H, W, C, K, s);
  if (rc != 0) return rc;
  const Geom g{C, K, nitems};
  float* dst = static_cast<float*>(part);
  const int* tab = static_cast<const int*>(sched);
  const bool wide = K % 256 == 0;
  if (split)
    rc = wide ? launch_gemm<256, true>(vb, db, dst, tab, T, g, grid, s)
              : launch_gemm<128, true>(vb, db, dst, tab, T, g, grid, s);
  else
    rc = wide ? launch_gemm<256, false>(vb, db, dst, tab, T, g, grid, s)
              : launch_gemm<128, false>(vb, db, dst, tab, T, g, grid, s);
  if (rc != 0) return rc;
  const long long ck = static_cast<long long>(C) * K;
  k6_fold<<<static_cast<unsigned>((ck + 255) / 256), 256, 0, s>>>(dst, static_cast<float*>(out),
                                                                  ck, parts);
  return static_cast<int>(cudaGetLastError());
}
