// K3: Winograd F(2x2, 3x3) convolution, SAME, stride 1, NHWC.
//
// Replaces rendernet_tpu/ops/pallas_winograd.py:147 (_kernel, reached
// through pl.pallas_call in _wino_call_hwnc, entry wino_conv2d). For every
// 2x2 output tile: V = B^T d B over its 4x4 input tile in fp32, cast to the
// storage type; U = G w G^T in fp32, cast; 16 per-frequency GEMMs
// M[f] = V[f] @ U[f] with fp32 accumulation; Y = A^T M A in fp32, rounded
// once to the storage type. Those are the reference's rounding points; only
// the order of the fp32 sums in M and Y differs.
//
// bf16 (the main path): three kernels on one stream, one wrapper call.
//   k3_weight_transform  w [3,3,C,K] -> U [16,K,C]: K-major, so both GEMM
//                        operands are K-major and need no transpose mode.
//   k3_input_transform   x [B,H,W,C] -> V [16,T,C] (T = B*H/2*W/2 tiles),
//                        one thread per (tile, 8 channels), 16-byte loads
//                        and stores (winograd_transform.cuh, shared with
//                        K6).
//   k3_gemm_fold         one block per 128 tiles x 64 output channels: the
//                        16 GEMMs on wgmma fed by TMA, each folded into the
//                        2x2 output phases as soon as it is done.
//
// Why this shape (design (a) of the two considered). The TPU kernel keeps
// 16 fp32 [tiles, bn] accumulators in megabytes of VMEM and never writes V.
// Here a fold needs five accumulator sets live at once: this frequency's M
// and the four output phases (A holds 0 and +-1, so M[f] adds to or
// subtracts from 1, 2 or 4 of them, and frequencies (1|2, 1|2) touch all
// four). At 64 x 64 per warpgroup that is 160 fp32 registers a thread, and
// ptxas compiles a 384-thread kernel at 168 even where setmaxnreg raises
// the consumers' share at run time (so this kernel does not use it): about
// 900 bytes of the phases spill around the folds.
// 64 x 128 would need 320. So each consumer warpgroup runs
// wgmma.m64n64k16, and per 128 x 64 x 64 stage an SM's shared memory takes
// 24 KB of TMA writes and 32 KB of wgmma reads for 1 Mflop: at ~128 B/clk
// that allows ~57% of the tensor cores' rate: shared-memory bandwidth, not
// the tensor cores, caps this tile. Fusing the input
// transform into the GEMM (design (b)) would recompute V once per 64
// output channels on the CUDA cores (~8x the tensor cores' time per
// stage), so V goes through device memory once instead.
//
// Pipeline (k3_gemm_fold, 384 threads, clusters of 2 CTAs along the output
// channels). Warpgroup 2 is the producer: one thread walks (frequency,
// 64-channel chunk) and per stage loads its CTA's half of the V tile
// V[f][m0 + 64 r : +64, c : c+64] (8 KB) by TMA multicast into both CTAs of
// the pair and its own U tile U[f][n0 : n0+64, c : c+64] (8 KB), all with
// 128-byte swizzle, into a ring of STAGES = 6 stages (144 KB of shared
// memory) guarded by full/empty mbarriers. The pair shares its V tiles, so
// a block stage moves 16 KB, not 24 KB, from L2. Warpgroups 0 and 1 each run 4 wgmma.m64n64k16 per stage on their 64
// rows of the V tile and the shared U tile, keep one wgmma group in flight
// (more measured no faster), and release a stage to both CTAs once
// the group that read it has retired: lane 0 of each consumer warp arrives
// on both CTAs' empty barriers (16 releases per stage), by predicate and not
// by branch, because a branch on the thread index between a wgmma and its
// wait makes ptxas serialize every wgmma of the kernel (C7518). Six stages
// measured as fast as four or eight. Blocks are numbered with the K/64
// channel blocks of one tile block adjacent, so V tiles come from L2 after
// their first read. The TMA box zero-fills the rows past T (a ragged last
// tile block); the epilogue writes only tiles < T, two channels per store.
//
// Bound: operations. The 16 GEMMs do 2 * 16 * T * C * K flops (res2 at
// batch 8: T = 8192, C = K = 1024, 2.75e11 flops, 0.278 ms at 989 TFLOP/s
// bf16). Design (a) also writes and reads V: 2 * 16 * T * C * 2 bytes (537
// MB at res2 batch 8, 0.16 ms at 3.35 TB/s), and the transform kernels run
// before the GEMMs without overlap.
//
// fp32: the CUDA-core kernel (k3_fp32_kernel) of the first port, unchanged:
// a block owns one row of up to 32 tiles, 64 output channels and all 16
// frequencies, walks C in chunks of 16 (cp.async, double-buffered),
// transforms the slab to V in shared memory, and each thread accumulates 4
// tiles x 1 channel x 16 frequencies in registers. U is [16, C, K] there.
#include <utility>

#include "hopper.cuh"
#include "winograd_transform.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 storage: CUDA-core kernel
// ---------------------------------------------------------------------------
constexpr int TT = 32;   // Winograd tiles per block (along W)
constexpr int BN = 64;   // output channels per block
constexpr int CK = 16;   // input channels per chunk
constexpr int NT = 512;  // threads per block
constexpr int XW = 2 * TT + 2;
// Padded shared-memory row strides: the float4 reads of V are free of bank
// conflicts.
constexpr int VLD = TT + 8;  // V rows [16][CK][VLD]
constexpr int ULD = BN + 8;  // U rows [16][CK][ULD]
constexpr int XS = 4 * XW * CK, US = 16 * CK * ULD, VS = 16 * CK * VLD;
static_assert(TT * CK == NT, "one (tile, channel) of the input transform per thread");
// xs[2][4][XW][CK] and us[2][16][CK][ULD] (double-buffered, filled by
// cp.async), vs[16][CK][VLD].
constexpr size_t F32_SMEM = sizeof(float) * (2 * XS + 2 * US + VS);

using rn::cp_async16;
using rn::cp_async_commit;
using rn::cp_async_wait;
using rn::input_transform;

// U = G g G^T of one (c, k), g[r][s] = w[r, s, c, k], in fp32. The products
// are exact (G holds 0, +-1/2, 1), so only the sums round, left to right as
// in the plain version (ops/winograd.py:transform_weights).
__device__ __forceinline__ void weight_transform(const float g[3][3], float u[16]) {
  float t[4][3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    t[0][s] = g[0][s];
    t[1][s] = (g[0][s] * 0.5f + g[1][s] * 0.5f) + g[2][s] * 0.5f;
    t[2][s] = (g[0][s] * 0.5f + g[1][s] * -0.5f) + g[2][s] * 0.5f;
    t[3][s] = g[2][s];
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    u[4 * a + 0] = t[a][0];
    u[4 * a + 1] = (t[a][0] * 0.5f + t[a][1] * 0.5f) + t[a][2] * 0.5f;
    u[4 * a + 2] = (t[a][0] * 0.5f + t[a][1] * -0.5f) + t[a][2] * 0.5f;
    u[4 * a + 3] = t[a][2];
  }
}

__device__ __forceinline__ void store_tile(const float m[16], float* __restrict__ y, int b,
                                           int th, int tw, int n, int H, int W, int K) {
  float r0[4], r1[4];
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) {
    r0[k2] = (m[k2] + m[4 + k2]) + m[8 + k2];
    r1[k2] = (m[4 + k2] - m[8 + k2]) - m[12 + k2];
  }
  const float out[2][2] = {{(r0[0] + r0[1]) + r0[2], (r0[1] - r0[2]) - r0[3]},
                           {(r1[0] + r1[1]) + r1[2], (r1[1] - r1[2]) - r1[3]}};
#pragma unroll
  for (int p1 = 0; p1 < 2; ++p1)
#pragma unroll
    for (int p2 = 0; p2 < 2; ++p2) {
      const long long pix = (static_cast<long long>(b) * H + 2 * th + p1) * W + 2 * tw + p2;
      y[pix * K + n] = out[p1][p2];
    }
}

__global__ void __launch_bounds__(NT) k3_fp32_kernel(const float* __restrict__ x,
                                                     const float* __restrict__ u,
                                                     float* __restrict__ y, int H, int W, int C,
                                                     int K) {
  constexpr int EPV = 4;  // floats per 16-byte copy
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* us = xs + 2 * XS;
  float* vs = us + 2 * US;

  const int nw = W / 2;
  const int ngroups = (nw + TT - 1) / TT;
  const int tw0 = (blockIdx.x % ngroups) * TT;
  const int n0 = (blockIdx.x / ngroups) * BN;
  const int th = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* xb = x + static_cast<long long>(b) * H * W * C;

  // Stage channel chunk c0 into buffer st: the 4 x XW input slab (zeros
  // outside the image: the SAME halo) and the [16, CK, BN] slice of U.
  auto prefetch = [&](int c0, int st) {
    float* xd = xs + st * XS;
    float* ud = us + st * US;
    for (int i = tid; i < XS / EPV; i += NT) {
      const int e = i * EPV;
      const int c = e % CK, col = (e / CK) % XW, r = e / (CK * XW);
      const int hh = 2 * th - 1 + r, ww = 2 * tw0 - 1 + col;
      const bool in = hh >= 0 && hh < H && ww >= 0 && ww < W;
      const float* src = in ? xb + (static_cast<long long>(hh) * W + ww) * C + c0 + c : xb;
      cp_async16(xd + e, src, in ? 16 : 0);
    }
    for (int i = tid; i < 16 * CK * BN / EPV; i += NT) {
      const int e = i * EPV;
      const int n = e % BN, c = (e / BN) % CK, f = e / (BN * CK);
      cp_async16(ud + (f * CK + c) * ULD + n,
                 u + (static_cast<long long>(f) * C + c0 + c) * K + n0 + n, 16);
    }
    cp_async_commit();
  };

  float acc[4][16];  // [tile][frequency]
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int f = 0; f < 16; ++f) acc[t][f] = 0.f;

  const int nchunks = C / CK;
  prefetch(0, 0);
  for (int k = 0; k < nchunks; ++k) {
    const int st = k & 1;
    if (k + 1 < nchunks) {
      prefetch((k + 1) * CK, st ^ 1);  // overlaps this chunk's work
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {  // V for tile t, channel c
      const float* xc = xs + st * XS;
      const int t = tid / CK, c = tid % CK;
      float d[4][4], v[16];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) d[r][s] = xc[(r * XW + 2 * t + s) * CK + c];
      input_transform(d, v);
#pragma unroll
      for (int f = 0; f < 16; ++f) vs[(f * CK + c) * VLD + t] = v[f];
    }
    __syncthreads();
    const float* uc = us + st * US;
    // thread = (channel n, tiles 4tg..4tg+3); the 4 tiles' V values are
    // one float4 (a broadcast: a warp shares tg), U is conflict-free.
    const int n = tid % BN, tg = tid / BN;
#pragma unroll 1
    for (int c = 0; c < CK; ++c)
#pragma unroll
      for (int f = 0; f < 16; ++f) {
        const float uv = uc[(f * CK + c) * ULD + n];
        const float4 v4 = *reinterpret_cast<const float4*>(vs + (f * CK + c) * VLD + tg * 4);
        acc[0][f] = fmaf(v4.x, uv, acc[0][f]);
        acc[1][f] = fmaf(v4.y, uv, acc[1][f]);
        acc[2][f] = fmaf(v4.z, uv, acc[2][f]);
        acc[3][f] = fmaf(v4.w, uv, acc[3][f]);
      }
    __syncthreads();  // the next prefetch overwrites this chunk's buffers
  }

  const int n = tid % BN, tg = tid / BN;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (tw0 + tg * 4 + t < nw) store_tile(acc[t], y, b, th, tw0 + tg * 4 + t, n0 + n, H, W, K);
}

// U [16][C][K] for the fp32 kernel, one (c, k) per thread.
__global__ void k3_fp32_weights(const float* __restrict__ w, float* __restrict__ u,
                                long long ck) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= ck) return;
  float g[3][3], v[16];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int s = 0; s < 3; ++s) g[r][s] = w[(r * 3 + s) * ck + i];
  weight_transform(g, v);
#pragma unroll
  for (int f = 0; f < 16; ++f) u[f * ck + i] = v[f];
}

// ---------------------------------------------------------------------------
// bf16 storage: transforms, then wgmma + TMA GEMMs with the fold
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int GM = 128;  // tiles per block: two consumer warpgroups x 64
constexpr int GN = 64;   // output channels per block
constexpr int GK = 64;   // input channels per stage: one 128-byte swizzle row
constexpr int STAGES = 6;
constexpr int A_BYTES = GM * GK * 2;  // V tile, 16 KB (half of it loaded by each CTA of a pair)
constexpr int B_BYTES = GN * GK * 2;  // U tile, 8 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int GEMM_THREADS = 384;  // warpgroups 0, 1 consume; 2 produces
// Releases of a stage that its producer waits for: each consumer warp of
// both CTAs of the pair (either CTA's multicast writes into both).
constexpr int RELEASES = 2 * 8;
constexpr size_t GEMM_SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
static_assert(A_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
              "128-byte-swizzled tiles start on 1024-byte boundaries");

using rn::at;
using rn::fence_regs;
using rn::mbar_wait;
using rn::sw128_desc;
using rn::wgmma_commit;
using rn::wgmma_fence;
using rn::wgmma_wait;

template <int S>
__device__ __forceinline__ void fold_into(const float (&m)[32], float (&y)[32]) {
  if constexpr (S != 0) {
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = S > 0 ? y[i] + m[i] : y[i] - m[i];
  }
}

// A consumer warpgroup's state, per thread.
struct Consumer {
  uint32_t tiles;      // shared address of stage 0
  uint32_t full;       // shared address of full[0]; empty[0] follows STAGES later
  uint32_t peer_empty; // the peer CTA's empty[0], as a shared::cluster address
  uint32_t lane;
  int a_off, nk;
  int i;               // the next stage to consume, counted over all frequencies
  float acc[32];       // M of the current frequency
  float y[4][32];      // output phases p1 * 2 + p2

  // Frequency F: its GEMM over all C chunks, one wgmma group per stage with
  // one group left in flight, then the fold into the output phases.
  template <int F>
  __device__ __forceinline__ void frequency() {
    for (int kc = 0; kc < nk; ++kc, ++i) {
      const uint32_t slot = i % STAGES;
      mbar_wait(full + 8 * slot, (i / STAGES) & 1);
      const uint32_t st = tiles + slot * STAGE_BYTES;
      const uint64_t da = sw128_desc(st + a_off);
      const uint64_t db = sw128_desc(st + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < GK / 16; ++j) rn::wgmma<GN, 0, 0>(acc, da + 2 * j, db + 2 * j, kc | j);
      wgmma_commit();
      wgmma_wait<1>();  // stage i - 1's group has retired: release its slot
      if (kc > 0) release(i - 1);
    }
    wgmma_wait<0>();
    release(i - 1);
    fence_regs(acc);
    constexpr int k1 = F / 4, k2 = F % 4;
    fold_into<at(0, k1) * at(0, k2)>(acc, y[0]);
    fold_into<at(0, k1) * at(1, k2)>(acc, y[1]);
    fold_into<at(1, k1) * at(0, k2)>(acc, y[2]);
    fold_into<at(1, k1) * at(1, k2)>(acc, y[3]);
  }

  __device__ __forceinline__ void release(int j) {
    const uint32_t off = 8 * (STAGES + j % STAGES);
    rn::mbar_arrive_pair_lane0(full + off, peer_empty + off - 8 * STAGES, lane);
  }

  template <int... F>
  __device__ __forceinline__ void run(std::integer_sequence<int, F...>) {
    (frequency<F>(), ...);
  }
};

// Blocks come in clusters of two along the output channels: both CTAs of
// a pair own the same 128 tiles, and each loads half of every V tile and
// multicasts it to both, so a V tile leaves L2 once per pair.
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(GEMM_THREADS, 1)
    k3_gemm_fold(const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap umap,
                 bf16* __restrict__ y, int T, int H, int W, int C, int K) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = tiles + STAGES * STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * STAGES;            // empty[s]: empty + 8 s
  const int nblk_n = K / GN;
  const int n0 = (blockIdx.x % nblk_n) * GN;
  const int m0 = (blockIdx.x / nblk_n) * GM;
  const int nk = C / GK;
  const uint32_t rank = rn::cluster_rank();
  // The warpgroup index, broadcast from lane 0 so that the compiler sees
  // the branch between the roles as uniform across each warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rn::mbar_init(full + 8 * s, 1);
      rn::mbar_init(empty + 8 * s, RELEASES);
    }
    rn::fence_mbar_init();
  }
  // Both CTAs' barriers exist before either multicasts or arrives remotely.
  rn::cluster_sync();

  if (wg == 2) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 256) {
      const int total = 16 * nk;
      const uint32_t half = rank * (A_BYTES / 2);  // this CTA's half of each V tile
      const int m_half = m0 + GM / 2 * static_cast<int>(rank);
      for (int L = 0; L < total + STAGES; ++L) {
        const uint32_t slot = L % STAGES;
        // Slot reuse: both CTAs' consumers have released stage L - STAGES.
        // The last STAGES waits let every release, remote ones included,
        // land before this CTA exits.
        if (L >= STAGES) mbar_wait(empty + 8 * slot, ((L / STAGES) - 1) & 1);
        if (L >= total) continue;
        const uint32_t st = tiles + slot * STAGE_BYTES, bar = full + 8 * slot;
        const int c = (L % nk) * GK, f = L / nk;
        rn::mbar_expect_tx(bar, STAGE_BYTES);
        rn::tma_load_3d_multicast(st + half, &vmap, c, m_half, f, bar, 3);
        rn::tma_load_3d(st + A_BYTES, &umap, c, n0, f, bar);
      }
    }
  } else {
    Consumer g;
    g.tiles = tiles;
    g.full = full;
    g.peer_empty = rn::cluster_address(empty, rank ^ 1);
    g.lane = threadIdx.x % 32;
    g.a_off = wg * (A_BYTES / 2);
    g.nk = nk;
    g.i = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) g.y[p][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) g.acc[i] = 0.f;
    g.run(std::make_integer_sequence<int, 16>{});

    // wgmma's accumulator layout: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1) in registers
    // 4 j (+ 1) and 4 j + 2 (+ 1).
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    const int nh = H / 2, nw = W / 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = m0 + wg * 64 + warp * 16 + lane / 4 + 8 * half;
      if (t >= T) continue;
      const int tw = t % nw, th = (t / nw) % nh, b = t / (nw * nh);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const long long pix =
            (static_cast<long long>(b) * H + 2 * th + p / 2) * W + 2 * tw + p % 2;
        bf16* row = y + pix * K + n0 + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < GN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
              __floats2bfloat162_rn(g.y[p][4 * j + 2 * half], g.y[p][4 * j + 2 * half + 1]);
      }
    }
  }
}

// V [16][T][C] from x [B][H][W][C]: one thread per (tile, 8 channels), 16-
// byte loads and stores, zeros outside the image (the SAME halo); shared
// with K6 (winograd_transform.cuh).
__global__ void __launch_bounds__(256) k3_input_transform(const bf16* __restrict__ x,
                                                          bf16* __restrict__ v, int B, int H,
                                                          int W, int C) {
  rn::input_transform_at<bf16, 8, false>(
      x, v, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x, B, H, W, C);
}

// U [16][K][C] from w [3][3][C][K]: a block transposes a 32 x 32 (c, k)
// tile of all 9 taps through shared memory, so that reads run along k and
// writes along c.
__global__ void __launch_bounds__(256) k3_weight_transform(const bf16* __restrict__ w,
                                                           bf16* __restrict__ u, int C, int K) {
  __shared__ float tile[9][32][33];
  const int c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int e = threadIdx.x; e < 9 * 32 * 32; e += 256) {
    const int tap = e / 1024, cc = (e / 32) % 32, kk = e % 32;
    const long long src = (static_cast<long long>(tap) * C + c0 + cc) * K + k0 + kk;
    tile[tap][cc][kk] = __bfloat162float(w[src]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * 32; e += 256) {
    const int cc = e % 32, kk = e / 32;
    float g[3][3], v[16];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) g[r][s] = tile[r * 3 + s][cc][kk];
    weight_transform(g, v);
#pragma unroll
    for (int f = 0; f < 16; ++f)
      u[(static_cast<long long>(f) * K + k0 + kk) * C + c0 + cc] = __float2bfloat16_rn(v[f]);
  }
}

// A bf16 [16][rows][C] tensor as a 3D map with a box of 64 channels x
// box_rows rows x 1 frequency, 128-byte swizzle, zeros past the edges.
bool make_map(CUtensorMap* map, const void* base, long long rows, int C, int box_rows) {
  const long long dims[3] = {C, rows, 16}, strides[2] = {2LL * C, 2LL * rows * C};
  const int box[3] = {GK, box_rows, 1};
  return rn::make_bf16_map(map, base, 3, dims, strides, box);
}

int launch_bf16(const bf16* x, const bf16* w, bf16* u, bf16* v, bf16* y, int B, int H, int W,
                int C, int K, cudaStream_t s) {
  const long long T = static_cast<long long>(B) * (H / 2) * (W / 2);
  CUtensorMap vmap, umap;
  if (!make_map(&vmap, v, T, C, GM / 2) || !make_map(&umap, u, K, C, GN))
    return static_cast<int>(cudaErrorInvalidValue);
  k3_weight_transform<<<dim3(C / 32, K / 32), 256, 0, s>>>(w, u, C, K);
  const long long nthreads = T * (C / 8);
  k3_input_transform<<<static_cast<unsigned>((nthreads + 255) / 256), 256, 0, s>>>(x, v, B, H,
                                                                                    W, C);
  const cudaError_t err = cudaFuncSetAttribute(
      k3_gemm_fold, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(GEMM_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((T + GM - 1) / GM) * (K / GN);
  k3_gemm_fold<<<blocks, GEMM_THREADS, GEMM_SMEM, s>>>(vmap, umap, y, static_cast<int>(T), H, W,
                                                       C, K);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* x, const float* w, float* u, float* y, int B, int H, int W, int C,
               int K, cudaStream_t s) {
  const long long ck = static_cast<long long>(C) * K;
  k3_fp32_weights<<<static_cast<unsigned>((ck + 255) / 256), 256, 0, s>>>(w, u, ck);
  const cudaError_t err = cudaFuncSetAttribute(
      k3_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(F32_SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = W / 2;
  const dim3 grid(((nw + TT - 1) / TT) * (K / BN), H / 2, B);
  k3_fp32_kernel<<<grid, NT, F32_SMEM, s>>>(x, u, y, H, W, C, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C], w [3, 3, C, K], y [B, H, W, K], all 16-byte aligned; H, W
// even (the wrapper's envelope guarantees these). Scratch: fp32, u
// [16, C, K] and v unused, C % 16 == 0, K % 64 == 0; bf16, u [16, K, C]
// and v [16, B * H/2 * W/2, C], C % 64 == 0, K % 128 == 0.
extern "C" int rn_winograd(const void* x, const void* w, void* u, void* v, void* y, int dtype,
                           int B, int H, int W, int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(static_cast<const float*>(x), static_cast<const float*>(w),
                      static_cast<float*>(u), static_cast<float*>(y), B, H, W, C, K, s);
  return launch_bf16(static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                     static_cast<bf16*>(u), static_cast<bf16*>(v), static_cast<bf16*>(y), B, H,
                     W, C, K, s);
}
