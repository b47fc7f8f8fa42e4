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
// Three kernels on one stream, one wrapper call (bf16 first; fp32 below).
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
// fp32 (the render CLI, the fp32 forward and recon step, the gradient
// checks): the same three kernels on fp32 operands, with every product on
// the TF32 tensor cores as three passes. V [16, T, C] and U stay fp32, and
// M and Y are summed in fp32 (the reference's rounding points); only the
// products change. The weight transform writes U as its TF32 split, hi =
// tf32(u) and lo = tf32(u - hi), planes [2, 16, K, C] (small, so split
// once); V stays one fp32 plane (537 MB at res2 batch 8, twice that as two
// planes) and each consumer warp splits its rows of a stage in registers:
// ldmatrix moves the 32-bit values (an 8 x 4 tile per b16 8 x 8 matrix)
// straight into wgmma's register A layout, and per k8 slice three
// wgmma.m64n64k8 TF32, hi.hi + hi.lo + lo.hi, go into one fp32
// accumulator (3 * 2^-22 of each product, where bf16 passes would leave
// about 3 * 2^-16). TF32 wgmma has no transpose mode, so both operands are
// K-major, as in bf16. A k8 slice is the same 32 bytes of a 128-byte
// swizzled row as a bf16 k16 slice: a stage holds 32 channels, the V tile
// (16 KB) and U's hi and lo tiles (8 KB each), 32 KB, so six stages take
// 192 KB. A slice is one wgmma group, waited for before the next slice's
// split (ptxas serializes wgmma whose register operands are written while
// a group is in flight, and the fold's accumulators leave no room for
// larger groups): the two consumer warpgroups overlap each other's waits.
// The tensor cores' fp32 sums do not round to nearest at each step: their
// error grew with the chain (7e-6 of max|y| at res2 with one chain over
// all of C, half that at res3, and the fp32 forward's logits moved 7e-5 of
// their spread), so M restarts every stage (a chain of 12) and the stages'
// M are summed with ordinary fp32 adds before the frequency's fold (1.4e-6
// at res2; folding each stage's M into the phases instead gave the same
// error at 4.16 ms against 3.65).
// C % 32 != 0 (C % 16 is what the wrapper admits) reads zeros past C from
// both boxes; where K % 128 != 0 the last cluster's second CTA owns a block
// of channels past K, reads zeros for U and writes nothing.
// Bound: three TF32 passes, 3 * 2.75e11 flops at res2 batch 8, 1.67 ms at
// 495 TFLOP/s; V is written and read once in fp32 (1.07 GB, 0.32 ms).
#include <type_traits>
#include <utility>

#include "hopper.cuh"
#include "winograd_transform.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// The GEMMs with the fold, on wgmma fed by TMA
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int GM = 128;  // tiles per block: two consumer warpgroups x 64
constexpr int GN = 64;   // output channels per block
constexpr int ROW = 128; // bytes of a swizzled tile row: a stage's channels
constexpr int GEMM_THREADS = 384;  // warpgroups 0, 1 consume; 2 produces
// Releases of a stage that its producer waits for: each consumer warp of
// both CTAs of the pair (either CTA's multicast writes into both).
constexpr int RELEASES = 2 * 8;

// The GEMM's stage in each storage type: one 128-byte row of channels (64
// bf16 or 32 fp32), the V tile and one U tile, or in fp32 U's hi and lo.
template <bool F32>
struct Gemm {
  using T = typename std::conditional<F32, float, bf16>::type;
  static constexpr int GK = ROW / static_cast<int>(sizeof(T));  // input channels per stage
  static constexpr int A_BYTES = GM * ROW;  // V tile, 16 KB (each CTA of a pair loads half)
  static constexpr int U_BYTES = GN * ROW;  // a U tile, 8 KB
  static constexpr int STAGE_BYTES = A_BYTES + (F32 ? 2 : 1) * U_BYTES;
  static constexpr int STAGES = 6;
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * sizeof(uint64_t);
  static_assert(A_BYTES % 1024 == 0 && U_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "128-byte-swizzled tiles start on 1024-byte boundaries");
};

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
template <bool F32>
struct Consumer {
  using G = Gemm<F32>;
  uint32_t tiles;      // shared address of stage 0
  uint32_t full;       // shared address of full[0]; empty[0] follows STAGES later
  uint32_t peer_empty; // the peer CTA's empty[0], as a shared::cluster address
  uint32_t lane;
  int a_off, nk;
  int i;               // the next stage to consume, counted over all frequencies
  uint32_t a_row, a_x; // fp32: this lane's ldmatrix row (bytes) and its chunk swizzle
  float acc[32];       // M of the current frequency (fp32: of the current stage)
  float tot[32];       // fp32: M of the current frequency, summed over its stages
  float y[4][32];      // output phases p1 * 2 + p2

  // Frequency F: its GEMM over all C chunks, then the fold into the output
  // phases (fp32: M summed stage by stage in fp32 adds).
  template <int F>
  __device__ __forceinline__ void frequency() {
    if constexpr (F32) {
#pragma unroll
      for (int q = 0; q < 32; ++q) tot[q] = 0.f;
      for (int kc = 0; kc < nk; ++kc, ++i) {
        stage_tf32();
#pragma unroll
        for (int q = 0; q < 32; ++q) tot[q] += acc[q];
      }
      fold<F>(tot);
    } else {
      gemm_bf16();
      fold<F>(acc);
    }
  }

  template <int F>
  __device__ __forceinline__ void fold(const float (&m)[32]) {
    constexpr int k1 = F / 4, k2 = F % 4;
    fold_into<at(0, k1) * at(0, k2)>(m, y[0]);
    fold_into<at(0, k1) * at(1, k2)>(m, y[1]);
    fold_into<at(1, k1) * at(0, k2)>(m, y[2]);
    fold_into<at(1, k1) * at(1, k2)>(m, y[3]);
  }

  // bf16: one wgmma group per stage with one group left in flight.
  __device__ __forceinline__ void gemm_bf16() {
    for (int kc = 0; kc < nk; ++kc, ++i) {
      const uint32_t slot = i % G::STAGES;
      mbar_wait(full + 8 * slot, (i / G::STAGES) & 1);
      const uint32_t st = tiles + slot * G::STAGE_BYTES;
      const uint64_t da = sw128_desc(st + a_off);
      const uint64_t db = sw128_desc(st + G::A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < G::GK / 16; ++j) rn::wgmma<GN, 0, 0>(acc, da + 2 * j, db + 2 * j, kc | j);
      wgmma_commit();
      wgmma_wait<1>();  // stage i - 1's group has retired: release its slot
      if (kc > 0) release(i - 1);
    }
    wgmma_wait<0>();
    release(i - 1);
    fence_regs(acc);
  }

  // fp32, stage i: per k8 slice, this warp's 16 rows of V by ldmatrix,
  // split into hi and lo in registers, then hi.hi + hi.lo + lo.hi against
  // U's two tiles as one wgmma group, waited for before the next slice's
  // split: a split while a group is in flight makes ptxas serialize every
  // wgmma (C7513), and groups of 2 or 4 slices spill into serialization
  // (C7512). The registers stay reserved (fence_operand) until the wait. M
  // restarts here (a chain of one stage) for the caller to sum.
  __device__ __forceinline__ void stage_tf32() {
    const uint32_t slot = i % G::STAGES;
    mbar_wait(full + 8 * slot, (i / G::STAGES) & 1);
    const uint32_t st = tiles + slot * G::STAGE_BYTES;
    const uint64_t dh = sw128_desc(st + G::A_BYTES);
    const uint64_t dl = sw128_desc(st + G::A_BYTES + G::U_BYTES);
#pragma unroll
    for (int j = 0; j < G::GK / 8; ++j) {
      // 16-byte chunk 2 j (+ 1) of this lane's row, swizzled by row % 8
      uint32_t v[4], ah[4], al[4];
      rn::ldsm_x4_b32(v, st + a_off + a_row + ((2 * j ^ a_x) << 4));
#pragma unroll
      for (int e = 0; e < 4; ++e) rn::tf32_split(__uint_as_float(v[e]), ah[e], al[e]);
      wgmma_fence();
      rn::wgmma_m64n64k8_tf32(acc, ah, dh + 2 * j, j);
      rn::wgmma_m64n64k8_tf32(acc, ah, dl + 2 * j, 1);
      rn::wgmma_m64n64k8_tf32(acc, al, dh + 2 * j, 1);
      wgmma_commit();
      wgmma_wait<0>();
      rn::fence_operand(ah);
      rn::fence_operand(al);
    }
    release(i);  // every group that read this stage has retired
    fence_regs(acc);
  }

  __device__ __forceinline__ void release(int j) {
    const uint32_t off = 8 * (G::STAGES + j % G::STAGES);
    rn::mbar_arrive_pair_lane0(full + off, peer_empty + off - 8 * G::STAGES, lane);
  }

  template <int... F>
  __device__ __forceinline__ void run(std::integer_sequence<int, F...>) {
    (frequency<F>(), ...);
  }
};

// Blocks come in clusters of two along the output channels: both CTAs of
// a pair own the same 128 tiles, and each loads half of every V tile and
// multicasts it to both, so a V tile leaves L2 once per pair. The channel
// blocks per tile block are rounded up to an even count: where K % 128 != 0
// the last one lies past K (zeros from U's box, nothing written).
template <bool F32>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(GEMM_THREADS, 1)
    k3_gemm_fold(const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap umap,
                 typename Gemm<F32>::T* __restrict__ y, int T, int H, int W, int C, int K) {
  using G = Gemm<F32>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t tiles = (rn::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = tiles + G::STAGES * G::STAGE_BYTES;  // full[s]: full + 8 s
  const uint32_t empty = full + 8 * G::STAGES;               // empty[s]: empty + 8 s
  const int nblk_n = (K / GN + 1) & ~1;
  const int n0 = (blockIdx.x % nblk_n) * GN;
  const int m0 = (blockIdx.x / nblk_n) * GM;
  const int nk = (C + G::GK - 1) / G::GK;
  const uint32_t rank = rn::cluster_rank();
  // The warpgroup index, broadcast from lane 0 so that the compiler sees
  // the branch between the roles as uniform across each warp.
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
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
      const uint32_t half = rank * (G::A_BYTES / 2);  // this CTA's half of each V tile
      const int m_half = m0 + GM / 2 * static_cast<int>(rank);
      for (int L = 0; L < total + G::STAGES; ++L) {
        const uint32_t slot = L % G::STAGES;
        // Slot reuse: both CTAs' consumers have released stage L - STAGES.
        // The last STAGES waits let every release, remote ones included,
        // land before this CTA exits.
        if (L >= G::STAGES) mbar_wait(empty + 8 * slot, ((L / G::STAGES) - 1) & 1);
        if (L >= total) continue;
        const uint32_t st = tiles + slot * G::STAGE_BYTES, bar = full + 8 * slot;
        const int c = (L % nk) * G::GK, f = L / nk;
        rn::mbar_expect_tx(bar, G::STAGE_BYTES);
        rn::tma_load_3d_multicast(st + half, &vmap, c, m_half, f, bar, 3);
        rn::tma_load_3d(st + G::A_BYTES, &umap, c, n0, f, bar);
        if constexpr (F32)  // U's lo plane
          rn::tma_load_3d(st + G::A_BYTES + G::U_BYTES, &umap, c, n0, 16 + f, bar);
      }
    }
  } else {
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    Consumer<F32> g;
    g.tiles = tiles;
    g.full = full;
    g.peer_empty = rn::cluster_address(empty, rank ^ 1);
    g.lane = lane;
    g.a_off = wg * (G::A_BYTES / 2);
    g.nk = nk;
    g.i = 0;
    // ldmatrix: lanes 8 q .. 8 q + 7 address rows 8 (q % 2) + lane % 8 of
    // this warp's 16, in 16-byte chunk 2 j + q / 2 of the slice
    g.a_row = (16 * warp + 8 * ((lane / 8) & 1) + lane % 8) * ROW;
    g.a_x = ((lane / 8) >> 1) ^ (lane % 8);
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) g.y[p][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) g.acc[i] = 0.f;
    g.run(std::make_integer_sequence<int, 16>{});
    if (n0 >= K) return;

    // wgmma's accumulator layout: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1) in registers
    // 4 j (+ 1) and 4 j + 2 (+ 1).
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
        typename G::T* row = y + pix * K + n0 + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < GN / 8; ++j) {
          const float v0 = g.y[p][4 * j + 2 * half], v1 = g.y[p][4 * j + 2 * half + 1];
          if constexpr (F32)
            *reinterpret_cast<float2*>(row + 8 * j) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) = __floats2bfloat162_rn(v0, v1);
        }
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

// The same in fp32, V kept fp32: one thread per (tile, 4 channels).
__global__ void __launch_bounds__(256) k3_input_transform_f32(const float* __restrict__ x,
                                                              float* __restrict__ v, int B, int H,
                                                              int W, int C) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int nh = H / 2, nw = W / 2, cg = C / 4;
  const long long T = static_cast<long long>(B) * nh * nw;
  if (i >= T * cg) return;
  const int c = static_cast<int>(i % cg) * 4;
  const long long t = i / cg;
  const int tw = static_cast<int>(t % nw), th = static_cast<int>((t / nw) % nh);
  const int b = static_cast<int>(t / (static_cast<long long>(nw) * nh));
  float4 raw[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int hh = 2 * th - 1 + r, ww = 2 * tw - 1 + s;
      raw[r][s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        raw[r][s] = __ldg(reinterpret_cast<const float4*>(
            x + ((static_cast<long long>(b) * H + hh) * W + ww) * C + c));
    }
  float out[4][16];
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float d[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 q = raw[r][s];
        d[r][s] = ch == 0 ? q.x : ch == 1 ? q.y : ch == 2 ? q.z : q.w;
      }
    rn::input_transform(d, out[ch]);
  }
#pragma unroll
  for (int f = 0; f < 16; ++f)
    *reinterpret_cast<float4*>(v + (f * T + t) * C + c) =
        make_float4(out[0][f], out[1][f], out[2][f], out[3][f]);
}

// U from w [3][3][C][K]: a block transposes a 32 x 32 (c, k) tile of all 9
// taps through shared memory, so that reads run along k and writes along c.
// bf16: U [16][K][C]; fp32: U's TF32 split, planes hi [16][K][C] and lo
// [16][K][C] after it.
template <typename T>
__global__ void __launch_bounds__(256) k3_weight_transform(const T* __restrict__ w,
                                                           T* __restrict__ u, int C, int K) {
  __shared__ float tile[9][32][33];
  const int c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  for (int e = threadIdx.x; e < 9 * 32 * 32; e += 256) {
    const int tap = e / 1024, cc = (e / 32) % 32, kk = e % 32;
    const long long src = (static_cast<long long>(tap) * C + c0 + cc) * K + k0 + kk;
    tile[tap][cc][kk] = c0 + cc < C ? rn::to_f32(w[src]) : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * 32; e += 256) {
    const int cc = e % 32, kk = e / 32;
    if (c0 + cc >= C) continue;
    float g[3][3], v[16];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int s = 0; s < 3; ++s) g[r][s] = tile[r * 3 + s][cc][kk];
    weight_transform(g, v);
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      const long long o = (static_cast<long long>(f) * K + k0 + kk) * C + c0 + cc;
      if constexpr (std::is_same<T, float>::value) {
        uint32_t hi, lo;
        rn::tf32_split(v[f], hi, lo);
        u[o] = __uint_as_float(hi);
        u[16LL * K * C + o] = __uint_as_float(lo);
      } else {
        u[o] = __float2bfloat16_rn(v[f]);
      }
    }
  }
}

// A [planes][rows][C] tensor of the storage type as a 3D map with a box of
// one 128-byte row of channels x box_rows rows x 1 plane, 128-byte
// swizzle, zeros past the edges.
template <bool F32>
bool make_map(CUtensorMap* map, const void* base, long long rows, int C, int planes,
              int box_rows) {
  const int item = F32 ? 4 : 2;
  const long long dims[3] = {C, rows, planes};
  const long long strides[2] = {static_cast<long long>(item) * C, item * rows * C};
  const int box[3] = {ROW / item, box_rows, 1};
  return F32 ? rn::make_f32_map(map, base, 3, dims, strides, box)
             : rn::make_bf16_map(map, base, 3, dims, strides, box);
}

template <typename E>
int launch(const E* x, const E* w, E* u, E* v, E* y, int B, int H, int W, int C, int K,
           cudaStream_t s) {
  constexpr bool F32 = std::is_same<E, float>::value;
  using G = Gemm<F32>;
  const long long T = static_cast<long long>(B) * (H / 2) * (W / 2);
  CUtensorMap vmap, umap;
  if (!make_map<F32>(&vmap, v, T, C, 16, GM / 2) ||
      !make_map<F32>(&umap, u, K, C, F32 ? 32 : 16, GN))
    return static_cast<int>(cudaErrorInvalidValue);
  k3_weight_transform<E><<<dim3((C + 31) / 32, K / 32), 256, 0, s>>>(w, u, C, K);
  if constexpr (F32) {
    const long long nthreads = T * (C / 4);
    k3_input_transform_f32<<<static_cast<unsigned>((nthreads + 255) / 256), 256, 0, s>>>(
        x, v, B, H, W, C);
  } else {
    const long long nthreads = T * (C / 8);
    k3_input_transform<<<static_cast<unsigned>((nthreads + 255) / 256), 256, 0, s>>>(x, v, B, H,
                                                                                      W, C);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      k3_gemm_fold<F32>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(G::SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((T + GM - 1) / GM) * ((K / GN + 1) & ~1);
  k3_gemm_fold<F32><<<blocks, GEMM_THREADS, G::SMEM, s>>>(vmap, umap, y, static_cast<int>(T), H,
                                                          W, C, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, C], w [3, 3, C, K], y [B, H, W, K], all 16-byte aligned; H, W
// even (the wrapper's envelope guarantees these). Scratch: v [16, B * H/2 *
// W/2, C] in the storage type; u [16, K, C] in bf16 (C % 64 == 0, K % 128
// == 0), the hi and lo planes [2, 16, K, C] in fp32 (C % 16 == 0, K % 64 ==
// 0).
extern "C" int rn_winograd(const void* x, const void* w, void* u, void* v, void* y, int dtype,
                           int B, int H, int W, int C, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<float*>(u), static_cast<float*>(v), static_cast<float*>(y), B, H,
                  W, C, K, s);
  return launch(static_cast<const bf16*>(x), static_cast<const bf16*>(w), static_cast<bf16*>(u),
                static_cast<bf16*>(v), static_cast<bf16*>(y), B, H, W, C, K, s);
}
