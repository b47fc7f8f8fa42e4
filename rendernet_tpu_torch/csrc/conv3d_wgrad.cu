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
// fp32: the same walk, warps and register-resident sums on the TF32 tensor
// cores: mma.sync m16n8k8 with every product as three passes, hi.hi +
// hi.lo + lo.hi (hi = tf32(v), lo = tf32(v - hi), both operands split in
// registers: 3 * 2^-22 of each product), each rounding to nearest even
// (rn::tf32_split_rn: one F2FP instruction, where K2's cvt.rna takes four,
// and the splits are most of this kernel's instructions besides the mma).
// Shared memory decides the tile:
// the bf16 ring would double to 381 KB, so a row is F_TW = 4 W x 32 D
// positions and the ring holds F_RING = 5 slots (the row's three planes and
// two loading) of 6 x 34 x 32 + 4 x 32 x 32 fp32 values at 32 x 32 channels:
// 213 KB. Operand fragments: TF32's A (x^T, 16 channels x 8 positions) and
// B (gy, 8 positions x 8 channels) both run K along the positions while the
// planes lie channel-minor, and ldmatrix.trans transposes 16-bit elements
// only. So each lane loads its four A and two B values with scalar 32-bit
// ld.shared from rows swizzled by swz32, which puts the 4 positions x 8
// channels of one warp-wide load in 32 different banks at any row offset:
// the kd shift stays one row, as in bf16. Planes staged position-minor
// would give ldmatrix fragments, but its 16-byte row addresses cannot shift
// by one 4-byte position; staged as hi / lo planes they would double every
// slot, and no ring of four fits. So a value is split in registers (each A
// fragment feeds NF n8 blocks x 3 passes, each B fragment 3 kd x MF m16
// blocks). Per k8 slice of positions a warp issues 3 kd x MF x NF x 3 mma
// (72 at 32 x 32), pass by pass so that MF x NF independent sums (8 at 32 x
// 32) separate two products into one sum. Chains: the tensor cores' fp32 sums lose precision
// with the length of a chain (K2 fp32, K5w), and a CTA's share of the
// positions runs to ~8,000 at batch 8 and ~24,000 at batch 24. So each CTA
// cuts its rows into chains of at most `chain` rows (a row is 128
// positions; cuda_conv3d.WGRAD_CHAIN_ROWS_F32, chosen from chip_smoke.py's
// `chains` line); at a chain's end the sums go into part[cta], stored by the
// first chain and loaded, added and stored by each later one from the same
// thread (chain order on every run), and restart from zero. That needs no
// second set of sums in registers, and the workspace stays one [27, cpad,
// co] block per CTA: a block per chain, added by the reduce kernel, would
// multiply it by the chains (233 MB at batch 8 for chains of 4 rows).
// Wider shapes take the bf16 path's channel slices.
// Bound at res1 batch 8: 3 * 5.8e10 flops, 0.35 ms at 495 TFLOP/s TF32.
#include "conv3d_tile.cuh"
#include "hopper.cuh"

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
// fp32: TF32 tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int F_TW = 4;    // W positions of a row (rn3::TD along D)
constexpr int F_HW = F_TW + 2;
constexpr int F_RING = 5;  // ring slots: the row's three planes and two loading

template <int CS, int OS>
__host__ __device__ constexpr int tf32_slot_bytes() {
  return F_HW * rn3::HD * CS * 4 + F_TW * rn3::TD * OS * 4;
}

template <int CS, int OS>
constexpr int tf32_smem_bytes() {
  return 128 + F_RING * tf32_slot_bytes<CS, OS>();
}
static_assert(tf32_smem_bytes<32, 32>() <= 232448, "a CTA's shared memory");

// Byte offset of 16-byte chunk `chunk` (4 fp32 channels) of row `row` in
// rows of NCH chunks (4 or 8: 16 or 32 channels): each 8-channel pair of
// chunks is XORed with the row's position among four (row % 4 at 8 chunks,
// row / 2 % 2 with row % 2 picking the bank half at 4), so that the same 8
// channels of any 4 consecutive rows (one scalar load of an mma fragment)
// fall in 4 different groups of 8 banks.
template <int NCH>
__device__ __forceinline__ int swz32(int row, int chunk) {
  return (row * NCH + (chunk ^ (((row / (8 / NCH)) & (NCH / 2 - 1)) << 1))) * 16;
}

__device__ __forceinline__ float lds(const unsigned char* p) {
  return *reinterpret_cast<const float*>(p);
}

// One halo plane of channels [c0, c0 + 4 NCH) of x into a ring slot, laid
// out [w'][d'][chunk] (swz32): plane q of column c, zeros outside the volume
// and past C. VEC: C % 4 == 0, so each 16-byte chunk is wholly inside or
// outside and goes by cp.async; otherwise element by element.
template <int NCH, bool VEC>
__device__ __forceinline__ void load_plane_f32(const float* __restrict__ x, const rn3::Geom& g,
                                               const rn3::Column& c, int q, int c0,
                                               uint32_t dst, unsigned char* dstp, int tid) {
  const bool hin = q >= 0 && q < g.H;
  if constexpr (VEC) {
    for (int i = tid; i < F_HW * rn3::HD * NCH; i += MMA_THREADS) {
      const int ch = i % NCH, p = i / NCH;
      const int wi = c.w0 + p / rn3::HD - 1, di = c.d0 + p % rn3::HD - 1, cc = c0 + ch * 4;
      const bool ok = hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && cc < g.C;
      const float* src = ok ? x + rn3::pix(g, c.b, q, wi, di) * g.C + cc : x;
      rn3::cp_async16(dst + swz32<NCH>(p, ch), src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < F_HW * rn3::HD * NCH * 4; i += MMA_THREADS) {
      const int e = i % (NCH * 4), p = i / (NCH * 4);
      const int wi = c.w0 + p / rn3::HD - 1, di = c.d0 + p % rn3::HD - 1, cc = c0 + e;
      const bool ok = hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && cc < g.C;
      *reinterpret_cast<float*>(dstp + swz32<NCH>(p, e / 4) + (e % 4) * 4) =
          ok ? x[rn3::pix(g, c.b, q, wi, di) * g.C + cc] : 0.f;
    }
  }
}

// fp32 TF32 tensor-core kernel. Grid (parts, C slices of CS, co slices of
// OS), warp (kh, kw) owning taps (kh, kw, 0..2); part[blockIdx.x][27][cpad]
// [co] receives this CTA's sums for its slices, over its rows cut into
// chains of at most `chain` rows.
template <int CS, int OS, bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    conv3d_wgrad_tf32_kernel(const float* __restrict__ x, const float* __restrict__ gy,
                             float* __restrict__ part, rn3::Geom g, int co, int cpad, int parts,
                             int chain) {
  constexpr int NX = CS / 4, NG = OS / 4;    // 16-byte chunks per plane row, gy row
  constexpr int XB = NX * 16, GB = NG * 16;  // bytes per plane row, gy row
  constexpr int XBYTES = F_HW * rn3::HD * XB, SLOT = tf32_slot_bytes<CS, OS>();
  constexpr int MF = CS / 16, NF = OS / 8;   // m16 channel blocks of x^T, n8 blocks of gy
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((128 - (rn3::smem_u32(smem_raw) & 127)) & 127);
  const uint32_t ring_u = rn3::smem_u32(ring);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;  // fragment row group, thread in group
  const int kh = warp / 3, kw = warp % 3;
  const int c0 = blockIdx.y * CS, o0 = blockIdx.z * OS;

  float acc[3][MF][NF][4];
#pragma unroll
  for (int kd = 0; kd < 3; ++kd)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < NF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kd][mf][nf][e] = 0.f;

  // B fragments: this lane's values of n8 block nf are gy rows 8 k + tq and
  // 8 k + tq + 4 of a row block, channel 8 nf + gq. A row block starts at a
  // multiple of 4, where both swizzles repeat, so the offsets hold for all.
  int boff[NF];
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) boff[nf] = swz32<NG>(tq, 2 * nf) + 4 * gq;

  auto issue = [&](rn3::PlaneSeq& seq, int slot) {
    long long col;
    int q;
    bool own;
    if (!seq.next(col, q, own)) return false;
    const rn3::Column c = rn3::column<F_TW>(g, col);
    load_plane_f32<NX, VEC>(x, g, c, q, c0, ring_u + slot * SLOT, ring + slot * SLOT, tid);
    if (own) {
      const uint32_t dst = ring_u + slot * SLOT + XBYTES;
      for (int i = tid; i < F_TW * rn3::TD * NG; i += MMA_THREADS) {
        const int ch = i % NG, p = i / NG;
        const int wo = c.w0 + p / rn3::TD, dO = c.d0 + p % rn3::TD;
        const bool ok = wo < g.W && dO < g.D;
        const float* src = ok ? gy + rn3::pix(g, c.b, q, wo, dO) * co + o0 + ch * 4 : gy;
        rn3::cp_async16(dst + swz32<NG>(p, ch), src, ok ? 16 : 0);
      }
    }
    rn::cp_async_commit();
    return true;
  };

  // A chain's sums into part[blockIdx.x]: the first chain of the CTA stores
  // them, each later one loads, adds and stores (one thread per value, one
  // tap kd at a time, loads before stores), so they add in chain order on
  // every run; then the sums restart from zero. Fragment rows: channels c0
  // + 16 mf + gq (+ 8); columns: outputs o0 + 8 nf + 2 tq (+ 1).
  float* const pw = part + static_cast<long long>(blockIdx.x) * 27 * cpad * co;
  auto flush = [&](bool first) {
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      float2* dst[MF][2];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          dst[mf][half] = reinterpret_cast<float2*>(
              pw + (static_cast<long long>((kh * 3 + kw) * 3 + kd) * cpad + c0 + mf * 16 +
                    half * 8 + gq) * co + o0 + 2 * tq);
      float2 old[MF][2][NF];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf)
            old[mf][half][nf] = first ? make_float2(0.f, 0.f) : dst[mf][half][4 * nf];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int nf = 0; nf < NF; ++nf) {
            const float v0 = acc[kd][mf][nf][2 * half], v1 = acc[kd][mf][nf][2 * half + 1];
            dst[mf][half][4 * nf] = first ? make_float2(v0, v1)
                                          : make_float2(old[mf][half][nf].x + v0,
                                                        old[mf][half][nf].y + v1);
            acc[kd][mf][nf][2 * half] = acc[kd][mf][nf][2 * half + 1] = 0.f;
          }
    }
  };

  const long long r0 = g.rows * blockIdx.x / parts, r1 = g.rows * (blockIdx.x + 1) / parts;
  auto row = [&](long long col, int h, int m) {
    const rn3::Column c = rn3::column<F_TW>(g, col);
    const unsigned char* xp = ring + ((m - 2 + kh) % F_RING) * SLOT;
    const unsigned char* gp = ring + ((m - 1) % F_RING) * SLOT + XBYTES;
#pragma unroll 1
    for (int wi = 0; wi < F_TW && c.w0 + wi < g.W; ++wi) {
#pragma unroll 1
      for (int dk = 0; dk < rn3::TD / 8 && c.d0 + 8 * dk < g.D; ++dk) {
        // B = gy: positions (wi, 8 dk + tq (+ 4)), output channels 8 nf + gq
        const unsigned char* gr = gp + (wi * rn3::TD + 8 * dk) * GB;
        uint32_t bh[NF][2], bl[NF][2];
#pragma unroll
        for (int nf = 0; nf < NF; ++nf) {
          rn::tf32_split_rn(lds(gr + boff[nf]), bh[nf][0], bl[nf][0]);
          rn::tf32_split_rn(lds(gr + boff[nf] + 4 * GB), bh[nf][1], bl[nf][1]);
        }
#pragma unroll
        for (int kd = 0; kd < 3; ++kd) {
          // A = x^T: channels 16 mf + gq (+ 8), positions at plane row
          // (wi + kw, 8 dk + kd + tq (+ 4)), swizzled as swz32
          const int r = (wi + kw) * rn3::HD + 8 * dk + kd + tq;
          const int sw = ((r / (8 / NX)) & (NX / 2 - 1)) << 1;
          const unsigned char* xr = xp + r * XB + 4 * gq;
          uint32_t ah[MF][4], al[MF][4];
#pragma unroll
          for (int mf = 0; mf < MF; ++mf)
#pragma unroll
            for (int e = 0; e < 4; ++e)  // e: (+ 8 channels) e % 2, (+ 4 positions) e / 2
              rn::tf32_split_rn(lds(xr + (e / 2) * 4 * XB + (((4 * mf + 2 * (e % 2)) ^ sw) << 4)),
                             ah[mf][e], al[mf][e]);
          // pass by pass over all blocks: MF NF independent sums between two
          // products into one
#pragma unroll
          for (int mf = 0; mf < MF; ++mf)
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) rn::mma_tf32(acc[kd][mf][nf], ah[mf], bh[nf]);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf)
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) rn::mma_tf32(acc[kd][mf][nf], ah[mf], bl[nf]);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf)
#pragma unroll
            for (int nf = 0; nf < NF; ++nf) rn::mma_tf32(acc[kd][mf][nf], al[mf], bh[nf]);
        }
      }
    }
    const long long r = col * g.H + h;  // chains [r0 + k chain, r0 + (k + 1) chain)
    if ((r + 1 - r0) % chain == 0 || r + 1 == r1) flush(r - r0 < chain);
  };

  rn3::walk_rows<F_RING, F_RING - 3>(r0, r1, g.H, issue, row);
}

template <int CS, int OS>
cudaError_t launch_tf32(const float* x, const float* gy, float* part, const rn3::Geom& g, int co,
                        int cpad, int parts, int chain, cudaStream_t s) {
  constexpr int smem = tf32_smem_bytes<CS, OS>();
  auto kernel = g.C % 4 == 0 ? &conv3d_wgrad_tf32_kernel<CS, OS, true>
                             : &conv3d_wgrad_tf32_kernel<CS, OS, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(parts, cpad / CS, co / OS);
  kernel<<<grid, MMA_THREADS, smem, s>>>(x, gy, part, g, co, cpad, parts, chain);
  return cudaGetLastError();
}

// out[tap][c][o] = sum over parts, in part order, of part[k][tap][c][o]
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
// co floats, with (parts, cpad) from cuda_conv3d.wgrad_plan: the persistent
// CTAs per slice and C rounded up to the slice width (16 for C <= 16, else
// 32); chain: fp32's accumulator chains, in rows (bf16 ignores it).
extern "C" int rn_conv3d_wgrad(const void* x, const void* gy, void* part, void* out, int dtype,
                               int B, int H, int W, int D, int C, int co, int parts, int cpad,
                               int chain, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (co != 16 && co != 32 && co != 64) return static_cast<int>(cudaErrorInvalidValue);
  float* pf = static_cast<float*>(part);
  cudaError_t err = cudaErrorInvalidValue;
  const int cs = C <= 16 ? 16 : 32;
  if (dtype == 0) {
    const rn3::Geom g = rn3::make_geom<F_TW>(B, H, W, D, C);
    if (cpad != (C + cs - 1) / cs * cs || parts < 1 || parts > g.rows || chain < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    auto xf = static_cast<const float*>(x);
    auto gf = static_cast<const float*>(gy);
    if (cs == 16)
      err = co == 16 ? launch_tf32<16, 16>(xf, gf, pf, g, co, cpad, parts, chain, s)
                     : launch_tf32<16, 32>(xf, gf, pf, g, co, cpad, parts, chain, s);
    else
      err = co == 16 ? launch_tf32<32, 16>(xf, gf, pf, g, co, cpad, parts, chain, s)
                     : launch_tf32<32, 32>(xf, gf, pf, g, co, cpad, parts, chain, s);
  } else {
    const rn3::Geom g = rn3::make_geom(B, H, W, D, C);
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
