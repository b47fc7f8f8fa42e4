// K4: the adjoint of one pass of the multipass voxel resample (K1).
//
// Replaces rendernet_tpu/ops/pallas_resample.py:_bwd_kernel (reached through
// pl.pallas_call in _pass_call, from the custom VJP's _pass_bwd). For a
// pass [BC, R, L] -> [BC, R, out_lanes] with output cotangent g, row
// (d_a, d_b) = (row / db, row % db) and o_row = (c_a*d_a + c_b*d_b) + delta:
//
//   position cotangent, per output lane l (fp32):
//     pos = alpha*l + o_row, i0 = floor(pos),
//     gp[l] = g[l] * (v[i0+1]*m1 - v[i0]*m0)    (m: "tap in range");
//   voxel cotangent, per input lane i (accumulated in fp32, rounded once to
//   the volume's type):
//     l0 = ceil(min((i-1-o_row)/alpha, (i+1-o_row)/alpha)), computed as a
//     product with 1/alpha; for t = 0..taps-1 in that order, lt = l0 + t,
//     wgt = 1 - |alpha*lt + o_row - i|, add wgt*g[lt] where wgt > 0 and
//     0 <= lt < out_lanes (g is zero beyond the emitted window).
//
// The reduction of gp against the lane and row coordinates into the
// gradient of (alpha, c_a, c_b, delta) is tensor code in the wrapper, as it
// is XLA code outside the TPU kernel.
//
// Bound: memory in bytes (at [20,16384,128] in bf16: ~419 MB, 0.125 ms at
// 3.35 TB/s), but ~10 instructions per tap and value make the issue rate a
// near second limit, so nothing per value may cost a division, a mask or the
// conversion unit, and no block barrier may stall a tile. Design
// (resample_tile.cuh, as K1): persistent CTAs walk tiles of whole rows of one
// bc; a producer warp writes each tile's header (alpha, 1/alpha, o_row per
// row, computed once) and, where rows are whole 16-byte vectors, keeps a ring
// of stages full with bulk copies of v and g rows in their stored type and
// writes gv [rows, L] (stored type) and gp [rows, out_lanes] (fp32) out of
// shared tiles with bulk stores, while 8 consumer warps compute: one thread
// per input lane walks its band of output lanes for gv, one thread per output
// lane reads its two taps for gp. Consumer threads keep their lane and step
// rows, consecutive threads on consecutive lanes, so the banded gathers fall
// on neighbouring shared addresses. Rows are staged with zero padding, so a
// tap outside the window reads zero (its product adds exactly nothing) and
// the compiled bands (3 and 6 taps) need no window test; floor and ceil run
// as fp32 adds, so the conversion unit does only the final rounding. Other
// shapes take the scalar path of the same kernel (one stage, ordinary loads,
// results stored directly). No atomics: each output value has one writer, and
// results repeat from run to run. Every operation rounds on its own in the
// reference's order (no FMA contraction), so band membership (wgt > 0) and l0
// agree bit for bit with the plain version. The TPU kernel's lane gather over
// a 1024-row VMEM block is a TPU device and is not carried over.
#include "resample_tile.cuh"

namespace {

using namespace rn::resample;

// One tile: sv [nrows][kPad + l + kPad], sg [nrows][kPad + ol + kPad]
// (padded rows) in shared memory; gv [nrows][l], gp [nrows][ol] in shared or
// device memory. kTaps > 0 fixes the band at compile time (at most kPad - 1
// taps: a tap outside the window then reads the padding's zero, whose
// product adds exactly nothing); 0 reads `taps` and checks the window.
template <typename T, int kTaps>
__device__ __forceinline__ void k4_tile(const T* sv, const T* sg, T* gv, float* gp,
                                        const float* s_orow, int nrows, int l, int ol, int taps,
                                        float al, float inv_al, const Walk& walk_l,
                                        const Walk& walk_ol) {
  static_assert(kTaps < kPad, "the padding must hold the band's reach beyond the window");
  const int nt = kTaps > 0 ? kTaps : taps;
  const float lo = static_cast<float>(-nt - 1), hi = static_cast<float>(ol);
  // voxel cotangent: one thread per input lane
  walk_tile(walk_l, nrows, l, [&](int rr, int lane, float li) {
    const float o_row = s_orow[rr];
    const float b1 = __fmul_rn(__fsub_rn(__fsub_rn(li, 1.f), o_row), inv_al);
    const float b2 = __fmul_rn(__fsub_rn(__fadd_rn(li, 1.f), o_row), inv_al);
    // Clamping l0 to [-taps-1, ol] keeps it in the padded row and changes
    // no tap's validity: outside it every tap is out of the window.
    const float l0f = fminf(fmaxf(ceil_small(fminf(b1, b2)), lo), hi);
    const int l0 = int_small(l0f);
    const T* grow = sg + rr * (ol + 2 * kPad) + kPad + l0;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < nt; ++t) {
      const float pos_t = __fadd_rn(__fmul_rn(al, __fadd_rn(l0f, static_cast<float>(t))), o_row);
      const float wgt = __fsub_rn(1.f, fabsf(__fsub_rn(pos_t, li)));
      const bool in_window = kTaps > 0 || static_cast<unsigned>(l0 + t) < static_cast<unsigned>(ol);
      if (wgt > 0.f && in_window) acc = __fadd_rn(acc, __fmul_rn(wgt, rn::to_f32(grow[t])));
    }
    gv[rr * l + lane] = rn::from_f32<T>(acc);
  });
  // position cotangent: one thread per output lane
  walk_tile(walk_ol, nrows, ol, [&](int rr, int lane, float lanef) {
    const float pos = __fadd_rn(__fmul_rn(al, lanef), s_orow[rr]);
    int i0;
    floor_small(pos, i0);
    const T* vrow = sv + rr * (l + 2 * kPad) + kPad + min(max(i0, -2), l);
    const float v0 = rn::to_f32(vrow[0]), v1 = rn::to_f32(vrow[1]);
    gp[rr * ol + lane] =
        __fmul_rn(rn::to_f32(sg[rr * (ol + 2 * kPad) + kPad + lane]), __fsub_rn(v1, v0));
  });
}

// Shared bytes of one stage: the header, v [rows][kPad + l + kPad] and g
// [rows][kPad + ol + kPad] (padded rows) in the stored type and, on the bulk
// path, the outputs gv [rows][l] and gp [rows][ol] (fp32).
template <typename T, bool kBulk>
__host__ __device__ constexpr int k4_stage_bytes(int rows, int l, int ol) {
  return header_bytes(rows) + padded_bytes<T>(rows, l) + padded_bytes<T>(rows, ol) +
         (kBulk ? round128(1LL * rows * l * sizeof(T)) + round128(4LL * rows * ol) : 0);
}

// K4 as a pass of resample_tile.cuh's ring.
template <typename T, bool kBulk, int kTaps>
struct K4Pass {
  const T *vol, *g;
  T* gv;
  float* gp;
  int r, l, ol, taps, rows, g_off, gv_off, gp_off, stage_bytes;
  Walk walk_l, walk_ol;

  __device__ K4Pass(const T* vol_, const T* g_, T* gv_, float* gp_, int r_, int l_, int ol_,
                    int taps_, int rows_)
      : vol(vol_), g(g_), gv(gv_), gp(gp_), r(r_), l(l_), ol(ol_), taps(taps_), rows(rows_),
        g_off(header_bytes(rows_) + padded_bytes<T>(rows_, l_)),
        gv_off(g_off + padded_bytes<T>(rows_, ol_)),
        gp_off(gv_off + round128(1LL * rows_ * l_ * sizeof(T))),
        stage_bytes(k4_stage_bytes<T, kBulk>(rows_, l_, ol_)), walk_l(l_), walk_ol(ol_) {}
  __device__ T* v_in(unsigned char* st) const {
    return reinterpret_cast<T*>(st + header_bytes(rows));
  }
  __device__ T* g_in(unsigned char* st) const { return reinterpret_cast<T*>(st + g_off); }
  __device__ void pad(unsigned char* stage0, int stages) const {
    zero_padding<T>(stage0, stages, stage_bytes, header_bytes(rows), rows, l);
    zero_padding<T>(stage0, stages, stage_bytes, g_off, rows, ol);
  }
  __device__ uint32_t load_bytes(const Tile& t) const {
    return static_cast<uint32_t>(t.nrows * (l + ol) * sizeof(T));
  }
  __device__ void load(unsigned char* st, const Tile& t, uint32_t bar, int lane) const {
    bulk_rows(v_in(st), vol + t.row0(r) * l, t.nrows, l, bar, lane);
    bulk_rows(g_in(st), g + t.row0(r) * ol, t.nrows, ol, bar, lane);
  }
  __device__ void store(unsigned char* st, const Tile& t) const {
    rn::bulk_store(gv + t.row0(r) * l, rn::smem_u32(st + gv_off),
                   static_cast<uint32_t>(t.nrows * l * sizeof(T)));
    rn::bulk_store(gp + t.row0(r) * ol, rn::smem_u32(st + gp_off),
                   static_cast<uint32_t>(t.nrows * ol * 4));
  }
  __device__ void copy_in(unsigned char* st, const Tile& t) const {
    copy_rows(v_in(st), vol + t.row0(r) * l, t.nrows, l, walk_l);
    copy_rows(g_in(st), g + t.row0(r) * ol, t.nrows, ol, walk_ol);
  }
  __device__ void compute(unsigned char* st, const Tile& t) const {
    const float* head = reinterpret_cast<const float*>(st);
    k4_tile<T, kTaps>(v_in(st), g_in(st),
                      kBulk ? reinterpret_cast<T*>(st + gv_off) : gv + t.row0(r) * l,
                      kBulk ? reinterpret_cast<float*>(st + gp_off) : gp + t.row0(r) * ol,
                      head + 4, t.nrows, l, ol, taps, head[0], head[1], walk_l, walk_ol);
  }
};

template <typename T, bool kBulk, int kStages, int kTaps>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kThreads)
    k4_adjoint(const T* __restrict__ vol, const T* __restrict__ g,
               const float* __restrict__ params, T* __restrict__ gv, float* __restrict__ gp,
               int r, int l, int ol, int db, int taps, int rows, int tiles_per_bc, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const K4Pass<T, kBulk, kTaps> pass(vol, g, gv, gp, r, l, ol, taps, rows);
  if constexpr (kBulk) {
    run_ring<kStages>(pass, smem, params, r, db, rows, tiles_per_bc, tiles);
  } else {
    run_scalar(pass, smem, params, r, db, rows, tiles_per_bc, tiles);
  }
}

struct Args {
  const void *vol, *g, *params;
  void *gv, *gp;
  int r, l, ol, db, taps, rows, tiles_per_bc, tiles, grid, smem;
  cudaStream_t stream;
};

template <typename T, bool kBulk, int kStages, int kTaps>
cudaError_t launch(const Args& a) {
  static int granted = 0;
  if (a.smem != 128 + kStages * k4_stage_bytes<T, kBulk>(a.rows, a.l, a.ol))
    return cudaErrorInvalidValue;  // the plan's shared bytes disagree with this layout
  auto kernel = k4_adjoint<T, kBulk, kStages, kTaps>;
  cudaError_t e = allow_smem(kernel, a.smem, granted);
  if (e != cudaSuccess) return e;
  kernel<<<a.grid, kBulk ? kBulkThreads : kThreads, a.smem, a.stream>>>(
      static_cast<const T*>(a.vol), static_cast<const T*>(a.g),
      static_cast<const float*>(a.params), static_cast<T*>(a.gv), static_cast<float*>(a.gp), a.r,
      a.l, a.ol, a.db, a.taps, a.rows, a.tiles_per_bc, a.tiles);
  return cudaGetLastError();
}

// The main path's bands (3-tap shear passes, 6-tap scale passes) unrolled;
// any other band read at run time.
template <typename T, bool kBulk, int kStages>
cudaError_t launch_taps(const Args& a) {
  if (a.taps == 3) return launch<T, kBulk, kStages, 3>(a);
  if (a.taps == 6) return launch<T, kBulk, kStages, 6>(a);
  return launch<T, kBulk, kStages, 0>(a);
}

template <typename T>
cudaError_t launch_path(int path, int stages, const Args& a) {
  if (path == 0 && stages == 1) return launch_taps<T, false, 1>(a);
  if (path != 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.vol) | reinterpret_cast<uintptr_t>(a.g) |
       reinterpret_cast<uintptr_t>(a.gv) | reinterpret_cast<uintptr_t>(a.gp)) % 16 ||
      (a.l * sizeof(T)) % 16 || (a.ol * sizeof(T)) % 16)
    return cudaErrorMisalignedAddress;  // bulk copies move whole, aligned 16-byte vectors
  if (stages != 2) return cudaErrorInvalidValue;  // the ring compiled: cuda_resample.PASS_STAGES
  return launch_taps<T, true, 2>(a);
}

}  // namespace

// path: 0 scalar (stages 1), 1 bulk (stages 2); rows, tiles_per_bc,
// tiles, grid and smem from cuda_resample.pass_plan(..., adjoint=True).
extern "C" int rn_resample_pass_bwd(const void* vol, const void* g, const void* params, void* gv,
                                    void* gp, int dtype, int r, int l, int ol, int db, int taps,
                                    int path, int rows, int stages, int tiles_per_bc, int tiles,
                                    int grid, int smem, void* stream) {
  const Args a{vol, g, params, gv, gp, r, l, ol, db, taps, rows, tiles_per_bc, tiles, grid, smem,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 ? launch_path<float>(path, stages, a)
                                      : launch_path<__nv_bfloat16>(path, stages, a));
}
