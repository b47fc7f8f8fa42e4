// K1: one pass of the multipass voxel resample, a 1-D linear interpolation
// along the minor axis of a [BC, R, L] volume.
//
// Replaces rendernet_tpu/ops/pallas_resample.py:_fwd_kernel (reached through
// pl.pallas_call in _pass_call, entry apply_interp_pass). Lane l of row
// (d_a, d_b) = (row / db, row % db) samples the row at
//     pos = alpha * l + ((c_a * d_a + c_b * d_b) + delta),
// out-of-range taps read zero, and only output lanes [0, out_lanes) are
// written (the fused crop window).
//
// Bound: memory. A pass reads BC*R*L values and writes BC*R*out_lanes, with a
// few flops per value (8 x 16384 x 128 bf16 at batch 8: ~67 MB, ~20 us at
// 3.35 TB/s). At two to four bytes a value the issue rate is the near limit:
// a division for the row and lane, parameter loads or masked 2-byte accesses
// per value would hold the kernel well under the byte bound. Design
// (resample_tile.cuh): persistent CTAs walk tiles of whole rows of one bc; a
// producer warp writes each tile's header (alpha and o_row per row, computed
// once) and, where rows are whole 16-byte vectors (the bulk path), keeps a
// ring of stages full with one 1-D bulk copy per row and writes each finished
// output tile out with one bulk store, while 8 consumer warps compute, so
// loads, stores and arithmetic of neighbouring tiles overlap. A consumer
// thread keeps one lane and steps rows (no division); consecutive threads
// take consecutive lanes, so a warp's two gathers fall on neighbouring shared
// addresses without bank conflicts; a tap outside the row reads the row's
// zero padding, and floor runs as two fp32 adds, so the conversion unit does
// only the final rounding. Other shapes take the scalar path of the same
// kernel: one stage, ordinary loads, results stored directly.
//
// Arithmetic: the data is read in its stored type; the geometry and
// interpolation run in fp32, rounded operation by operation in the
// reference's order (no FMA contraction), with one rounding to the stored
// type at the end, so the result equals the plain version bit for bit. The
// TPU kernel's row-block tiling (_row_block) is a VMEM rule and is not
// carried over.
#include "resample_tile.cuh"

namespace {

using namespace rn::resample;

// One tile: src [nrows][kPad + l + kPad] (padded rows) in shared memory, dst
// [nrows][ol] (shared or device memory), s_orow the rows' offsets. A tap
// outside the row reads the padding's zero, as the reference masks it.
template <typename T>
__device__ __forceinline__ void k1_tile(const T* src, T* dst, const float* s_orow, int nrows,
                                        int l, int ol, float al, const Walk& walk) {
  walk_tile(walk, nrows, ol, [&](int rr, int lane, float lanef) {
    const float pos = __fadd_rn(__fmul_rn(al, lanef), s_orow[rr]);
    int i0;
    const float wt = __fsub_rn(pos, floor_small(pos, i0));
    const T* row = src + rr * (l + 2 * kPad) + kPad + min(max(i0, -2), l);
    const float g0 = rn::to_f32(row[0]), g1 = rn::to_f32(row[1]);
    dst[rr * ol + lane] =
        rn::from_f32<T>(__fadd_rn(__fmul_rn(__fsub_rn(1.f, wt), g0), __fmul_rn(wt, g1)));
  });
}

// Shared bytes of one stage: the header, the padded input tile and, on the
// bulk path, the output tile.
template <typename T, bool kBulk>
__host__ __device__ constexpr int k1_stage_bytes(int rows, int l, int ol) {
  return header_bytes(rows) + padded_bytes<T>(rows, l) +
         (kBulk ? round128(1LL * rows * ol * sizeof(T)) : 0);
}

// K1 as a pass of resample_tile.cuh's ring.
template <typename T, bool kBulk>
struct K1Pass {
  const T* vol;
  T* out;
  int r, l, ol, rows, out_off, stage_bytes;
  Walk walk;

  __device__ K1Pass(const T* vol_, T* out_, int r_, int l_, int ol_, int rows_)
      : vol(vol_), out(out_), r(r_), l(l_), ol(ol_), rows(rows_),
        out_off(header_bytes(rows_) + padded_bytes<T>(rows_, l_)),
        stage_bytes(k1_stage_bytes<T, kBulk>(rows_, l_, ol_)), walk(ol_) {}
  __device__ T* in(unsigned char* st) const {
    return reinterpret_cast<T*>(st + header_bytes(rows));
  }
  __device__ void pad(unsigned char* stage0, int stages) const {
    zero_padding<T>(stage0, stages, stage_bytes, header_bytes(rows), rows, l);
  }
  __device__ uint32_t load_bytes(const Tile& t) const {
    return static_cast<uint32_t>(t.nrows * l * sizeof(T));
  }
  __device__ void load(unsigned char* st, const Tile& t, uint32_t bar, int lane) const {
    bulk_rows(in(st), vol + t.row0(r) * l, t.nrows, l, bar, lane);
  }
  __device__ void store(unsigned char* st, const Tile& t) const {
    rn::bulk_store(out + t.row0(r) * ol, rn::smem_u32(st + out_off),
                   static_cast<uint32_t>(t.nrows * ol * sizeof(T)));
  }
  __device__ void copy_in(unsigned char* st, const Tile& t) const {
    copy_rows(in(st), vol + t.row0(r) * l, t.nrows, l, Walk(l));
  }
  __device__ void compute(unsigned char* st, const Tile& t) const {
    const float* head = reinterpret_cast<const float*>(st);
    k1_tile(in(st), kBulk ? reinterpret_cast<T*>(st + out_off) : out + t.row0(r) * ol, head + 4,
            t.nrows, l, ol, head[0], walk);
  }
};

template <typename T, bool kBulk, int kStages>
__global__ void __launch_bounds__(kBulk ? kBulkThreads : kThreads)
    k1_pass(const T* __restrict__ vol, const float* __restrict__ params, T* __restrict__ out,
            int r, int l, int ol, int db, int rows, int tiles_per_bc, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const K1Pass<T, kBulk> pass(vol, out, r, l, ol, rows);
  if constexpr (kBulk) {
    run_ring<kStages>(pass, smem, params, r, db, rows, tiles_per_bc, tiles);
  } else {
    run_scalar(pass, smem, params, r, db, rows, tiles_per_bc, tiles);
  }
}

template <typename T, bool kBulk, int kStages>
cudaError_t launch(const void* vol, const void* params, void* out, int r, int l, int ol, int db,
                   int rows, int tiles_per_bc, int tiles, int grid, int smem, cudaStream_t s) {
  static int granted = 0;
  if (smem != 128 + kStages * k1_stage_bytes<T, kBulk>(rows, l, ol))
    return cudaErrorInvalidValue;  // the plan's shared bytes disagree with this layout
  auto kernel = k1_pass<T, kBulk, kStages>;
  cudaError_t e = allow_smem(kernel, smem, granted);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kBulk ? kBulkThreads : kThreads, smem, s>>>(
      static_cast<const T*>(vol), static_cast<const float*>(params), static_cast<T*>(out), r, l,
      ol, db, rows, tiles_per_bc, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_path(int path, int stages, const void* vol, const void* params, void* out,
                        int r, int l, int ol, int db, int rows, int tiles_per_bc, int tiles,
                        int grid, int smem, cudaStream_t s) {
  if (path == 0 && stages == 1)
    return launch<T, false, 1>(vol, params, out, r, l, ol, db, rows, tiles_per_bc, tiles, grid,
                               smem, s);
  if (path != 1) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(vol) | reinterpret_cast<uintptr_t>(out)) % 16 ||
      (l * sizeof(T)) % 16 || (ol * sizeof(T)) % 16)
    return cudaErrorMisalignedAddress;  // bulk copies move whole, aligned 16-byte vectors
  if (stages != 2) return cudaErrorInvalidValue;  // the ring compiled: cuda_resample.PASS_STAGES
  return launch<T, true, 2>(vol, params, out, r, l, ol, db, rows, tiles_per_bc, tiles, grid,
                            smem, s);
}

}  // namespace

// path: 0 scalar (stages 1), 1 bulk (stages 2); rows, tiles_per_bc,
// tiles, grid and smem from cuda_resample.pass_plan.
extern "C" int rn_resample_pass(const void* vol, const void* params, void* out, int dtype, int r,
                                int l, int ol, int db, int path, int rows, int stages,
                                int tiles_per_bc, int tiles, int grid, int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0 ? launch_path<float>(path, stages, vol, params, out, r, l, ol, db, rows,
                                      tiles_per_bc, tiles, grid, smem, s)
                 : launch_path<__nv_bfloat16>(path, stages, vol, params, out, r, l, ol, db, rows,
                                              tiles_per_bc, tiles, grid, smem, s);
  return static_cast<int>(e);
}
