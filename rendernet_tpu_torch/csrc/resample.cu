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
// Bound: memory. A pass reads BC*R*L values and writes BC*R*out_lanes, with
// a few flops per value (8 x 16384 x 128 bf16 at batch 8: ~67 MB, ~20 us at
// 3.35 TB/s). Design: one thread per output lane, consecutive threads on
// consecutive lanes of a row, so the stores coalesce and the two gathered
// reads of a warp fall in one or two 128-lane rows that L1 serves (alpha is
// within [1/2, 2] on this path, so a warp touches a narrow band). The data
// is loaded in its stored type and the geometry and interpolation run in
// fp32, rounded operation by operation in the reference's order
// (no FMA contraction). The TPU kernel's row-block tiling (_row_block) is a
// VMEM rule; here the ragged edge is masked instead.
#include "common.cuh"

template <typename T>
__global__ void interp_pass_kernel(const T* __restrict__ vol,
                                   const float* __restrict__ params,
                                   T* __restrict__ out, int r, int l, int ol,
                                   int db) {
  const int bc = blockIdx.y;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(r) * ol) return;
  const int row = static_cast<int>(idx / ol);
  const int lane = static_cast<int>(idx - static_cast<long long>(row) * ol);
  const float al = params[bc * 4 + 0], ca = params[bc * 4 + 1];
  const float cb = params[bc * 4 + 2], de = params[bc * 4 + 3];
  const float d_a = static_cast<float>(row / db);
  const float d_b = static_cast<float>(row % db);
  const float off = __fadd_rn(__fadd_rn(__fmul_rn(ca, d_a), __fmul_rn(cb, d_b)), de);
  const float pos = __fadd_rn(__fmul_rn(al, static_cast<float>(lane)), off);
  const float i0f = floorf(pos);
  const float w = __fsub_rn(pos, i0f);
  const T* src = vol + (static_cast<long long>(bc) * r + row) * l;
  const float last = static_cast<float>(l - 1);
  float g0 = 0.f, g1 = 0.f;
  if (i0f >= 0.f && i0f <= last) g0 = rn::to_f32(src[static_cast<int>(i0f)]);
  if (i0f + 1.f >= 0.f && i0f + 1.f <= last) g1 = rn::to_f32(src[static_cast<int>(i0f) + 1]);
  const float res = __fadd_rn(__fmul_rn(__fsub_rn(1.f, w), g0), __fmul_rn(w, g1));
  out[(static_cast<long long>(bc) * r + row) * ol + lane] = rn::from_f32<T>(res);
}

extern "C" int rn_resample_pass(const void* vol, const void* params, void* out,
                                int dtype, int bc, int r, int l, int ol, int db,
                                void* stream) {
  const int threads = 256;
  const long long n = static_cast<long long>(r) * ol;
  const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads), bc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    interp_pass_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(params),
        static_cast<float*>(out), r, l, ol, db);
  } else {
    interp_pass_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), static_cast<const float*>(params),
        static_cast<__nv_bfloat16*>(out), r, l, ol, db);
  }
  return static_cast<int>(cudaGetLastError());
}
