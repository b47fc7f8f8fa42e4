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
// Bound: memory. Per row the kernel reads v (L lanes) and g (out_lanes) in
// the stored type and writes gv (L) and gp (out_lanes, fp32), with ~10
// flops per tap (at [20,16384,128] in bf16: ~419 MB, 0.125 ms at
// 3.35 TB/s). Design: a block stages a few whole rows of v and g in shared
// memory as fp32 (16-byte vector loads where a row is a whole number of
// vectors), then one thread per input lane walks its band of output lanes
// for gv and one thread per output lane reads its two taps for gp, so the
// banded gathers hit shared memory and every store coalesces. No atomics:
// each output value has one writer, and results repeat from run to run.
// Every operation rounds on its own in the reference's order (no FMA
// contraction), so band membership (wgt > 0) and l0 agree bit for bit with
// the plain version. The TPU kernel's lane gather over a 1024-row VMEM
// block is a TPU device and is not carried over.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStageFloats = 2048;  // fp32 values per staged tensor per block

// Whole rows staged per block: 16 at L = 128, one for L > 2048.
int rows_per_block(int l) { return kStageFloats / l > 0 ? kStageFloats / l : 1; }

// Copy nrows rows of `width` values (row pitch `width` in src) into dst as
// fp32 with row pitch `pitch`, zero-filling lanes [width, pitch).
template <typename T>
__device__ void stage_rows(const T* __restrict__ src, float* dst, int nrows, int width,
                           int pitch) {
  constexpr int kVec = 16 / sizeof(T);
  if (width % kVec == 0) {
    const int nvec = nrows * width / kVec;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const uint4 raw = s[v];
      const T* vals = reinterpret_cast<const T*>(&raw);
      const int idx = v * kVec;
      const int row = idx / width;
      float* d = dst + row * pitch + (idx - row * width);
#pragma unroll
      for (int k = 0; k < kVec; ++k) d[k] = rn::to_f32(vals[k]);
    }
  } else {
    for (int idx = threadIdx.x; idx < nrows * width; idx += blockDim.x) {
      const int row = idx / width;
      dst[row * pitch + (idx - row * width)] = rn::to_f32(src[idx]);
    }
  }
  const int pad = pitch - width;
  for (int idx = threadIdx.x; idx < nrows * pad; idx += blockDim.x) {
    const int row = idx / pad;
    dst[row * pitch + width + (idx - row * pad)] = 0.f;
  }
}

template <typename T>
__global__ void interp_pass_bwd_kernel(const T* __restrict__ vol, const T* __restrict__ g,
                                       const float* __restrict__ params, T* __restrict__ gv,
                                       float* __restrict__ gp, int r, int l, int ol, int db,
                                       int taps, int rows) {
  extern __shared__ float smem[];
  float* sv = smem;              // [rows][l]
  float* sg = smem + rows * l;   // [rows][l], zero beyond ol
  const int bc = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int nrows = min(rows, r - r0);
  const long long vbase = (static_cast<long long>(bc) * r + r0) * l;
  const long long gbase = (static_cast<long long>(bc) * r + r0) * ol;
  stage_rows(vol + vbase, sv, nrows, l, l);
  stage_rows(g + gbase, sg, nrows, ol, l);
  __syncthreads();

  const float al = params[bc * 4 + 0], ca = params[bc * 4 + 1];
  const float cb = params[bc * 4 + 2], de = params[bc * 4 + 3];
  const float inv_al = __fdiv_rn(1.f, al);
  const float last = static_cast<float>(l - 1);

  // voxel cotangent: one thread per input lane
  for (int idx = threadIdx.x; idx < nrows * l; idx += blockDim.x) {
    const int rr = idx / l;
    const int i = idx - rr * l;
    const int row = r0 + rr;
    const float d_a = static_cast<float>(row / db);
    const float d_b = static_cast<float>(row % db);
    const float o_row = __fadd_rn(__fadd_rn(__fmul_rn(ca, d_a), __fmul_rn(cb, d_b)), de);
    const float li = static_cast<float>(i);
    const float b1 = __fmul_rn(__fsub_rn(__fsub_rn(li, 1.f), o_row), inv_al);
    const float b2 = __fmul_rn(__fsub_rn(__fadd_rn(li, 1.f), o_row), inv_al);
    // Clamping l0 to [-taps-1, ol] keeps the int conversion in range and
    // changes no tap's validity: outside it every tap is out of the window.
    const float l0f = fminf(fmaxf(ceilf(fminf(b1, b2)), static_cast<float>(-taps - 1)),
                            static_cast<float>(ol));
    const int l0 = static_cast<int>(l0f);
    const float* grow = sg + rr * l;
    float acc = 0.f;
    for (int t = 0; t < taps; ++t) {
      const int lt = l0 + t;
      const float pos_t = __fadd_rn(__fmul_rn(al, static_cast<float>(lt)), o_row);
      const float wgt = __fsub_rn(1.f, fabsf(__fsub_rn(pos_t, li)));
      if (wgt > 0.f && lt >= 0 && lt <= ol - 1) acc = __fadd_rn(acc, __fmul_rn(wgt, grow[lt]));
    }
    gv[vbase + idx] = rn::from_f32<T>(acc);
  }

  // position cotangent: one thread per output lane
  for (int idx = threadIdx.x; idx < nrows * ol; idx += blockDim.x) {
    const int rr = idx / ol;
    const int lane = idx - rr * ol;
    const int row = r0 + rr;
    const float d_a = static_cast<float>(row / db);
    const float d_b = static_cast<float>(row % db);
    const float o_row = __fadd_rn(__fadd_rn(__fmul_rn(ca, d_a), __fmul_rn(cb, d_b)), de);
    const float pos = __fadd_rn(__fmul_rn(al, static_cast<float>(lane)), o_row);
    const float i0f = floorf(pos);
    const float* vrow = sv + rr * l;
    float v0 = 0.f, v1 = 0.f;
    if (i0f >= 0.f && i0f <= last) v0 = vrow[static_cast<int>(i0f)];
    if (i0f + 1.f >= 0.f && i0f + 1.f <= last) v1 = vrow[static_cast<int>(i0f) + 1];
    gp[gbase + idx] = __fmul_rn(sg[rr * l + lane], __fsub_rn(v1, v0));
  }
}

}  // namespace

extern "C" int rn_resample_pass_bwd(const void* vol, const void* g, const void* params,
                                    void* gv, void* gp, int dtype, int bc, int r, int l, int ol,
                                    int db, int taps, void* stream) {
  const int rows = rows_per_block(l);
  const int smem = 2 * rows * l * static_cast<int>(sizeof(float));  // <= 48 KB for l <= 6144
  const dim3 grid(static_cast<unsigned>((r + rows - 1) / rows), bc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    interp_pass_bwd_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(g),
        static_cast<const float*>(params), static_cast<float*>(gv), static_cast<float*>(gp), r,
        l, ol, db, taps, rows);
  } else {
    interp_pass_bwd_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(vol), static_cast<const __nv_bfloat16*>(g),
        static_cast<const float*>(params), static_cast<__nv_bfloat16*>(gv),
        static_cast<float*>(gp), r, l, ol, db, taps, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
