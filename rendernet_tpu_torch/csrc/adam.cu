// Adam: the optimizer's whole update, every parameter tensor in one launch.
//
// Replaces no TPU kernel: the JAX package leaves Adam to optax, and XLA fuses
// its update into the jitted step. Run eagerly, the same rule is some
// fourteen launches a parameter tensor (the moments, the bias-corrected step,
// the learning rate, the add), each its own pass through device memory; this
// kernel is what XLA's fusion gives the JAX step.
//
// Bound: memory. Each element reads its gradient, both moments and the
// parameter and writes back both moments and the parameter, with ~12 flops
// between: 28 bytes an element with fp32 gradients and moments (20 with bf16
// moments), 6.6 GB for the shader's 237 M parameters, 1.98 ms at 3.35 TB/s.
// Design: one persistent grid (a few CTAs per SM) walks a table of chunks,
// (tensor, first element) pairs of at most kChunk elements, built once for a
// parameter set and kept on the device with the parameters' and moments'
// pointers (which do not move). The gradients are new tensors every step, so
// their pointers come as a kernel-parameter array (kMaxTensors of them fit in
// 4 KB of parameters), read from the constant bank: no copy to the device
// and no host wait. Each thread steps groups of four elements, loaded and
// stored as one vector of each array (16 bytes of fp32, 8 of bf16) where
// that array's group lies on its vector size, element by element where it
// does not (gradients that are views into a flat buffer at any offset); a
// chunk's few elements before the parameter's first 16-byte boundary and
// after its last whole group run singly. The bias corrections and the
// learning rate are read from device scalars, so nothing waits for the host.
//
// Arithmetic: optim.scale_by_adam's, operation by operation in its order,
// with no contraction: m = (1-b1) g + b1 m, v = (1-b2) (g g) + b2 v, u =
// (m / bc1) / (sqrt(v / bc2) + eps) rounded to the gradient's type, u * lr
// rounded likewise (the learning rate rounded to it first where PyTorch's
// mixed-type product does), p += u; the moments are stored rounded to their
// type. So the result equals the per-tensor form bit for bit.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxTensors = 384;  // 3,072 bytes of gradient pointers
constexpr int kChunk = 8192;      // elements; a multiple of the 4-element group
constexpr int kThreads = 256;

struct Grads {
  const void* g[kMaxTensors];
};

// One parameter tensor: its parameter, moments and element count.
struct Tensor {
  float* p;
  void* m;
  void* v;
  long long n;
};

struct Hyper {
  float c1, b1, c2, b2, eps;  // (1 - b1), b1, (1 - b2), b2, eps as fp32
};

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return rn::to_f32(rn::from_f32<T>(x));
}

template <typename T>
__device__ __forceinline__ bool group_aligned(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

__device__ __forceinline__ void load4(const float* p, bool vec, float x[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = p[j];
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec, float x[4]) {
  if (vec) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    x[0] = __low2float(lo), x[1] = __high2float(lo), x[2] = __low2float(hi),
    x[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = rn::to_f32(p[j]);
  }
}
__device__ __forceinline__ void store4(float* p, bool vec, const float x[4]) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = x[j];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, bool vec, const float x[4]) {
  if (vec) {
    uint2 q;
    *reinterpret_cast<__nv_bfloat162*>(&q.x) = __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&q.y) = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = rn::from_f32<__nv_bfloat16>(x[j]);
  }
}

struct Step {
  Hyper h;
  float bc1, bc2, lr;
};

// One element: the new parameter, and the moments in fp32 (stored rounded).
template <typename G>
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v, const Step& s) {
  m = __fadd_rn(__fmul_rn(s.h.c1, g), __fmul_rn(s.h.b1, m));
  v = __fadd_rn(__fmul_rn(s.h.c2, __fmul_rn(g, g)), __fmul_rn(s.h.b2, v));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), s.h.eps);
  const float u = round_to<G>(__fdiv_rn(__fdiv_rn(m, s.bc1), den));
  p = __fadd_rn(p, round_to<G>(__fmul_rn(u, s.lr)));
}

template <typename G, typename M>
__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Grads grads, const Tensor* __restrict__ tensors,
                const int2* __restrict__ chunks, int n_chunks, const float* __restrict__ bc1,
                const float* __restrict__ bc2, const float* __restrict__ lr, float lr_value,
                int round_lr, Hyper h) {
  Step s{h, *bc1, *bc2, lr ? *lr : lr_value};
  if (round_lr) s.lr = round_to<G>(s.lr);
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int2 ch = chunks[c];
    const Tensor t = tensors[ch.x];
    const G* g = static_cast<const G*>(grads.g[ch.x]);
    M* m = static_cast<M*>(t.m);
    M* v = static_cast<M*>(t.v);
    float* p = t.p;
    const long long s0 = ch.y;
    const long long e = min(s0 + kChunk, t.n);
    // [s0, a): up to the parameter's first 16-byte boundary; [a, b): whole
    // groups of four; [b, e): the rest.
    const long long a =
        min(s0 + static_cast<long long>(((16 - (reinterpret_cast<uintptr_t>(p + s0) & 15)) & 15) >> 2), e);
    const long long b = a + ((e - a) & ~3ll);
    const int n_head = static_cast<int>(a - s0), n_edge = n_head + static_cast<int>(e - b);
    for (int k = threadIdx.x; k < n_edge; k += kThreads) {
      const long long i = k < n_head ? s0 + k : b + (k - n_head);
      float pi = p[i], mi = rn::to_f32(m[i]), vi = rn::to_f32(v[i]);
      adam1<G>(pi, rn::to_f32(g[i]), mi, vi, s);
      p[i] = pi;
      m[i] = rn::from_f32<M>(mi);
      v[i] = rn::from_f32<M>(vi);
    }
    const bool gv = group_aligned(g + a), mv = group_aligned(m + a), vv = group_aligned(v + a);
    for (long long i = a + 4ll * threadIdx.x; i < b; i += 4ll * kThreads) {
      float pf[4], gf[4], mf[4], vf[4];
      load4(p + i, true, pf);
      load4(g + i, gv, gf);
      load4(m + i, mv, mf);
      load4(v + i, vv, vf);
#pragma unroll
      for (int j = 0; j < 4; ++j) adam1<G>(pf[j], gf[j], mf[j], vf[j], s);
      store4(p + i, true, pf);
      store4(m + i, mv, mf);
      store4(v + i, vv, vf);
    }
  }
}

template <typename G, typename M>
int launch(const Grads& grads, const void* tensors, const void* chunks, int n_chunks,
           const void* bc1, const void* bc2, const void* lr, float lr_value, int round_lr,
           Hyper h, int grid, cudaStream_t stream) {
  adam_kernel<G, M><<<grid, kThreads, 0, stream>>>(
      grads, static_cast<const Tensor*>(tensors), static_cast<const int2*>(chunks), n_chunks,
      static_cast<const float*>(bc1), static_cast<const float*>(bc2),
      static_cast<const float*>(lr), lr_value, round_lr, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The compiled constants, for the wrapper to check its tables against:
// [max tensors a launch, chunk elements, threads a CTA, bytes of a Tensor].
extern "C" void rn_adam_constants(int* out) {
  out[0] = kMaxTensors;
  out[1] = kChunk;
  out[2] = kThreads;
  out[3] = static_cast<int>(sizeof(Tensor));
}

// grads: n_tensors device pointers in a host array (copied into the launch's
// parameters); tensors: a device table of n_tensors Tensor rows; chunks: a
// device table of n_chunks (tensor, first element) int32 pairs; bc1, bc2:
// device fp32 scalars; lr: a device fp32 scalar, or null for lr_value.
// dtype codes: 0 float32, 1 bfloat16.
extern "C" int rn_adam(const void* const* grads, int n_tensors, const void* tensors,
                       const void* chunks, int n_chunks, int g_dtype, int m_dtype,
                       const void* bc1, const void* bc2, const void* lr, float lr_value,
                       int round_lr, float c1, float b1, float c2, float b2, float eps, int grid,
                       void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors || n_chunks < 1 || grid < 1 ||
      g_dtype < 0 || g_dtype > 1 || m_dtype < 0 || m_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Grads g;
  for (int i = 0; i < n_tensors; ++i) g.g[i] = grads[i];
  for (int i = n_tensors; i < kMaxTensors; ++i) g.g[i] = nullptr;
  const Hyper h{c1, b1, c2, b2, eps};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0 && m_dtype == 0)
    return launch<float, float>(g, tensors, chunks, n_chunks, bc1, bc2, lr, lr_value, round_lr,
                                h, grid, st);
  if (g_dtype == 0)
    return launch<float, __nv_bfloat16>(g, tensors, chunks, n_chunks, bc1, bc2, lr, lr_value,
                                        round_lr, h, grid, st);
  if (m_dtype == 0)
    return launch<__nv_bfloat16, float>(g, tensors, chunks, n_chunks, bc1, bc2, lr, lr_value,
                                        round_lr, h, grid, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(g, tensors, chunks, n_chunks, bc1, bc2, lr,
                                              lr_value, round_lr, h, grid, st);
}
