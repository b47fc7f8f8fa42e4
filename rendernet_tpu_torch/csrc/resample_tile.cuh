// The tile walk shared by K1 (resample.cu) and K4 (resample_bwd.cu).
//
// A pass works on [BC, R, L] rows. A tile is `rows` consecutive rows of one
// bc (the last tile of a bc may be shorter), so its L lanes of input and its
// out_lanes of output are each one contiguous run of device memory. Tiles
// are numbered bc-major (tile = bc * tiles_per_bc + row block); persistent
// CTAs take tiles blockIdx.x, blockIdx.x + gridDim.x, ... The plan (rows
// per tile, ring stages, grid, path, shared bytes) comes from Python
// (cuda_resample.pass_plan); the kernels only decode it.
//
// Shared memory: 128 bytes of ring barriers, then `stages` stage buffers,
// every piece on a 128-byte boundary. A stage opens with its tile's header
// (alpha, 1/alpha, then o_row of each row, fp32), then the pass's input
// rows, each with kPad zeros on either side (a pitch of width + 2 kPad
// values), so that a tap outside the row reads zero from the padding
// instead of being masked: the padding is written once, and no row's copy
// touches it. On the bulk path the stage ends with the pass's output tiles.
//
// The bulk path (rows that are whole 16-byte vectors) is warp-specialized:
// kThreads consumer threads compute, and one producer warp keeps a ring of
// `stages` stages full. For tile k in stage s = k % stages the producer
// waits until the consumers are done with tile k - stages there, writes its
// outputs out with bulk stores and waits until they have been read, then
// fills the header and issues one 1-D bulk copy per input row, which
// complete on the stage's `full` barrier; the consumers wait on `full`,
// compute, and arrive on the stage's `done` barrier, warp by warp. No
// __syncthreads: warps run apart, and a stage's loads and stores overlap
// the other stages' arithmetic. The scalar path (other shapes) runs one
// stage with ordinary loads and stores and block barriers.
#pragma once

#include "hopper.cuh"

namespace rn {
namespace resample {

constexpr int kThreads = 256;            // consumer threads
constexpr int kWarps = kThreads / 32;    // consumer warps, `done`'s arrivals
constexpr int kBulkThreads = kThreads + 32;  // with the producer warp
// Zeros on each side of a staged input row: 16 bytes or more (row starts
// stay 16-byte aligned), and at least K4's band + 1 for bands of up to 7
// taps.
constexpr int kPad = 8;

__host__ __device__ constexpr int round128(long long bytes) {
  return static_cast<int>((bytes + 127) / 128 * 128);
}

// A stage's header: alpha, 1/alpha, two unused floats, o_row per row.
__host__ __device__ constexpr int header_bytes(int rows) { return round128(16 + 4LL * rows); }

// Shared bytes of `rows` padded input rows of `width` values.
template <typename T>
__host__ __device__ constexpr int padded_bytes(int rows, int width) {
  return round128(1LL * rows * (width + 2 * kPad) * sizeof(T));
}

struct Tile {
  int bc, r0, nrows;
  __device__ __forceinline__ long long row0(int r) const {
    return static_cast<long long>(bc) * r + r0;
  }
};

__device__ __forceinline__ Tile tile_at(int tile, int tiles_per_bc, int rows, int r) {
  Tile t;
  t.bc = tile / tiles_per_bc;
  t.r0 = (tile - t.bc * tiles_per_bc) * rows;
  t.nrows = min(rows, r - t.r0);
  return t;
}

// The header of tile t, by threads `id` of `n`: alpha, 1/alpha and
// o_row = (c_a * d_a + c_b * d_b) + delta of each row, rounded operation by
// operation as the reference (no FMA contraction).
__device__ __forceinline__ void fill_header(float* head, const Tile& t,
                                            const float* __restrict__ params, int db, int id,
                                            int n) {
  const float* p = params + t.bc * 4;
  if (id == 0) {
    head[0] = p[0];
    head[1] = __fdiv_rn(1.f, p[0]);
  }
  const float ca = p[1], cb = p[2], de = p[3];
  for (int k = id; k < t.nrows; k += n) {
    const int row = t.r0 + k;
    const float d_a = static_cast<float>(row / db);
    const float d_b = static_cast<float>(row % db);
    head[4 + k] = __fadd_rn(__fadd_rn(__fmul_rn(ca, d_a), __fmul_rn(cb, d_b)), de);
  }
}

// A consumer thread's walk over the elements (rr, lane) of a tile of
// `width` lanes, j = rr * width + lane = threadIdx.x + k * kThreads:
// consecutive threads take consecutive lanes.
struct Walk {
  int rr, lane, step_r, step_l;
  __device__ __forceinline__ explicit Walk(int width) {
    rr = threadIdx.x / width;
    lane = threadIdx.x - rr * width;
    step_r = kThreads / width;
    step_l = kThreads - step_r * width;
  }
};

// body(rr, lane, float(lane)) over the walk's elements of rows < nrows,
// without a division: where kThreads is a multiple of the width (the main
// path's 128 and 64 lanes) each thread keeps its lane and steps rows;
// otherwise the lane steps with a carry into the row.
template <typename F>
__device__ __forceinline__ void walk_tile(const Walk& w, int nrows, int width, F&& body) {
  if (w.step_l == 0) {
    const float lanef = static_cast<float>(w.lane);
#pragma unroll 2
    for (int rr = w.rr; rr < nrows; rr += w.step_r) body(rr, w.lane, lanef);
  } else {
    int rr = w.rr, lane = w.lane;
    while (rr < nrows) {
      body(rr, lane, static_cast<float>(lane));
      lane += w.step_l;
      rr += w.step_r;
      if (lane >= width) {
        lane -= width;
        ++rr;
      }
    }
  }
}

// floor and ceil with fp32 adds instead of the conversion unit: for
// |x| < 2^22, x + 1.5 * 2^23 lies in (2^23, 2^24), where floats are the
// integers, so the sum rounded down (up) is floor(x) (ceil(x)) + 1.5 * 2^23
// exactly; the result's bits minus those of 1.5 * 2^23 are that integer.
// Outside that range the integer is at least 2^22 for large x and negative
// for very negative x, infinities and NaN (callers clamp it to their rows,
// where such positions read zero, as they do in the reference).
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float floor_small(float x, int& xi) {
  const float s = __fadd_rd(x, kMagic);
  xi = __float_as_int(s) - kMagicBits;
  return __fsub_rn(s, kMagic);
}

__device__ __forceinline__ float ceil_small(float x) {
  return __fsub_rn(__fadd_ru(x, kMagic), kMagic);
}

// The int of an integral float in (-2^22, 2^22).
__device__ __forceinline__ int int_small(float x) {
  return __float_as_int(__fadd_rn(x, kMagic)) - kMagicBits;
}

// Zero the padding of `rows` padded rows of `width` values, `offset` bytes
// into each of `stages` stages `stage_bytes` apart (all threads of the CTA).
template <typename T>
__device__ __forceinline__ void zero_padding(unsigned char* stage0, int stages, int stage_bytes,
                                             int offset, int rows, int width) {
  const int pitch = width + 2 * kPad;
  for (int j = threadIdx.x; j < stages * rows * 2 * kPad; j += blockDim.x) {
    const int s = j / (rows * 2 * kPad), k = j - s * rows * 2 * kPad;
    const int rr = k / (2 * kPad), p = k - rr * 2 * kPad;
    T* row = reinterpret_cast<T*>(stage0 + s * stage_bytes + offset) + rr * pitch;
    row[p < kPad ? p : width + p] = rn::from_f32<T>(0.f);
  }
}

// The scalar path's ordinary load of `nrows` rows of `width` values into
// padded rows (consumer threads).
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* __restrict__ src, int nrows,
                                          int width, const Walk& w) {
  walk_tile(w, nrows, width, [&](int rr, int lane, float) {
    dst[rr * (width + 2 * kPad) + kPad + lane] = src[rr * width + lane];
  });
}

// The bulk path's load of `nrows` rows of `width` values into padded rows,
// by the 32 lanes of the producer warp: lane i copies rows i, i + 32, ...
template <typename T>
__device__ __forceinline__ void bulk_rows(T* dst, const T* src, int nrows, int width,
                                          uint32_t bar, int lane) {
  const uint32_t bytes = static_cast<uint32_t>(width * sizeof(T));
  for (int rr = lane; rr < nrows; rr += 32)
    rn::bulk_load(rn::smem_u32(dst + rr * (width + 2 * kPad) + kPad), src + rr * width, bytes,
                  bar);
}

// The bulk path's ring, run by every thread of a CTA of kBulkThreads. The
// pass P gives: stage_bytes; pad(stage0, stages) (zero the paddings);
// load_bytes(tile); load(stage, tile, bar, lane) (producer lanes);
// store(stage, tile) (producer lane 0); compute(stage, tile) (consumers,
// outputs into the stage).
template <int kStages, class P>
__device__ __forceinline__ void run_ring(const P& pass, unsigned char* smem,
                                         const float* __restrict__ params, int r, int db,
                                         int rows, int tiles_per_bc, int tiles) {
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* done = full + kStages;
  unsigned char* stage0 = smem + 128;
  const int first = blockIdx.x, stride = gridDim.x;
  const int mine = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;
  auto stage = [&](int k) { return stage0 + (k % kStages) * pass.stage_bytes; };
  auto tile = [&](int k) { return tile_at(first + k * stride, tiles_per_bc, rows, r); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      rn::mbar_init(rn::smem_u32(&full[s]), 32);
      rn::mbar_init(rn::smem_u32(&done[s]), kWarps);
    }
    rn::fence_mbar_init();
  }
  pass.pad(stage0, kStages);
  __syncthreads();

  if (threadIdx.x >= kThreads) {  // the producer warp
    const int lane = threadIdx.x - kThreads;
    for (int k = 0; k < mine + kStages; ++k) {
      unsigned char* st = stage(k);
      const int s = k % kStages;
      if (k >= kStages) {  // tile k - kStages is done: store it, free the stage
        rn::mbar_wait(rn::smem_u32(&done[s]), (k / kStages - 1) & 1);
        if (lane == 0) {
          pass.store(st, tile(k - kStages));
          rn::bulk_commit();
          rn::bulk_wait_read<0>();
        }
        __syncwarp();
      }
      if (k < mine) {
        const Tile t = tile(k);
        fill_header(reinterpret_cast<float*>(st), t, params, db, lane, 32);
        // every lane arrives after its header writes (release); lane 0 arms
        // the barrier with the tile's bytes before any copy is issued
        const uint32_t bar = rn::smem_u32(&full[s]);
        if (lane == 0) {
          rn::mbar_expect_tx(bar, pass.load_bytes(t));
        } else {
          rn::mbar_arrive(bar);
        }
        __syncwarp();
        pass.load(st, t, bar, lane);
      }
    }
    if (lane == 0) rn::bulk_wait_all();
  } else {  // the consumers
    for (int k = 0; k < mine; ++k) {
      const int s = k % kStages;
      rn::mbar_wait(rn::smem_u32(&full[s]), (k / kStages) & 1);
      pass.compute(stage(k), tile(k));
      rn::fence_proxy_async_smem();  // the outputs, before the producer's bulk store
      __syncwarp();
      if ((threadIdx.x & 31) == 0) rn::mbar_arrive(rn::smem_u32(&done[s]));
    }
  }
}

// The scalar path, run by every thread of a CTA of kThreads: one stage,
// loaded with ordinary loads (copy_in), outputs stored by compute.
template <class P>
__device__ __forceinline__ void run_scalar(const P& pass, unsigned char* smem,
                                           const float* __restrict__ params, int r, int db,
                                           int rows, int tiles_per_bc, int tiles) {
  unsigned char* st = smem + 128;
  pass.pad(st, 1);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Tile t = tile_at(tile, tiles_per_bc, rows, r);
    fill_header(reinterpret_cast<float*>(st), t, params, db, threadIdx.x, kThreads);
    pass.copy_in(st, t);
    __syncthreads();
    pass.compute(st, t);
    __syncthreads();
  }
}

// The host side: raise the kernel's dynamic shared-memory limit to `bytes`
// (once per kernel and size) and prefer shared memory over L1, so that
// several CTAs' rings fit on one SM.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess) granted = bytes;
  return e;
}

}  // namespace resample
}  // namespace rn
