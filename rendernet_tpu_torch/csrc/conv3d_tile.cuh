// The tile walk, halo ring and shared-memory layouts that the tensor-core
// paths of K2 (conv3d.cu; bf16, and fp32 on narrower columns) and K2w
// (conv3d_wgrad.cu) share.
//
// Positions [B, H, W, D] are cut into columns of TW x TD positions along W
// and D (one (b, w-tile, d-tile) each), and every column into H rows, one
// per h. A row needs the three halo planes h - 1, h, h + 1 of its column:
// (TW + 2) x (TD + 2) positions x the channels, zero outside the volume
// (SAME padding). The rows of all columns, column by column, are split into
// `grid` contiguous ranges, one per CTA (persistent, one per SM). A CTA
// walks its range row by row; within a column it loads each plane once and
// slides its three-plane window down h, so x is read ~(TW + 2)(TD + 2) /
// (TW TD) = 1.33x from L2. Planes
// arrive by cp.async into a ring of R = P + 3 slots, P planes ahead of the
// row being computed; one barrier per row guards the ring.
//
// Every shared-memory row of 16-byte chunks is XOR-swizzled (swz) so that
// the eight row addresses of one ldmatrix phase, eight consecutive rows at
// one logical chunk, hit eight different bank groups.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace rn3 {

using bf16 = __nv_bfloat16;

constexpr int TW = 8;          // W positions of a column (a warp each in K2)
constexpr int TD = 32;         // D positions of a column (two 16-row fragments)
constexpr int HW = TW + 2, HD = TD + 2;
constexpr int P = 2;           // planes loading ahead of the row computed on
constexpr int R = P + 3;       // ring slots: the row's three planes and P more

struct Geom {
  int B, H, W, D, C;
  int nwt, ndt;     // columns along W and D
  long long rows;   // B * nwt * ndt * H
};

// Columns of TWX W positions (TW unless said otherwise).
template <int TWX = TW>
__host__ inline Geom make_geom(int B, int H, int W, int D, int C) {
  Geom g{B, H, W, D, C, (W + TWX - 1) / TWX, (D + TD - 1) / TD, 0};
  g.rows = static_cast<long long>(B) * g.nwt * g.ndt * H;
  return g;
}

struct Column {
  int b, w0, d0;
};

// Column index -> (b, first w, first d); d-tiles vary fastest, then w-tiles.
template <int TWX = TW>
__device__ __forceinline__ Column column(const Geom& g, long long col) {
  Column c;
  c.d0 = static_cast<int>(col % g.ndt) * TD;
  col /= g.ndt;
  c.w0 = static_cast<int>(col % g.nwt) * TWX;
  c.b = static_cast<int>(col / g.nwt);
  return c;
}

__device__ __forceinline__ long long pix(const Geom& g, int b, int h, int w, int d) {
  return ((static_cast<long long>(b) * g.H + h) * g.W + w) * g.D + d;
}

// Byte offset of logical 16-byte chunk `chunk` of row `row` in a buffer of
// rows of NCH chunks (NCH = 2, 4 or 8): any eight consecutive rows at one
// chunk land in eight different 16-byte bank groups.
template <int NCH>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(NCH == 2 || NCH == 4 || NCH == 8, "rows of 2, 4 or 8 chunks");
  return (row * NCH + (chunk ^ ((row / (8 / NCH)) & (NCH - 1)))) * 16;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void ldsm_x4(unsigned r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned r[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// One halo plane of channels [c0, c0 + EPC NCH) of x (EPC = 16 /
// sizeof(E) elements per 16-byte chunk) into a ring slot at shared address
// dst (generic pointer dstp), laid out [w'][d'][chunk] swizzled: plane q of
// column c (HWX = its W positions + 2), zeros outside the volume and past
// C. VEC: C % EPC == 0, so each 16-byte chunk is wholly inside or outside
// and goes by cp.async; otherwise element by element, synchronously.
template <int NCH, bool VEC, typename E = bf16, int HWX = HW>
__device__ __forceinline__ void load_plane(const E* __restrict__ x, const Geom& g,
                                           const Column& c, int q, int c0, uint32_t dst,
                                           unsigned char* dstp, int tid, int nthreads) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(E));
  const bool hin = q >= 0 && q < g.H;
  if constexpr (VEC) {
    for (int i = tid; i < HWX * HD * NCH; i += nthreads) {
      const int ch = i % NCH, p = i / NCH;
      const int wi = c.w0 + p / HD - 1, di = c.d0 + p % HD - 1, cc = c0 + ch * EPC;
      const bool ok = hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && cc < g.C;
      const E* src = ok ? x + pix(g, c.b, q, wi, di) * g.C + cc : x;
      cp_async16(dst + swz<NCH>(p, ch), src, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < HWX * HD * NCH * EPC; i += nthreads) {
      const int e = i % (NCH * EPC), p = i / (NCH * EPC);
      const int wi = c.w0 + p / HD - 1, di = c.d0 + p % HD - 1, cc = c0 + e;
      const bool ok = hin && wi >= 0 && wi < g.W && di >= 0 && di < g.D && cc < g.C;
      const E v = ok ? x[pix(g, c.b, q, wi, di) * g.C + cc] : rn::from_f32<E>(0.f);
      *reinterpret_cast<E*>(dstp + swz<NCH>(p, e / EPC) + (e % EPC) * sizeof(E)) = v;
    }
  }
}

// The planes a CTA loads, in order: for each run [hs, he) of its rows
// inside one column, the planes hs - 1 .. he. Uniform across the CTA.
struct PlaneSeq {
  long long col, r1;
  int H, hs, q, qe;

  __device__ __forceinline__ void init(long long r0, long long r1_, int H_) {
    H = H_;
    r1 = r1_;
    col = r0 / H;
    hs = static_cast<int>(r0 % H);
    q = hs - 1;
    qe = static_cast<int>(min(static_cast<long long>(H), r1 - col * H));
  }

  // The next plane: its column, its h and whether h is one of the run's own
  // rows (not the halo plane above or below it); false past the last one.
  __device__ __forceinline__ bool next(long long& c, int& h, bool& own) {
    if (q > qe) {
      if ((col + 1) * H >= r1) return false;
      ++col;
      hs = 0;
      q = -1;
      qe = static_cast<int>(min(static_cast<long long>(H), r1 - col * H));
    }
    c = col;
    h = q++;
    own = h >= hs && h < qe;
    return true;
  }
};

// cp.async.wait_group for at most `pending` groups still in flight (0 or 1:
// the ring keeps at most 2 planes ahead, one of which may still be loading).
__device__ __forceinline__ void wait_planes(int pending) {
  if (pending >= 1)
    rn::cp_async_wait<1>();
  else
    rn::cp_async_wait<0>();
}

// The row walk shared by K2 and K2w: for each row r of [r0, r1) (column
// col, plane h), `issue(seq, slot)` loads the next plane of seq into ring
// slot `slot` and commits one cp.async group (it returns false when seq is
// done, committing nothing); `row(col, h, m)` computes the row from slots
// (m - 2) % RS, (m - 1) % RS and m % RS (planes h - 1, h, h + 1). A ring
// of RS = PF + 3 slots keeps PF <= 2 planes loading ahead (K2's fp32 form:
// RS = 4, PF = 1).
template <int RS = R, int PF = P, typename Issue, typename Row>
__device__ __forceinline__ void walk_rows(long long r0, long long r1, int H, Issue&& issue,
                                          Row&& row) {
  static_assert(RS == PF + 3 && PF >= 1 && PF <= 2, "a ring of PF + 3 slots");
  PlaneSeq seq;
  seq.init(r0, r1, H);
  int issued = 0;  // planes issued (one cp.async group each)
  int m = -1;      // index of plane h + 1 of the current row in seq
  for (long long r = r0; r < r1; ++r) {
    const int h = static_cast<int>(r % H);
    m += (r == r0 || h == 0) ? 3 : 1;
    if (issued <= m) {
      // A new run's planes: their slots held planes the previous row read.
      __syncthreads();
      while (issued <= m) issue(seq, issued++ % RS);
    }
    wait_planes(issued - m - 1);
    __syncthreads();  // plane m is in every thread's view; row r - 1 is done
    // Prefetch up to plane m + PF: its slot held plane m - 3, which no row
    // from r on reads.
    while (issued <= m + PF && issue(seq, issued % RS)) ++issued;
    row(r / H, h, m);
  }
  rn::cp_async_wait<0>();
}

}  // namespace rn3
