// The fixed-order row reductions shared by the port's row sweeps.
//
// The block layout, for the dense pairwise sweeps (gc_gains.cu,
// disp_gains.cu):
//   res_r = reduce over k = 0 .. n-1 of step(M[g_r, k], m_k, k, g_r)
// for rows g_r of a row-major (n, n) fp32 matrix M and a mask m (n,).
//
// What bounds these sweeps on the H100: bytes.  A full sweep reads M once
// and does ~3 fp32 operations per element: at n = 50,000 that is 10 GB, or
// 2.985 ms at 3.35 TB/s, against 0.11 ms of operations at 67 TFLOP/s.
//
// Order, which the bit contracts rest on: one block of THREADS threads
// reduces a row.  Thread t walks the row's elements k = t, t + THREADS,
// t + 2 THREADS, ... in increasing k, so each warp load is 128 contiguous
// bytes; then the partials meet in a halving tree: inside each warp lane i
// takes lane i + h for h = 16, 8, 4, 2, 1 (__shfl_down_sync), and warp 0
// combines the warp results the same way.  A row's result therefore
// depends on n, its own elements and the mask alone: never on how many
// rows the sweep reads, which ones, or where they sit.
// kernels/row_reduce.py repeats this order in plain PyTorch, and THREADS
// comes from there (kernels/_build.py passes it as ROW_REDUCE_THREADS).
//
// The matrix is read with __ldcs (streamed, evict first) so that the mask
// stays in L2.  Every element offset is 64-bit: 50,000^2 elements lie
// beyond INT_MAX.
//
// The warp layout, for the coverage sweeps fb and psc (fb_gains.cu, sc_gains.cu):
//   res_r = sum over f = 0 .. F-1 of op.term(X[g_r, f], f)
// for rows g_r of a row-major (n, F) fp32 matrix X with F in the hundreds
// to thousands and n up to millions.  A block per row would spend most of
// its time in its tree and in block scheduling there, so one warp sums a
// row: lane l adds the terms of f = l, l + 32, l + 64, ... in increasing f
// (each warp load 128 contiguous bytes, UNROLL loads in flight per lane),
// then the in-warp halving tree (lane i takes lane i + h, h = 16 .. 1).
// The order depends on F alone; kernels/row_reduce.py::reduce_rows_warp
// repeats it.
//
// The vector warp layout, for the SetCover sweep (sc_gains.cu), the same
// sum over rows of an (n, F) matrix in another fixed order: the row is cut
// into chunks of 4 elements (the last one short where F % 4 != 0), lane l
// adds the terms of the chunks c = l, l + 32, l + 64, ... in increasing c,
// a chunk's elements in order, then the in-warp halving tree.  The order
// depends on F alone; kernels/row_reduce.py::reduce_rows_warp4 repeats it.
// A chunk is one 16-byte load where the launcher finds every row and the
// per-column operands 16-byte aligned (F % 4 == 0, aligned bases), else up
// to 4 element loads of the same values, so both paths give the same bits.
// The layout exists for bytes in flight: a 4-byte load per lane and element
// and two more for the per-column operands, as the warp layout issues, held
// the sweep at 89% of its byte bound.  Here a warp keeps VROWS rows in
// flight, VUNROLL 16-byte chunks each, reads a chunk's per-column operands
// once for all VROWS rows, and the blocks are persistent (a grid of as many
// as fit on the card, each warp striding over row groups).

#pragma once

#include "tile_common.cuh"

#ifndef ROW_REDUCE_THREADS
#error "ROW_REDUCE_THREADS is set by kernels/_build.py from kernels/row_reduce.py"
#endif

namespace rowred {
namespace {

constexpr int THREADS = ROW_REDUCE_THREADS;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS % 32 == 0 && (WARPS & (WARPS - 1)) == 0 && WARPS <= 32,
              "a power-of-two number of warps, at most 32");
constexpr int UNROLL = 8;  // element loads in flight per thread
constexpr float kBig = 1e30f;  // DisparityMin's BIG (core/functions/disparity.py)

// Reduce row g of mat with Op (init(), step, combine); the result lands in
// thread 0's return value.  Every thread of the block calls it.
template <class Op>
__device__ __forceinline__ float reduce_row(const float* __restrict__ mat, int64_t n,
                                            const float* __restrict__ m, int64_t g) {
  __shared__ float red[WARPS];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* row = mat + g * n;
  float acc = Op::init();
  for (int64_t base = 0; base < n; base += (int64_t)THREADS * UNROLL) {
    float mv[UNROLL];
    float sv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t c = base + u * THREADS + t;
      const bool ok = c < n;
      mv[u] = ok ? __ldg(m + c) : 0.0f;
      sv[u] = ok ? __ldcs(row + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t c = base + u * THREADS + t;
      if (c < n) acc = Op::step(acc, sv[u], mv[u], c, g);  // nothing past n is added
    }
  }
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) acc = Op::combine(acc, __shfl_down_sync(0xffffffffu, acc, h));
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  float v = Op::init();
  if (warp == 0) {
    v = lane < WARPS ? red[lane] : Op::init();
#pragma unroll
    for (int h = WARPS / 2; h > 0; h >>= 1)
      v = Op::combine(v, __shfl_down_sync(0xffffffffu, v, h));
  }
  return v;
}

// ---- the warp layout -------------------------------------------------------

constexpr int WARP_ROWS = 8;  // rows (warps) per block of the warp layout

// Sum op.term(row[f], f) over f = 0 .. F-1 in the warp layout; the result
// lands in lane 0's return value.  Every lane of the warp calls it.
template <class Op>
__device__ __forceinline__ float reduce_row_warp(const float* __restrict__ row, int64_t F,
                                                 const Op op) {
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
  for (int64_t base = 0; base < F; base += 32 * UNROLL) {
    float sv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t f = base + u * 32 + lane;
      sv[u] = f < F ? __ldcs(row + f) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t f = base + u * 32 + lane;
      if (f < F) acc = __fadd_rn(acc, op.term(sv[u], f));  // nothing past F is added
    }
  }
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, h));
  return acc;
}

// out[r] = the warp-layout sum of row g_r of X (n, F), g_r = r (idx null,
// the full sweep, k == n) or idx[r] clipped to [0, n) (the gathered sweep,
// whose slots with idx[r] < 0 return NEG_INF).  One warp per slot.
template <class Op>
__global__ void __launch_bounds__(WARP_ROWS * 32)
    warp_rows_kernel(const float* __restrict__ x, int64_t n, int64_t F, Op op,
                     const int32_t* __restrict__ idx, int64_t k, float* __restrict__ out) {
  const int64_t slot = (int64_t)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (slot >= k) return;  // the whole warp leaves together
  const int64_t g = tile::gathered(idx, slot, n);
  const float acc = reduce_row_warp(x + g * F, F, op);
  if ((threadIdx.x & 31) == 0) out[slot] = (idx != nullptr && idx[slot] < 0) ? tile::kNegInf : acc;
}

template <class Op>
int launch_warp_rows(const float* x, int64_t n, int64_t F, const Op op, const int32_t* idx,
                     int64_t k, float* out, cudaStream_t s) {
  if (k <= 0 || n <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (k + WARP_ROWS - 1) / WARP_ROWS;
  warp_rows_kernel<Op><<<(unsigned)blocks, WARP_ROWS * 32, 0, s>>>(x, n, F, op, idx, k, out);
  return (int)cudaGetLastError();
}

// ---- the vector warp layout ------------------------------------------------

constexpr int VROWS = 4;    // rows in flight per warp
constexpr int VUNROLL = 4;  // chunks in flight per lane and row

__device__ __forceinline__ float4 zero4() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }

// Element e (0 .. 3, known at compile time once unrolled) of v.
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : (e == 1 ? v.y : (e == 2 ? v.z : v.w));
}

// Chunk c of a row p of F elements: one 16-byte load (VEC), or element
// loads with zeros past F.  STREAM: the matrix (__ldcs, streamed, evict
// first); else a per-column operand kept in cache (__ldg).
template <bool VEC, bool STREAM>
__device__ __forceinline__ float4 load_chunk(const float* __restrict__ p, int64_t c, int64_t F) {
  if constexpr (VEC) {
    const float4* q = reinterpret_cast<const float4*>(p) + c;
    return STREAM ? __ldcs(q) : __ldg(q);
  } else {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t f = 4 * c + e;
      v[e] = f < F ? (STREAM ? __ldcs(p + f) : __ldg(p + f)) : 0.0f;
    }
    return make_float4(v[0], v[1], v[2], v[3]);
  }
}

// out[r] = the vector-warp-layout sum of row r of X (n, F): the sum over f
// of op.term(X[r, f], cols, e), where cols = op.cols<VEC>(c, F) holds the
// per-column operands of chunk c = f / 4 and e = f % 4.  Full sweeps only.
template <class Op, bool VEC>
__global__ void __launch_bounds__(WARP_ROWS * 32)
    warp4_rows_kernel(const float* __restrict__ x, int64_t n, int64_t F, const Op op,
                      float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t chunks = (F + 3) / 4;
  const int64_t first = ((int64_t)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5)) * VROWS;
  const int64_t step = (int64_t)gridDim.x * WARP_ROWS * VROWS;
  for (int64_t r0 = first; r0 < n; r0 += step) {  // the whole warp strides together
    float acc[VROWS];
#pragma unroll
    for (int r = 0; r < VROWS; ++r) acc[r] = 0.0f;
    for (int64_t base = 0; base < chunks; base += 32 * VUNROLL) {
      float4 g[VROWS][VUNROLL];
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        const int64_t c = base + u * 32 + lane;
#pragma unroll
        for (int r = 0; r < VROWS; ++r)
          g[r][u] = (c < chunks && r0 + r < n) ? load_chunk<VEC, true>(x + (r0 + r) * F, c, F)
                                               : zero4();
      }
#pragma unroll
      for (int u = 0; u < VUNROLL; ++u) {
        const int64_t c = base + u * 32 + lane;
        if (c >= chunks) continue;  // nothing past F is added
        const typename Op::Cols cols = op.template cols<VEC>(c, F);
        const int64_t left = F - 4 * c;
#pragma unroll
        for (int r = 0; r < VROWS; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < left) acc[r] = __fadd_rn(acc[r], op.term(elem(g[r][u], e), cols, e));
      }
    }
#pragma unroll
    for (int r = 0; r < VROWS; ++r) {
#pragma unroll
      for (int h = 16; h > 0; h >>= 1)
        acc[r] = __fadd_rn(acc[r], __shfl_down_sync(0xffffffffu, acc[r], h));
      if (lane == 0 && r0 + r < n) out[r0 + r] = acc[r];
    }
  }
}

// Launch the vector warp layout over the n rows of X (n, F); vec: the
// 16-byte path, which the caller picks (every row and per-column operand
// 16-byte aligned).  The grid holds as many blocks as fit on the card, and
// no more than there are row groups.
template <class Op>
int launch_warp4_rows(const float* x, int64_t n, int64_t F, const Op op, bool vec, float* out,
                      cudaStream_t s) {
  if (n <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const void* kernel =
      vec ? (const void*)warp4_rows_kernel<Op, true> : (const void*)warp4_rows_kernel<Op, false>;
  unsigned grid;
  cudaError_t err = tile::resident_grid(kernel, WARP_ROWS * 32, 0,
                                        (n + WARP_ROWS * VROWS - 1) / (WARP_ROWS * VROWS), &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x, (void*)&n, (void*)&F, (void*)&op, (void*)&out};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(WARP_ROWS * 32), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rowred
