// The fixed-order row reductions shared by the port's row sweeps.
//
// The block layout, for DisparityMin's row stream (disp_gains.cu's dmin
// once 8 |A| >= n):
//   res_r = reduce over k = 0 .. n-1 of step(M[r, k], m_k)
// for rows r of a row-major (n, n) fp32 matrix M and a mask m (n,).
//
// What bounds it on the H100: bytes.  A full sweep reads M once and does
// ~3 fp32 operations per element: at n = 50,000 that is 10 GB, or 2.985 ms
// at 3.35 TB/s, against 0.11 ms of operations at 67 TFLOP/s.
//
// Order: one block of THREADS threads reduces a row.  Thread t walks the
// row's elements k = t, t + THREADS, t + 2 THREADS, ... in increasing k, so
// each warp load is 128 contiguous bytes; then the partials meet in a
// halving tree: inside each warp lane i takes lane i + h for h = 16, 8, 4,
// 2, 1 (__shfl_down_sync), and warp 0 combines the warp results the same
// way.  A row's result therefore depends on n, its own elements and the
// mask alone.  kernels/row_reduce.py repeats this order in plain PyTorch,
// and THREADS comes from there (kernels/_build.py passes it as
// ROW_REDUCE_THREADS).
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
//
// The selected-columns warp layout, for the dense pairwise sums over the
// selection (gc_gains.cu, disp_gains.cu's dsum):
//   res_r = sum over t = 0 .. F-1 of M[g_r, sel[t]] * op.weight(m[sel[t]])
// for rows g_r of a row-major (n, n) fp32 matrix M, with sel the ascending
// list of the F = nsel selected columns (select_cols.cu, both on the
// device).  The mask needs those F columns only: 32 n F bytes at one 32-byte
// sector per gathered element, against 4 n^2 for the row stream.  Order:
// the warp layout's, over F: lane l adds the terms of t = l, l + 32, ... in
// increasing t, then the in-warp halving tree.  It depends on nsel and the
// list alone, so a row's sum is the same whichever rows are swept with it.
// A sum has an order, so unlike dmin's min there is no second, streaming
// branch: one would add the same terms in another order and give other
// bits.  None is needed: the list is ascending, so once the selection is
// dense a warp's lanes read neighbouring columns, and at F = n the gather
// is a row stream.  kernels/row_reduce.py::reduce_selected_warp repeats
// the order.  A block of SEL_WARPS warps sums SEL_ROWS rows per warp and
// walks the list in chunks of SEL_CHUNK positions: its threads stage a
// chunk's columns and weights in shared memory once, and every warp reads
// them there for all its rows, SEL_ROWS x UNROLL gathered loads in flight
// per lane.  The launcher runs the compaction itself (select_cols_launch,
// into the caller's scratch) and then the sweep: one call from the host,
// whose cost bounds the gathered sweeps, not two.

#pragma once

#include "tile_common.cuh"

#if !defined(ROW_REDUCE_THREADS) || !defined(ROW_REDUCE_SEL_CHUNK) || !defined(SELECT_CHUNK)
#error "ROW_REDUCE_THREADS, ROW_REDUCE_SEL_CHUNK and SELECT_CHUNK are set by kernels/_build.py"
#endif

// The mask compaction (select_cols.cu), which the selected-columns launcher runs
extern "C" int select_cols_launch(const float* m, int64_t n, int pred, int32_t* sel, int32_t* blk,
                                  void* stream);

namespace rowred {
namespace {

constexpr int THREADS = ROW_REDUCE_THREADS;
constexpr int WARPS = THREADS / 32;
static_assert(THREADS % 32 == 0 && (WARPS & (WARPS - 1)) == 0 && WARPS <= 32,
              "a power-of-two number of warps, at most 32");
constexpr int UNROLL = 8;  // element loads in flight per thread
constexpr float kBig = 1e30f;  // DisparityMin's BIG (core/functions/disparity.py)

// Reduce row g of mat with Op (init(), step(acc, s, m), combine); the result
// lands in thread 0's return value.  Every thread of the block calls it.
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
      if (c < n) acc = Op::step(acc, sv[u], mv[u]);  // nothing past n is added
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

// ---- the selected-columns warp layout --------------------------------------

constexpr int SEL_WARPS = 8;  // warps per block
constexpr int SEL_ROWS = 4;   // rows per warp, summed together
constexpr int SEL_CHUNK = ROW_REDUCE_SEL_CHUNK;  // list positions staged per round
static_assert(SEL_CHUNK % 32 == 0, "a chunk holds whole rounds of the warp's lanes");

// out[r] = op.finish(res_r, g_r), res_r the selected-columns sum of row g_r
// of M (n, n), g_r = r (idx null, the full sweep, k == n) or idx[r]
// clipped to [0, n) (the gathered sweep, whose slots with idx[r] < 0 return
// NEG_INF).  Op: weight(m_c), the factor of column c's terms, and
// finish(res, g).
template <class Op>
__global__ void __launch_bounds__(SEL_WARPS * 32)
    sel_rows_kernel(const float* __restrict__ mat, int64_t n, const float* __restrict__ m,
                    const int32_t* __restrict__ sel, const int32_t* __restrict__ nsel,
                    const int32_t* __restrict__ idx, int64_t k, const Op op,
                    float* __restrict__ out) {
  __shared__ int32_t cols[SEL_CHUNK];
  __shared__ float wts[SEL_CHUNK];
  const int lane = threadIdx.x & 31;
  const int64_t slot0 = ((int64_t)blockIdx.x * SEL_WARPS + (threadIdx.x >> 5)) * SEL_ROWS;
  const int64_t F = *nsel;
  const float* row[SEL_ROWS];
  float acc[SEL_ROWS];
#pragma unroll
  for (int r = 0; r < SEL_ROWS; ++r) {
    row[r] = slot0 + r < k ? mat + tile::gathered(idx, slot0 + r, n) * n : nullptr;
    acc[r] = 0.0f;
  }
  for (int64_t base = 0; base < F; base += SEL_CHUNK) {
    const int cnt = F - base < SEL_CHUNK ? (int)(F - base) : SEL_CHUNK;
    __syncthreads();  // every warp is done with the previous chunk
    for (int i = threadIdx.x; i < cnt; i += SEL_WARPS * 32) {
      const int32_t c = __ldg(sel + base + i);
      cols[i] = c;
      wts[i] = op.weight(__ldg(m + c));
    }
    __syncthreads();
    // lane l: positions base + l, base + l + 32, ... in increasing order
    for (int p = lane; p < cnt; p += 32 * UNROLL) {
      float v[SEL_ROWS][UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = p + 32 * u;
        const int64_t c = t < cnt ? cols[t] : 0;
#pragma unroll
        for (int r = 0; r < SEL_ROWS; ++r)
          v[r][u] = (t < cnt && row[r] != nullptr) ? __ldcs(row[r] + c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int t = p + 32 * u;
        if (t >= cnt) break;  // nothing past the list is added
        const float w = wts[t];
#pragma unroll
        for (int r = 0; r < SEL_ROWS; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn(v[r][u], w));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < SEL_ROWS; ++r) {
#pragma unroll
    for (int h = 16; h > 0; h >>= 1)
      acc[r] = __fadd_rn(acc[r], __shfl_down_sync(0xffffffffu, acc[r], h));
    const int64_t slot = slot0 + r;
    if (lane == 0 && slot < k)
      out[slot] = (idx != nullptr && idx[slot] < 0)
                      ? tile::kNegInf
                      : op.finish(acc[r], tile::gathered(idx, slot, n));
  }
}

// Compact the columns m_c != 0 into sel (n,) and blk (ceil(n /
// SELECT_CHUNK) + 1,), scratch of the caller's (select_cols_launch, whose
// last blk entry is the count nsel), then launch the selected-columns warp
// layout over k rows (k == n for the full sweep, idx null), all in stream
// order, with no host read.
template <class Op>
int launch_sel_rows(const float* mat, int64_t n, const float* m, int32_t* sel, int32_t* blk,
                    const int32_t* idx, int64_t k, const Op op, float* out, cudaStream_t s) {
  if (k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const int rc = select_cols_launch(m, n, /*pred m_c != 0*/ 1, sel, blk, s);
  if (rc != 0) return rc;
  const int32_t* nsel = blk + (n + SELECT_CHUNK - 1) / SELECT_CHUNK;
  const int64_t rows = SEL_WARPS * SEL_ROWS;
  sel_rows_kernel<Op><<<(unsigned)((k + rows - 1) / rows), SEL_WARPS * 32, 0, s>>>(
      mat, n, m, sel, nsel, idx, k, op, out);
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
