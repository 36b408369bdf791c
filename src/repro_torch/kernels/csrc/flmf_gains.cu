// Matrix-free facility-location gain sweep:
//   out_c = sum_i max(metric(x_i, y_{col_c}) - curmax_i, 0)
// with the (u, n) similarity computed block by block in registers and never
// written.
//
// Replaces src/repro/kernels/flmf_gains.py::flmf_gains_pallas (the full
// sweep, col_c = c, NaiveGreedy's every step) and ::flmf_gains_at_pallas
// (the gathered sweep, col_c = idx[c], every LazyGreedy level).
//
// What bounds it on the H100: operations.  2*u*n*d fp32 FLOP on the CUDA
// cores (67 TFLOP/s; TF32 would miss the 2e-5 bars): at u = 512,
// n = 2^20, d = 512 that is 5.5e11 FLOP = 8.2 ms, while the 1.07 GB of
// features read take 0.32 ms at 3.35 TB/s.  At u = n = 50,000 it is
// 2.56e12 FLOP = 38 ms.
//
// Design: two passes, no atomics, on the pipelined mainloop of
// sgemm_pipe.cuh (cp.async copies of 32-k strips ahead of the compute, one
// barrier per strip, one persistent block per SM), as fused_fl_sweep.cu.
//   pass 1: the 128 x 128 tile, rows = represented x, columns = candidates
//           y.  The blocks walk their tiles in pipe::grouped's order, the u
//           blocks of a column tile one after another, so a y tile is read
//           from device memory once.  The metric epilogue and
//           relu(s - curmax_i) run in registers; rows >= u add nothing.
//           The tile's 128 rows are then summed in a fixed order: each
//           thread adds its 8 rows in slot order, then one thread per column
//           adds the 16 row groups' sums in group order through shared
//           memory, into partial[u_block, c].
//   pass 2: one thread adds the partials of its column in u_block order.
// A column's arithmetic (the fmaf chain over d, the epilogue, the order of
// the row sum) therefore depends on u, d and its own feature row alone:
// never on n, k, the column's position or the block it lands in.  The
// pipelined mainloop gives each similarity the fmaf chain of
// tile::mainloop, on which this kernel ran before, so the sweep keeps its
// bits, and fused_fl_sweep's fp32 sweep equals the dot sweep here.
//
// The gathered sweep reads candidate rows through idx where the tile loop
// asks for a thread's rows (idx < 0 slots are padding: they read row 0 and
// return NEG_INF; idx >= n reads row n - 1, as the JAX gather clips).  By
// the argument above it is bit-identical to the full sweep at the same
// index for any k, so the JAX package's rule of keeping its candidate tile
// at the full width (flmf_gains.py:161-166) has no counterpart here.  The
// launcher (kernels/flmf_gains.py) caps the partial scratch at a fixed size
// by running a long sweep as column slices, which changes no column's sum.
// Every element offset is 64-bit.

#include "sgemm_pipe.cuh"

// Everything but the exported launch function sits in tile_common.cuh's
// namespace: no using-directive, which nvcc's host stubs would find ambiguous.
namespace tile {
namespace {

// The kernel's dynamic shared memory: the fp32 mainloop's, then the column
// sums of the 16 row groups.
constexpr int flmf_smem_bytes() { return pipe::smem_bytes<float, float, true>() + GROUPS * BN * 4; }

template <int METRIC, bool VEC, bool TAIL>
__global__ void __launch_bounds__(THREADS, pipe::MIN_BLOCKS) flmf_partial_kernel(
    const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ xx,
    const float* __restrict__ yy, const float* __restrict__ curmax,
    const int32_t* __restrict__ idx, int64_t u, int64_t n, int64_t k, int64_t d,
    float inv2s2, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*red)[BN] =
      reinterpret_cast<float(*)[BN]>(smem + pipe::smem_bytes<float, float, VEC>());

  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;  // column group
  const int ty = tid / GROUPS;  // row group
  const int64_t nbx = (k + BN - 1) / BN, nby = (u + BM - 1) / BM;

  const auto rows = [&](int64_t tile, const float*& a_row, bool& a_ok, const float*& b_row,
                        bool& b_ok) {
    int64_t row0, col0;
    pipe::tile_origin(tile, nbx, nby, row0, col0);
    const int64_t ar = row0 + (tid >> 1);  // the x row and candidate this thread loads
    const int64_t bc = col0 + (tid >> 1);
    a_ok = ar < u;
    b_ok = bc < k;
    a_row = x + (a_ok ? ar : 0) * d;
    b_row = y + (b_ok ? gathered(idx, bc, n) : 0) * d;
  };
  const auto done = [&](int64_t tile, float (&acc)[8][8]) {
    int64_t row0, col0;
    pipe::tile_origin(tile, nbx, nby, row0, col0);
    float ycol[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = col0 + tile_pos(tx, j);
      ycol[j] = (METRIC >= kEuclidean && c < k) ? yy[gathered(idx, c, n)] : 0.0f;
    }
    float colsum[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) colsum[j] = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t r = row0 + tile_pos(ty, i);
      if (r >= u) continue;  // a row past u adds exactly nothing
      const float xr = (METRIC >= kEuclidean) ? xx[r] : 0.0f;
      const float cm = curmax[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float s = epilogue<METRIC>(acc[i][j], xr, ycol[j], inv2s2);
        colsum[j] += fmaxf(s - cm, 0.0f);
      }
    }
    __syncthreads();  // the previous tile's sums have been read
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty][tile_pos(tx, j)] = colsum[j];
    __syncthreads();
    if (tid < BN) {
      const int64_t c = col0 + tid;
      if (c < k) {
        float p = 0.0f;
#pragma unroll
        for (int t = 0; t < GROUPS; ++t) p += red[t][tid];
        partial[row0 / BM * k + c] = p;
      }
    }
  };
  pipe::tile_loop<float, float, VEC, TAIL>(nbx * nby, d, smem, rows, done);
}

template <int METRIC>
const void* kernel_ptr(int vec, int tail) {
  if (vec) {
    return tail ? (const void*)flmf_partial_kernel<METRIC, true, true>
                : (const void*)flmf_partial_kernel<METRIC, true, false>;
  }
  return tail ? (const void*)flmf_partial_kernel<METRIC, false, true>
              : (const void*)flmf_partial_kernel<METRIC, false, false>;
}

// The pass-1 kernel for a metric code and load path, or null for an
// unknown metric.
const void* kernel_for(int metric, int vec, int tail) {
  switch (metric) {
    case kDot:
      return kernel_ptr<kDot>(vec, tail);
    case kCosine:
      return kernel_ptr<kCosine>(vec, tail);
    case kEuclidean:
      return kernel_ptr<kEuclidean>(vec, tail);
    case kRbf:
      return kernel_ptr<kRbf>(vec, tail);
    default:
      return nullptr;
  }
}

int launch_flmf(const float* x, const float* y, const float* xx, const float* yy,
                const float* curmax, const int32_t* idx, int64_t u, int64_t n, int64_t k,
                int64_t d, int metric, float inv2s2, float* partial, float* out,
                cudaStream_t s) {
  if (k <= 0 || u <= 0 || n <= 0 || d <= 0 || d > pipe::MAX_D) return (int)cudaErrorInvalidValue;
  const void* kernel = kernel_for(
      metric, pipe::aligned_rows(x, d, 4) && pipe::aligned_rows(y, d, 4), d % pipe::BK != 0);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t nblocks = (u + BM - 1) / BM;
  const int smem = flmf_smem_bytes();
  cudaError_t err = pipe::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned grid;
  err = pipe::persistent_grid(kernel, smem, ((k + BN - 1) / BN) * nblocks, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x, (void*)&y, (void*)&xx, (void*)&yy, (void*)&curmax, (void*)&idx,
                  (void*)&u, (void*)&n, (void*)&k, (void*)&d, (void*)&inv2s2, (void*)&partial};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)((k + 255) / 256), 256, 0, s>>>(partial, nblocks, k, idx,
                                                                   out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tile

// x (u, d), y (n, d) row-major fp32; xx (u,), yy (n,) row sums of squares
// (read only for euclidean / rbf); curmax (u,); idx (k,) int32 or null for
// the full sweep (then k == n); partial (ceil(u / 128), k) scratch and out
// (k,) allocated by the caller.  metric: 0 dot, 1 cosine (rows
// pre-normalised), 2 euclidean, 3 rbf.  Rows that all start 16-byte aligned
// take the 16-byte copy path, others the element-wise one, with the same
// bits.  Returns cudaGetLastError().
extern "C" int flmf_gains_launch(const float* x, const float* y, const float* xx,
                                 const float* yy, const float* curmax, const int32_t* idx,
                                 int64_t u, int64_t n, int64_t k, int64_t d, int metric,
                                 float inv2s2, float* partial, float* out, void* stream) {
  return tile::launch_flmf(x, y, xx, yy, curmax, idx, u, n, k, d, metric, inv2s2, partial, out,
                           static_cast<cudaStream_t>(stream));
}
