// Facility-location gain sweeps: out_j = sum_i max(S[i, col_j] - curmax_i, 0).
//
// Replaces src/repro/kernels/fl_gains.py::fl_gains_pallas (the full sweep,
// col_j = j, NaiveGreedy's every step) and ::fl_gains_at_pallas (the
// gathered sweep, col_j = idx[j], every LazyGreedy level).
//
// What bounds it on the H100: bytes.  The full sweep reads S (u, n) once
// and does 3 fp32 operations per element: at u = n = 50,000 that is 10 GB
// at 3.35 TB/s = 3.0 ms, while the 7.5e9 operations take 0.11 ms at
// 67 TFLOP/s.
// The gathered sweep at small k moves almost nothing (1.6 MB at k = 8) and
// is bound by launch and memory latency: each thread's column is strided by
// a whole row, so a 32-byte sector brings 4 useful bytes.
//
// Design: two passes, no atomics.
//   pass 1: the u rows are cut into fixed chunks of `rows_per_chunk`; one
//           thread sums one column over one chunk, rows in order, into
//           partial[c, j].  Neighbouring threads take neighbouring columns,
//           so in the full sweep a warp reads 128 contiguous bytes of a row.
//           Splitting u gives the card enough blocks: at n = 50,000 one
//           block per 256 columns alone would be ~196 blocks on 132 SMs.
//   pass 2: one thread adds the partials of its column in chunk order
//           (tile_common.cuh's sum_partials_kernel).
// A column's summation order therefore depends on u alone: never on n, k,
// the column's position or the block's shape.  That is what makes the
// gathered sweep bit-identical to the full sweep at the same index; the
// plain PyTorch version (kernels/fl_gains.py) adds in the same order.
// Slots with idx < 0 are padding and return NEG_INF; idx >= n reads column
// n - 1, as the JAX gather clips.  Every element offset is 64-bit: S at
// 50,000 x 50,000 holds 2.5e9 elements, beyond INT_MAX.

#include "tile_common.cuh"

namespace {

__global__ void fl_partial_kernel(const float* __restrict__ sim, int64_t ld, int64_t u,
                                  int64_t n, const float* __restrict__ curmax,
                                  const int32_t* __restrict__ idx, int64_t k,
                                  int64_t rows_per_chunk, int64_t nchunks,
                                  float* __restrict__ partial) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t c = (int64_t)blockIdx.y * blockDim.y + threadIdx.y;
  if (j >= k || c >= nchunks) return;
  const int64_t col = tile::gathered(idx, j, n);
  const int64_t r0 = c * rows_per_chunk;
  const int64_t r1 = (r0 + rows_per_chunk < u) ? r0 + rows_per_chunk : u;
  const float* p = sim + r0 * ld + col;
  float acc = 0.0f;
#pragma unroll 8
  for (int64_t r = r0; r < r1; ++r, p += ld) {
    acc += fmaxf(__ldg(p) - __ldg(curmax + r), 0.0f);
  }
  partial[c * k + j] = acc;
}

}  // namespace

// sim (u, n) fp32 with row stride ld; curmax (u,); idx (k,) int32 or null
// for the full sweep (then k == n); partial (ceil(u / rows_per_chunk), k)
// scratch and out (k,) allocated by the caller.  Returns cudaGetLastError().
extern "C" int fl_gains_launch(const float* sim, int64_t ld, int64_t u, int64_t n,
                               const float* curmax, const int32_t* idx, int64_t k,
                               int64_t rows_per_chunk, float* partial, float* out,
                               void* stream) {
  if (k <= 0 || u <= 0 || rows_per_chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nchunks = (u + rows_per_chunk - 1) / rows_per_chunk;
  // block = bx columns x by chunks, 256 threads; a narrow gathered sweep
  // spends its threads on chunks instead of idle columns
  int bx = 1;
  while (bx < k && bx < 256) bx *= 2;
  const int by = 256 / bx;
  const dim3 block(bx, by);
  const dim3 grid((unsigned)((k + bx - 1) / bx), (unsigned)((nchunks + by - 1) / by));
  fl_partial_kernel<<<grid, block, 0, s>>>(sim, ld, u, n, curmax, idx, k, rows_per_chunk,
                                           nchunks, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile::sum_partials_kernel<<<(unsigned)((k + 255) / 256), 256, 0, s>>>(partial, nchunks, k,
                                                                         idx, out);
  return (int)cudaGetLastError();
}

// Message for a code returned by the launch functions above.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
