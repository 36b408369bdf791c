// Fused dot similarity + facility-location gain sweep:
//   out_c = sum_i max(<x_i, y_c> - curmax_i, 0)
// for x (u, d) represented rows and y (n, d) candidates, each fp32 or bf16,
// with the (u, n) similarity computed block by block in registers and never
// written.  Dot metric only: callers pre-normalise rows for cosine.
//
// Replaces src/repro/kernels/fused_fl_sweep.py::fused_fl_sweep_pallas.  The
// TPU kernel keeps a (BU, BN) similarity tile in VMEM scratch across its K
// strips and adds the relu'd tile into the output block across its u axis,
// both sequential grid axes.  Here the K loop runs inside the block (the
// shared SGEMM tile of tile_common.cuh), and the sum over u is a fixed-order
// second pass instead of a carried accumulator, since blocks run in no
// order.
//
// What bounds it on the H100: operations.  2*u*n*d fp32 FLOP on the CUDA
// cores (67 TFLOP/s; TF32 would miss the fp32 bars): at u = 512, n = 2^20,
// d = 512 that is 5.5e11 FLOP = 8.2 ms, while the features read (1.07 GB
// in fp32, half that in bf16) take 0.32 / 0.16 ms at 3.35 TB/s.
//
// Design: two passes, no atomics; it is the dot case of flmf_gains.cu with
// typed operands and no gather.
//   pass 1: the shared 128 x 128 x 8 SGEMM tile, rows = x, columns = y.  A
//           bf16 operand is widened to fp32 exactly in the tile's loader
//           (its 16 bits become the high half of the fp32), so a bf16 sweep
//           is the fp32 sweep of the widened values, bit for bit, and reads
//           half the bytes.  relu(s - curmax_i) runs in registers; a row
//           past u adds nothing (the JAX wrapper pads curmax with 3e38,
//           whose relu is exactly 0).  The tile's 128 rows are summed in a
//           fixed order (each thread's 8 rows in slot order, then the 16
//           row groups in group order), into partial[u_block, c].
//   pass 2: one thread adds the partials of its column in u_block order.
// A column's arithmetic depends on u, d and its own feature row alone, so
// a sweep over a slice or a gather of y equals the full sweep bit for bit
// at the same row; the launcher (kernels/fused_fl_sweep.py) runs a long
// sweep as column slices that reuse one capped partial scratch.  Every
// element offset is 64-bit.

#include "tile_common.cuh"

namespace tile {
namespace {

template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS) fused_partial_kernel(
    const TX* __restrict__ x, const TY* __restrict__ y, const float* __restrict__ curmax,
    int64_t u, int64_t n, int64_t d, float* __restrict__ partial) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[GROUPS][BN];

  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;  // column group
  const int ty = tid / GROUPS;  // row group
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int64_t ar = row0 + (tid >> 1);  // the x row and candidate this thread loads
  const int64_t bc = col0 + (tid >> 1);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  mainloop(x + (ar < u ? ar : 0) * d, ar < u, y + (bc < n ? bc : 0) * d, bc < n, d, As, Bs,
           acc);

  float colsum[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) colsum[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + tile_pos(ty, i);
    if (r >= u) continue;  // a row past u adds exactly nothing
    const float cm = curmax[r];
#pragma unroll
    for (int j = 0; j < 8; ++j) colsum[j] += fmaxf(acc[i][j] - cm, 0.0f);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) red[ty][tile_pos(tx, j)] = colsum[j];
  __syncthreads();
  if (tid < BN) {
    const int64_t c = col0 + tid;
    if (c < n) {
      float p = 0.0f;
#pragma unroll
      for (int t = 0; t < GROUPS; ++t) p += red[t][tid];
      partial[(int64_t)blockIdx.y * n + c] = p;
    }
  }
}

template <typename TX, typename TY>
int launch_typed(const void* x, const void* y, const float* curmax, int64_t u, int64_t n,
                 int64_t d, float* partial, float* out, cudaStream_t s) {
  const int64_t nblocks = (u + BM - 1) / BM;
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)nblocks);
  fused_partial_kernel<TX, TY><<<grid, THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), curmax, u, n, d, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, nblocks, n, nullptr,
                                                                   out);
  return (int)cudaGetLastError();
}

int launch_fused(const void* x, int x_bf16, const void* y, int y_bf16, const float* curmax,
                 int64_t u, int64_t n, int64_t d, float* partial, float* out, cudaStream_t s) {
  if (u <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if ((u + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  if (x_bf16) {
    return y_bf16 ? launch_typed<bf16_t, bf16_t>(x, y, curmax, u, n, d, partial, out, s)
                  : launch_typed<bf16_t, float>(x, y, curmax, u, n, d, partial, out, s);
  }
  return y_bf16 ? launch_typed<float, bf16_t>(x, y, curmax, u, n, d, partial, out, s)
                : launch_typed<float, float>(x, y, curmax, u, n, d, partial, out, s);
}

}  // namespace
}  // namespace tile

// x (u, d) and y (n, d) row-major, each fp32 or bf16 (x_bf16 / y_bf16 set
// for bf16); curmax (u,) fp32; partial (ceil(u / 128), n) scratch and out
// (n,) allocated by the caller.  Returns cudaGetLastError().
extern "C" int fused_fl_sweep_launch(const void* x, int x_bf16, const void* y, int y_bf16,
                                     const float* curmax, int64_t u, int64_t n, int64_t d,
                                     float* partial, float* out, void* stream) {
  return tile::launch_fused(x, x_bf16, y, y_bf16, curmax, u, n, d, partial, out,
                            static_cast<cudaStream_t>(stream));
}
