// Fused dot similarity + facility-location gain sweep:
//   out_c = sum_i max(<x_i, y_c> - curmax_i, 0)
// for x (u, d) represented rows and y (n, d) candidates, each fp32 or bf16,
// with the (u, n) similarity computed block by block in registers and never
// written.  Dot metric only: callers pre-normalise rows for cosine.
//
// Replaces src/repro/kernels/fused_fl_sweep.py:59 fused_fl_sweep_pallas
// (its pl.pallas_call at :87): x (u, d), y (n, d) fp32 or bf16, curmax (u,)
// -> (n,) fp32.  The TPU kernel keeps a (BU, BN) similarity tile in VMEM
// scratch across its K strips and adds the relu'd tile into the output
// block across its u axis, both sequential grid axes.  Here the K loop runs
// inside the block, and the sum over u is a fixed-order second pass instead
// of a carried accumulator, since blocks run in no order.
//
// What bounds it on the H100: operations.  2*u*n*d fp32 FLOP on the CUDA
// cores (67 TFLOP/s; TF32 would miss the fp32 bars and end the bit
// contracts below): at u = 512, n = 2^20, d = 512 that is 5.5e11 FLOP =
// 8.205 ms, while the features read (1.07 GB in fp32, half that in bf16)
// take 0.32 / 0.16 ms at 3.35 TB/s.
//
// Design: two passes, no atomics; the dot case of flmf_gains.cu with typed
// operands and no gather, on the same pipelined mainloop of sgemm_pipe.cuh
// (cp.async copies of 32-k strips ahead of the compute, one barrier per
// strip, conflict-free shared memory).
//   pass 1: the 128 x 128 tile, rows = x, columns = y.  A bf16 operand is
//           copied as it is and widened to fp32 exactly in shared memory
//           (its 16 bits become the high half of the fp32), so a bf16 sweep
//           is the fp32 sweep of the widened values, bit for bit, and reads
//           half the bytes.  relu(s - curmax_i) runs in registers; a row
//           past u adds nothing (the JAX wrapper pads curmax with 3e38,
//           whose relu is exactly 0).  The tile's 128 rows are summed in a
//           fixed order (each thread's 8 rows in slot order, then the 16
//           row groups in group order), into partial[u_block, c].  The
//           blocks are persistent, one per SM, with one stream of strips
//           through the ring across their tiles (pipe::tile_loop), and take
//           the u blocks of a column tile one after another (pipe::grouped),
//           so a y tile is read from device memory once, not once per u
//           block.
//   pass 2: one thread adds the partials of its column in u_block order.
// A column's arithmetic depends on u, d and its own feature row alone, so
// a sweep over a slice or a gather of y equals the full sweep bit for bit
// at the same row, and an fp32 sweep equals flmf_gains(..., "dot"); the
// launcher (kernels/fused_fl_sweep.py) runs a long sweep as column slices
// that reuse one capped partial scratch.  Every element offset is 64-bit.

#include "sgemm_pipe.cuh"

namespace tile {
namespace {

// The kernel's dynamic shared memory: the mainloop's, then the column sums
// of the 16 row groups.
template <typename TX, typename TY, bool VEC>
constexpr int smem_bytes() {
  return pipe::smem_bytes<TX, TY, VEC>() + GROUPS * BN * 4;
}

template <typename TX, typename TY, bool VEC, bool TAIL>
__global__ void __launch_bounds__(THREADS, pipe::MIN_BLOCKS) fused_partial_kernel(
    const TX* __restrict__ x, const TY* __restrict__ y, const float* __restrict__ curmax,
    int64_t u, int64_t n, int64_t d, float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*red)[BN] = reinterpret_cast<float(*)[BN]>(smem + pipe::smem_bytes<TX, TY, VEC>());

  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;  // column group
  const int ty = tid / GROUPS;  // row group
  const int64_t nbx = (n + BN - 1) / BN, nby = (u + BM - 1) / BM;

  const auto rows = [&](int64_t tile, const TX*& a_row, bool& a_ok, const TY*& b_row,
                        bool& b_ok) {
    int64_t row0, col0;
    pipe::tile_origin(tile, nbx, nby, row0, col0);
    const int64_t ar = row0 + (tid >> 1);  // the x row and candidate this thread loads
    const int64_t bc = col0 + (tid >> 1);
    a_ok = ar < u;
    b_ok = bc < n;
    a_row = x + (a_ok ? ar : 0) * d;
    b_row = y + (b_ok ? bc : 0) * d;
  };
  const auto done = [&](int64_t tile, float (&acc)[8][8]) {
    int64_t row0, col0;
    pipe::tile_origin(tile, nbx, nby, row0, col0);
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
    __syncthreads();  // the previous tile's sums have been read
#pragma unroll
    for (int j = 0; j < 8; ++j) red[ty][tile_pos(tx, j)] = colsum[j];
    __syncthreads();
    if (tid < BN) {
      const int64_t c = col0 + tid;
      if (c < n) {
        float p = 0.0f;
#pragma unroll
        for (int t = 0; t < GROUPS; ++t) p += red[t][tid];
        partial[row0 / BM * n + c] = p;
      }
    }
  };
  pipe::tile_loop<TX, TY, VEC, TAIL>(nbx * nby, d, smem, rows, done);
}

template <typename TX, typename TY, bool VEC, bool TAIL>
const void* kernel_ptr(int* smem) {
  *smem = smem_bytes<TX, TY, VEC>();
  return (const void*)fused_partial_kernel<TX, TY, VEC, TAIL>;
}

template <typename TX, typename TY>
const void* kernel_ptr(int vec, int tail, int* smem) {
  if (vec) {
    return tail ? kernel_ptr<TX, TY, true, true>(smem) : kernel_ptr<TX, TY, true, false>(smem);
  }
  return tail ? kernel_ptr<TX, TY, false, true>(smem) : kernel_ptr<TX, TY, false, false>(smem);
}

const void* kernel_for(int x_bf16, int y_bf16, int vec, int tail, int* smem) {
  if (x_bf16) {
    return y_bf16 ? kernel_ptr<bf16_t, bf16_t>(vec, tail, smem)
                  : kernel_ptr<bf16_t, float>(vec, tail, smem);
  }
  return y_bf16 ? kernel_ptr<float, bf16_t>(vec, tail, smem)
                : kernel_ptr<float, float>(vec, tail, smem);
}

int launch_fused(const void* x, int x_bf16, const void* y, int y_bf16, const float* curmax,
                 int64_t u, int64_t n, int64_t d, float* partial, float* out, cudaStream_t s) {
  if (u <= 0 || n <= 0 || d <= 0 || d > pipe::MAX_D) return (int)cudaErrorInvalidValue;
  const int64_t nblocks = (u + BM - 1) / BM;
  const int vec =
      pipe::aligned_rows(x, d, x_bf16 ? 2 : 4) && pipe::aligned_rows(y, d, y_bf16 ? 2 : 4);
  int smem;
  const void* kernel = kernel_for(x_bf16, y_bf16, vec, d % pipe::BK != 0, &smem);
  cudaError_t err = pipe::allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  unsigned grid;
  err = pipe::persistent_grid(kernel, smem, ((n + BN - 1) / BN) * nblocks, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x, (void*)&y, (void*)&curmax, (void*)&u, (void*)&n, (void*)&d,
                  (void*)&partial};
  err = cudaLaunchKernel(kernel, dim3(grid), dim3(THREADS), args, (size_t)smem, s);
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, nblocks, n, nullptr,
                                                                   out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tile

// x (u, d) and y (n, d) row-major, each fp32 or bf16 (x_bf16 / y_bf16 set
// for bf16); curmax (u,) fp32; partial (ceil(u / 128), n) scratch and out
// (n,) allocated by the caller.  Rows that all start 16-byte aligned take
// the 16-byte copy path, others the element-wise one, with the same bits.
// Returns cudaGetLastError().
extern "C" int fused_fl_sweep_launch(const void* x, int x_bf16, const void* y, int y_bf16,
                                     const float* curmax, int64_t u, int64_t n, int64_t d,
                                     float* partial, float* out, void* stream) {
  return tile::launch_fused(x, x_bf16, y, y_bf16, curmax, u, n, d, partial, out,
                            static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the pass-1 kernel that fused_fl_sweep_launch
// runs for (x_bf16, y_bf16) at d % 32 == 0 on its 16-byte copy path
// (vec = 1) or its element-wise one (vec = 0), into *blocks.  Returns a
// CUDA error code.
extern "C" int fused_fl_sweep_blocks_per_sm(int x_bf16, int y_bf16, int vec, int* blocks) {
  int smem;
  const void* kernel = tile::kernel_for(x_bf16, y_bf16, vec, 0, &smem);
  return (int)tile::pipe::blocks_per_sm(kernel, smem, blocks);
}
