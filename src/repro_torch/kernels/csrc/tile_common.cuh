// Building blocks shared by the port's kernels: the 128 x 128 register-
// blocked fp32 SGEMM tile's thread layout and its 8 x 8 strip mainloop, the
// metric epilogue applied to its accumulators in registers, and the in-order
// sum of per-block partials (fl_gains.cu, flmf_gains.cu, fused_fl_sweep.cu,
// gcmf_gains.cu).
//
// The tile: one block of 256 threads owns a 128 x 128 output tile, and each
// thread keeps an 8 x 8 accumulator tile in registers, at rows tile_pos(ty,
// i) and columns tile_pos(tx, j).  Each accumulator is one fmaf chain over
// k = 0 .. d-1 in order, so an element's value depends on its two feature
// rows alone, never on where in the tile (or in which tile) they sit.  The
// operands may be fp32 or bf16: a bf16 value is widened to fp32 exactly, so
// the tile's arithmetic is the fp32 tile's on the widened values.
//
// Two mainloops compute that tile, bit for bit alike:
// - tile::mainloop below, for gcmf_gains.cu alone: K strips of 8 loaded
//   element by element and staged transposed (k-major), two barriers per
//   strip, no prefetch;
// - pipe::tile_loop in sgemm_pipe.cuh, for similarity.cu, fused_fl_sweep.cu
//   and flmf_gains.cu: cp.async copies of 32-k strips into a ring ahead of
//   the compute, one barrier per strip, persistent blocks, written for
//   Hopper's SMs.
// gcmf, redesigned to read only the selected columns, stays on
// tile::mainloop; moving it and retiring tile::mainloop is a simplification
// still to make, not a redesign.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Everything here has internal linkage (anonymous namespace): each .cu that
// includes it gets its own copy, so the objects link into one library.
namespace tile {
namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output cols per block
constexpr int BK = 8;    // contraction strip staged in shared memory
constexpr int THREADS = 256;
constexpr int GROUPS = 16;  // thread groups along each tile axis (16 x 16 threads)
constexpr float kNegInf = -1e30f;

enum Metric { kDot = 0, kCosine = 1, kEuclidean = 2, kRbf = 3 };

// A bf16 element as its 16 bits: the high half of the fp32 it widens to.
struct bf16_t {
  uint16_t bits;
};

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const bf16_t* p) {
  const unsigned short b = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

template <int METRIC>
__device__ __forceinline__ float epilogue(float acc, float xx, float yy, float inv2s2) {
  if (METRIC == kDot) return acc;
  if (METRIC == kCosine) return 0.5f * (1.0f + acc);
  const float d2 = fmaxf(xx + yy - 2.0f * acc, 0.0f);
  if (METRIC == kEuclidean) return 1.0f / (1.0f + sqrtf(d2));
  return expf(-d2 * inv2s2);
}

// Row (or column) of the 128-wide tile held by register slot i of thread
// group t: slots 0..3 sit at t*4 + i, slots 4..7 at 64 + t*4 + (i - 4), so
// a warp's shared-memory float4 reads are contiguous.
__device__ __forceinline__ int tile_pos(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

// acc[i][j] += <a_{tile_pos(ty, i)}, b_{tile_pos(tx, j)}> over k = 0 .. d-1,
// with ty = threadIdx.x / 16, tx = threadIdx.x % 16.  a_row / b_row are the
// rows this thread loads: row threadIdx.x / 2 of the block's A and B tiles
// (a gather is the caller's choice of pointer).  A row whose flag is false
// lies past a ragged edge: it is never read and loads zeros.
template <typename TA, typename TB>
__device__ __forceinline__ void mainloop(const TA* a_row, bool a_ok, const TB* b_row,
                                         bool b_ok, int64_t d, float (&As)[BK][BM],
                                         float (&Bs)[BK][BN], float (&acc)[8][8]) {
  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;
  const int ty = tid / GROUPS;
  const int lr = tid >> 1;
  const int lk = (tid & 1) * 4;  // each thread loads 4 consecutive k of its row
  for (int64_t k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t gk = k0 + lk + q;
      As[lk + q][lr] = (a_ok && gk < d) ? load_f32(a_row + gk) : 0.0f;
      Bs[lk + q][lr] = (b_ok && gk < d) ? load_f32(b_row + gk) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Index of gathered item c: idx[c] (int32 or int64) clipped to [0, n) as
// the JAX gather clips, or c itself when there is no idx.
template <typename IdxT>
__device__ __forceinline__ int64_t gathered(const IdxT* __restrict__ idx, int64_t c, int64_t n) {
  if (idx == nullptr) return c;
  const int64_t g = idx[c];
  return g < 0 ? 0 : (g >= n ? n - 1 : g);
}

// The grid of a persistent kernel for `units` units of work: as many blocks
// of `threads` threads and `smem` bytes of dynamic shared memory as fit on
// the card at once, and no more than there are units.
inline cudaError_t resident_grid(const void* kernel, int threads, int smem, int64_t units,
                                 unsigned* grid) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t slots = (int64_t)sms * per_sm;
  *grid = (unsigned)(units < slots ? units : slots);
  return cudaSuccess;
}

// out[j] = sum over b = 0 .. nblocks-1 of partial[b, j], in b order; slots
// with idx[j] < 0 are padding and get NEG_INF.
__global__ void sum_partials_kernel(const float* __restrict__ partial, int64_t nblocks,
                                    int64_t k, const int32_t* __restrict__ idx,
                                    float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  float acc = 0.0f;
  for (int64_t b = 0; b < nblocks; ++b) acc += partial[b * k + j];
  out[j] = (idx != nullptr && idx[j] < 0) ? kNegInf : acc;
}

}  // namespace
}  // namespace tile
