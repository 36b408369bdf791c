// On-device mask compaction: the ascending int32 list of the columns c
// whose mask value m_c is picked (m_c > 0 for DisparityMin's min, m_c != 0
// for GraphCutMF's masked sum), and their count, both left in device
// memory.  The sweeps that read only the selected columns (disp_gains.cu's
// dmin, gcmf_gains.cu) take the list and the count from here, so a greedy
// step still never waits on the host: no .item(), no torch.nonzero.
//
// It replaces no TPU kernel: the Pallas sweeps read every column and drop
// the unselected ones, which is what a row stream does; on the H100 the
// sweeps that need only |A| columns gather them instead.
//
// What bounds it: bytes, 4 n read and at most 4 n written (n = 2^20: 8 MB,
// 2.5 us at 3.35 TB/s); in practice its two launches.
//
// Design: a two-level scan, integer sums only, no atomics, so the list and
// its order are the same on every run.  The mask is cut into chunks of
// SELECT_CHUNK elements, one block each; thread t owns PER consecutive
// elements of its chunk, so a block's threads hold the chunk in order.
//   pass 1: each block counts its picked elements into blk[b];
//   pass 2: each block adds blk[0 .. b) (its offset), scans its threads'
//           counts (warp shuffles, then the warp totals), and writes each
//           picked column at offset + its rank; the last block writes the
//           total count to blk[nblocks].
// Pass 2 reads O(nblocks) per block: 256 blocks of 4096 at n = 2^20.
// The Python side (kernels/select_cols.py) allocates sel (n,) and blk
// (nblocks + 1,) and sets SELECT_CHUNK (kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef SELECT_CHUNK
#error "SELECT_CHUNK is set by kernels/_build.py from kernels/select_cols.py"
#endif

namespace selcols {
namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = SELECT_CHUNK;  // mask elements per block
constexpr int PER = CHUNK / THREADS;  // consecutive elements per thread
static_assert(CHUNK % THREADS == 0 && PER <= 32, "a chunk is whole threads of <= 32 elements");

enum Pred { kPositive = 0, kNonzero = 1 };

// Bit i set where element base + threadIdx.x * PER + i is picked.
__device__ __forceinline__ uint32_t picked_bits(const float* __restrict__ m, int64_t n,
                                                int64_t base, int pred) {
  uint32_t bits = 0;
  const int64_t c0 = base + (int64_t)threadIdx.x * PER;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int64_t c = c0 + i;
    if (c < n) {
      const float v = __ldg(m + c);
      if (pred == kPositive ? v > 0.0f : v != 0.0f) bits |= 1u << i;
    }
  }
  return bits;
}

// Exclusive prefix of v over the block's threads in thread order; the
// block's total lands in *total.  Every thread calls it.
__device__ __forceinline__ int64_t block_scan(int64_t v, int64_t* total) {
  __shared__ int64_t warp_sum[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // warp_sum may still be read by an earlier call
  int64_t x = v;
#pragma unroll
  for (int h = 1; h < 32; h <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, x, h);
    if (lane >= h) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int64_t s = lane < WARPS ? warp_sum[lane] : 0;
#pragma unroll
    for (int h = 1; h < 32; h <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, s, h);
      if (lane >= h) s += y;
    }
    if (lane < WARPS) warp_sum[lane] = s;
  }
  __syncthreads();
  *total = warp_sum[WARPS - 1];
  return x - v + (warp > 0 ? warp_sum[warp - 1] : 0);
}

__global__ void __launch_bounds__(THREADS)
    count_kernel(const float* __restrict__ m, int64_t n, int pred, int32_t* __restrict__ blk) {
  const uint32_t bits = picked_bits(m, n, (int64_t)blockIdx.x * CHUNK, pred);
  int64_t total;
  block_scan(__popc(bits), &total);
  if (threadIdx.x == 0) blk[blockIdx.x] = (int32_t)total;
}

__global__ void __launch_bounds__(THREADS)
    scatter_kernel(const float* __restrict__ m, int64_t n, int pred, int32_t* __restrict__ sel,
                   int32_t* __restrict__ blk) {
  const int64_t b = blockIdx.x;
  int64_t before = 0;
  for (int64_t i = threadIdx.x; i < b; i += THREADS) before += blk[i];
  int64_t offset;
  block_scan(before, &offset);  // offset = blk[0] + ... + blk[b - 1]
  const int64_t base = b * CHUNK;
  uint32_t bits = picked_bits(m, n, base, pred);
  int64_t mine;
  int64_t rank = offset + block_scan(__popc(bits), &mine);
  const int64_t c0 = base + (int64_t)threadIdx.x * PER;
  while (bits) {
    const int i = __ffs(bits) - 1;
    sel[rank++] = (int32_t)(c0 + i);
    bits &= bits - 1;
  }
  if (b == gridDim.x - 1 && threadIdx.x == 0) blk[gridDim.x] = (int32_t)(offset + mine);
}

}  // namespace
}  // namespace selcols

// m (n,) fp32 mask; pred 0: m_c > 0, 1: m_c != 0; sel (n,) int32 and blk
// (ceil(n / SELECT_CHUNK) + 1,) int32 allocated by the caller.  On return
// (in stream order) sel[0 .. count) holds the picked columns in ascending
// order and blk[ceil(n / SELECT_CHUNK)] holds count.  n is at most
// INT32_MAX.  Returns cudaGetLastError().
extern "C" int select_cols_launch(const float* m, int64_t n, int pred, int32_t* sel, int32_t* blk,
                                  void* stream) {
  if (n <= 0 || n > INT32_MAX || (pred != selcols::kPositive && pred != selcols::kNonzero))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nblocks = (n + selcols::CHUNK - 1) / selcols::CHUNK;
  selcols::count_kernel<<<(unsigned)nblocks, selcols::THREADS, 0, s>>>(m, n, pred, blk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  selcols::scatter_kernel<<<(unsigned)nblocks, selcols::THREADS, 0, s>>>(m, n, pred, sel, blk);
  return (int)cudaGetLastError();
}
