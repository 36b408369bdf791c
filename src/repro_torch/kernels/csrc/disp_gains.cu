// Dense disparity (dispersion) gain sweeps, stateless, from the selection
// mask over a materialised (n, n) distance matrix D:
//   dsum: out_j = sum_k D[j, k] * m_k                      (DisparitySum)
//   dmin: out_j = min(count == 0 ? 0 : surr_j, BIG) - curmin,
//         surr_j = min over k with m_k > 0 of D[j, k], BIG if none
//                                                          (DisparityMin)
//
// Replaces src/repro/kernels/disp_gains.py::dsum_gains_pallas and
// ::dmin_gains_pallas (NaiveGreedy's every step with the kernel backend).
//
// What bounds them on the H100: bytes, over the |A| selected columns alone:
// 4 n |A| bytes, but a gathered 4-byte element costs a whole 32-byte
// sector, so their floor is 32 n |A| bytes (0.239 ms at n = 50,000, |A| =
// 500), against 10 GB (2.985 ms at 3.35 TB/s) for a stream of every
// column, which dmin takes once 8 |A| >= n.
//
// Design.  The selected columns are compacted on the device (select_cols.cu:
// the ascending list sel and its count nsel; no host read): by dsum's
// launcher itself, by dmin's caller.
// dsum: row_reduce.cuh's selected-columns warp layout, its fixed order set
// by nsel and the list alone (lane l adds t = l, l + 32, ..., then the
// in-warp halving tree), one path for every |A|: a sum has an order, so a
// stream branch would change the bits where dmin's changes nothing.
// Products and sums go through _rn intrinsics, so the plain version
// (kernels/disp_gains.py), which repeats the order, equals it bit for bit.
// dmin picks its branch from nsel on the device:
//   gather (8 nsel < n): one warp per row j; lane l takes the min over
//     D[j, sel[t]] for t = l, l + 32, ..., UNROLL loads in flight, then a
//     shuffle tree; sel comes through the read-only cache, one 128-byte
//     line per warp load.
//   stream (8 nsel >= n): row_reduce.cuh's row stream, unselected columns
//     replaced by BIG (MinStep), the block taking its rows in turn.
// The min does not depend on order at all, so both branches give the same
// bits, equal to the plain version's and to the memoized DisparityMin
// path's (min over the selected columns, taken one column per step): all
// take the min of the same elements D[j, k], k in A.  dmin reads |A|
// (count, int32) and f(A) (curmin, fp32) from device memory, so a greedy
// step never waits on the host.  Every element offset is 64-bit.

#include "row_reduce.cuh"

namespace rowred {
namespace {

// dsum's terms D[j, c] * m_c, the selected-columns sum itself the gain
struct DsumOp {
  __device__ __forceinline__ float weight(float m) const { return m; }
  __device__ __forceinline__ float finish(float acc, int64_t) const { return acc; }
};

struct MinStep {
  __device__ static float init() { return kBig; }
  __device__ static float step(float acc, float s, float m) {
    return fminf(acc, m > 0.0f ? s : kBig);  // unselected columns drop out of the min
  }
  __device__ static float combine(float a, float b) { return fminf(a, b); }
};

constexpr int DMIN_ROWS = WARPS;  // rows per block: one warp each in the gather branch

__device__ __forceinline__ float dmin_finish(float surr, bool empty, float curmin) {
  return __fsub_rn(fminf(empty ? 0.0f : surr, kBig), curmin);
}

__global__ void __launch_bounds__(THREADS)
    dmin_gains_kernel(const float* __restrict__ dist, int64_t n, const float* __restrict__ m,
                      const int32_t* __restrict__ sel, const int32_t* __restrict__ nsel,
                      const int32_t* __restrict__ count, const float* __restrict__ curmin,
                      float* __restrict__ out) {
  const int64_t r0 = (int64_t)blockIdx.x * DMIN_ROWS;
  const int64_t k = *nsel;
  const bool empty = *count == 0;
  const float cm = *curmin;
  if (8 * k < n) {  // gather the k selected columns
    const int lane = threadIdx.x & 31;
    const int64_t g = r0 + (threadIdx.x >> 5);
    if (g >= n) return;  // the whole warp leaves together; no block barrier follows
    const float* row = dist + g * n;
    float acc = kBig;
    for (int64_t base = 0; base < k; base += 32 * UNROLL) {
      int64_t c[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t t = base + u * 32 + lane;
        c[u] = t < k ? (int64_t)__ldg(sel + t) : -1;
      }
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = c[u] >= 0 ? __ldcs(row + c[u]) : kBig;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) acc = fminf(acc, v[u]);
    }
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) acc = fminf(acc, __shfl_down_sync(0xffffffffu, acc, h));
    if (lane == 0) out[g] = dmin_finish(acc, empty, cm);
  } else {  // stream every column of the block's rows
    for (int r = 0; r < DMIN_ROWS; ++r) {
      const int64_t g = r0 + r;
      if (g >= n) break;  // the same for every thread of the block
      const float acc = reduce_row<MinStep>(dist, n, m, g);
      if (threadIdx.x == 0) out[g] = dmin_finish(acc, empty, cm);
      __syncthreads();  // reduce_row's shared partials serve the next row
    }
  }
}

int launch_dmin(const float* dist, int64_t n, const float* m, const int32_t* sel,
                const int32_t* nsel, const int32_t* count, const float* curmin, float* out,
                cudaStream_t s) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + DMIN_ROWS - 1) / DMIN_ROWS;
  dmin_gains_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(dist, n, m, sel, nsel, count, curmin,
                                                         out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rowred

// dist (n, n) row-major fp32; m (n,) selection mask; sel (n,) and blk
// (ceil(n / SELECT_CHUNK) + 1,) int32 scratch for the compaction of the
// columns m_c != 0, which this launcher runs first; out (n,).  All allocated
// by the caller.  Returns the first CUDA error code, or 0.
extern "C" int dsum_gains_launch(const float* dist, int64_t n, const float* m, int32_t* sel,
                                 int32_t* blk, float* out, void* stream) {
  return rowred::launch_sel_rows(dist, n, m, sel, blk, nullptr, n, rowred::DsumOp{}, out,
                                 static_cast<cudaStream_t>(stream));
}

// As dsum_gains_launch, with sel / nsel the compacted columns m_c > 0
// (select_cols_launch, pred 0), count a device pointer to |A| (int32) and
// curmin a device pointer to f(A) (fp32).
extern "C" int dmin_gains_launch(const float* dist, int64_t n, const float* m,
                                 const int32_t* sel, const int32_t* nsel, const int32_t* count,
                                 const float* curmin, float* out, void* stream) {
  return rowred::launch_dmin(dist, n, m, sel, nsel, count, curmin, out,
                             static_cast<cudaStream_t>(stream));
}
