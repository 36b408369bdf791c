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
// What bounds them on the H100: bytes (row_reduce.cuh): each reads the
// 10 GB of D once at n = 50,000, 2.985 ms at 3.35 TB/s.
//
// Design: row_reduce.cuh's fixed order (one block per row, coalesced
// along the row, a halving tree across the block; no atomics, one pass),
// with _rn intrinsics for dsum's products and sums so that the plain
// version (kernels/disp_gains.py), which repeats the order, equals it bit
// for bit.  The min does not depend on order at all, so dmin equals the
// memoized DisparityMin path (min over the selected columns, taken one
// column per step) bit for bit: both take the min of the same elements
// D[j, k], k in A.  dmin reads |A| (int32) and f(A) (fp32) from device
// memory, so a greedy step never waits on the host.

#include "row_reduce.cuh"

namespace rowred {
namespace {

struct SumStep {
  __device__ static float init() { return 0.0f; }
  __device__ static float step(float acc, float s, float m, int64_t, int64_t) {
    return __fadd_rn(acc, __fmul_rn(s, m));
  }
  __device__ static float combine(float a, float b) { return __fadd_rn(a, b); }
};

struct MinStep {
  __device__ static float init() { return kBig; }
  __device__ static float step(float acc, float s, float m, int64_t, int64_t) {
    return fminf(acc, m > 0.0f ? s : kBig);  // unselected columns drop out of the min
  }
  __device__ static float combine(float a, float b) { return fminf(a, b); }
};

__global__ void __launch_bounds__(THREADS)
    dsum_gains_kernel(const float* __restrict__ dist, int64_t n, const float* __restrict__ m,
                      float* __restrict__ out) {
  const int64_t g = blockIdx.x;
  const float acc = reduce_row<SumStep>(dist, n, m, g);
  if (threadIdx.x == 0) out[g] = acc;
}

__global__ void __launch_bounds__(THREADS)
    dmin_gains_kernel(const float* __restrict__ dist, int64_t n, const float* __restrict__ m,
                      const int32_t* __restrict__ count, const float* __restrict__ curmin,
                      float* __restrict__ out) {
  const int64_t g = blockIdx.x;
  const float acc = reduce_row<MinStep>(dist, n, m, g);
  if (threadIdx.x == 0) out[g] = __fsub_rn(fminf(*count == 0 ? 0.0f : acc, kBig), *curmin);
}

int launch_dsum(const float* dist, int64_t n, const float* m, float* out, cudaStream_t s) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  dsum_gains_kernel<<<(unsigned)n, THREADS, 0, s>>>(dist, n, m, out);
  return (int)cudaGetLastError();
}

int launch_dmin(const float* dist, int64_t n, const float* m, const int32_t* count,
                const float* curmin, float* out, cudaStream_t s) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  dmin_gains_kernel<<<(unsigned)n, THREADS, 0, s>>>(dist, n, m, count, curmin, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rowred

// dist (n, n) row-major fp32; m (n,) selection mask; out (n,) allocated by
// the caller.  Returns cudaGetLastError().
extern "C" int dsum_gains_launch(const float* dist, int64_t n, const float* m, float* out,
                                 void* stream) {
  return rowred::launch_dsum(dist, n, m, out, static_cast<cudaStream_t>(stream));
}

// As dsum_gains_launch, with count a device pointer to |A| (int32) and
// curmin a device pointer to f(A) (fp32).
extern "C" int dmin_gains_launch(const float* dist, int64_t n, const float* m,
                                 const int32_t* count, const float* curmin, float* out,
                                 void* stream) {
  return rowred::launch_dmin(dist, n, m, count, curmin, out, static_cast<cudaStream_t>(stream));
}
