// Feature-based (concave-over-modular) gain sweep:
//   out_r = sum_f w_f * (g(acc_f + X[g, f]) - g(acc_f)),
//   g = r (the full sweep) or clip(idx[r]) (the gathered sweep)
// over the (n, F) non-negative feature matrix X, with acc (F,) the memoized
// feature mass m_f(A) and g one of sqrt / log1p / inverse on max(v, 0)
// (common.CONCAVE_FNS), a template parameter.
//
// Replaces src/repro/kernels/fb_gains.py::fb_gains_pallas (NaiveGreedy's
// every step on FeatureBased with the kernel backend) and
// ::fb_gains_at_pallas (every LazyGreedy level).
//
// What bounds it on the H100: bytes.  A full sweep reads X once: at
// n = 2^20, F = 512 that is 2.147 GB, 0.641 ms at 3.35 TB/s.  Per element it
// does an add, a concave, a subtract, a multiply and a sum (log1pf some
// twenty operations, sqrt and the division a few): 5.4e8 concaves stay
// under the bytes at 67 TFLOP/s.  A gathered sweep of k rows reads 4 k F
// bytes: 16 KB at k = 8, bound by latency.
//
// Design: a first small kernel forms g(acc_f) once per feature into a
// scratch vector the wrapper allocates; the sweep then sums each row in
// row_reduce.cuh's warp layout (one warp per row, lanes strided along the
// row, an in-warp halving tree; no atomics, one pass), reading acc, g(acc)
// and w through the read-only cache.  Every add, product and division goes
// through _rn intrinsics (sqrt is __fsqrt_rn, log1p CUDA's log1pf), so no
// fma contraction rounds differently from the plain version
// (kernels/fb_gains.py), which repeats the order.  The gathered sweep reads
// the rows idx through the same code, so it equals the full sweep bit for
// bit at the same index; idx < 0 slots return NEG_INF, and idx >= n reads
// row n - 1 as the JAX gather clips.

#include "row_reduce.cuh"

namespace rowred {
namespace {

enum Concave { kSqrt = 0, kLog = 1, kInverse = 2 };  // kernels/fb_gains.py CONCAVE_CODES

template <int C>
__device__ __forceinline__ float concave(float v) {
  const float c = fmaxf(v, 0.0f);
  if (C == kSqrt) return __fsqrt_rn(c);
  if (C == kLog) return log1pf(c);
  return __fdiv_rn(v, __fadd_rn(1.0f, c));  // inverse: v / (1 + max(v, 0))
}

template <int C>
__global__ void fb_base_kernel(const float* __restrict__ acc, int64_t F, float* __restrict__ ga) {
  const int64_t f = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (f < F) ga[f] = concave<C>(acc[f]);
}

template <int C>
struct FbTerm {
  const float* acc;  // (F,) m_f(A)
  const float* ga;   // (F,) g(m_f(A)), formed once by fb_base_kernel
  const float* w;    // (F,) feature weights
  __device__ __forceinline__ float term(float x, int64_t f) const {
    const float gx = concave<C>(__fadd_rn(__ldg(acc + f), x));
    return __fmul_rn(__fsub_rn(gx, __ldg(ga + f)), __ldg(w + f));
  }
};

template <int C>
int launch_fb(const float* x, int64_t n, int64_t F, const float* acc, const float* w,
              const int32_t* idx, int64_t k, float* ga, float* out, cudaStream_t s) {
  if (F <= 0) return (int)cudaErrorInvalidValue;
  fb_base_kernel<C><<<(unsigned)((F + 255) / 256), 256, 0, s>>>(acc, F, ga);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_warp_rows(x, n, F, FbTerm<C>{acc, ga, w}, idx, k, out, s);
}

}  // namespace
}  // namespace rowred

// feats (n, F) row-major fp32; acc, w (F,); concave 0 sqrt, 1 log, 2
// inverse; idx (k,) int32 or null for the full sweep (then k == n); ga (F,)
// scratch and out (k,) allocated by the caller.  Returns cudaGetLastError().
extern "C" int fb_gains_launch(const float* feats, int64_t n, int64_t F, const float* acc,
                               const float* w, int concave, const int32_t* idx, int64_t k,
                               float* ga, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (concave) {
    case rowred::kSqrt:
      return rowred::launch_fb<rowred::kSqrt>(feats, n, F, acc, w, idx, k, ga, out, s);
    case rowred::kLog:
      return rowred::launch_fb<rowred::kLog>(feats, n, F, acc, w, idx, k, ga, out, s);
    case rowred::kInverse:
      return rowred::launch_fb<rowred::kInverse>(feats, n, F, acc, w, idx, k, ga, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
