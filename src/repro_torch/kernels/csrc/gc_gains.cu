// Dense graph-cut gain sweep (stateless, from the selection mask):
//   out_r = total_g - lam * sum_k S[g, k] * (2 * m_k + [g == k]),
//   g = r (the full sweep) or clip(idx[r]) (the gathered sweep)
// over a materialised (n, n) ground kernel S.  The diagonal S_gg is folded
// in as the stream passes it, from the row's global id, as the TPU kernel
// does.
//
// Replaces src/repro/kernels/gc_gains.py::gc_gains_pallas (NaiveGreedy's
// every step on GraphCut with the kernel backend) and ::gc_gains_at_pallas
// (every LazyGreedy level).
//
// What bounds it on the H100: bytes (row_reduce.cuh): at n = 50,000 the
// full sweep reads the 10 GB of S once, 2.985 ms at 3.35 TB/s.  A gathered
// sweep of k rows reads 4 k n bytes: 1.6 MB at k = 8, bound by latency.
//
// Design: one block reduces one row of S in row_reduce.cuh's fixed
// order (coalesced along the row, halving tree across the block; no
// atomics, one pass), and thread 0 finishes total - lam * acc.  Every
// product and sum goes through _rn intrinsics, so no fma contraction
// rounds differently from the plain version (kernels/gc_gains.py), which
// repeats the order and so equals the kernel bit for bit.  The gathered
// sweep reads the rows idx through the same code with their global ids, so
// it equals the full sweep bit for bit at the same index; idx < 0 slots
// return NEG_INF, and idx >= n reads row n - 1 as the JAX gather clips.
// lam is read from device memory, so a greedy step never waits on the host.

#include "row_reduce.cuh"

namespace rowred {
namespace {

struct GcStep {
  __device__ static float init() { return 0.0f; }
  __device__ static float step(float acc, float s, float m, int64_t k, int64_t g) {
    const float w = __fadd_rn(__fmul_rn(2.0f, m), k == g ? 1.0f : 0.0f);
    return __fadd_rn(acc, __fmul_rn(s, w));
  }
  __device__ static float combine(float a, float b) { return __fadd_rn(a, b); }
};

__global__ void __launch_bounds__(THREADS)
    gc_gains_kernel(const float* __restrict__ sim, int64_t n, const float* __restrict__ m,
                    const float* __restrict__ total, const float* __restrict__ lam,
                    const int32_t* __restrict__ idx, float* __restrict__ out) {
  const int64_t slot = blockIdx.x;
  const int64_t g = idx == nullptr ? slot : tile::gathered(idx, slot, n);
  const float acc = reduce_row<GcStep>(sim, n, m, g);
  if (threadIdx.x == 0) {
    const float gain = __fsub_rn(total[g], __fmul_rn(*lam, acc));
    out[slot] = (idx != nullptr && idx[slot] < 0) ? tile::kNegInf : gain;
  }
}

int launch_gc(const float* sim, int64_t n, const float* m, const float* total,
              const float* lam, const int32_t* idx, int64_t k, float* out, cudaStream_t s) {
  if (k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  gc_gains_kernel<<<(unsigned)k, THREADS, 0, s>>>(sim, n, m, total, lam, idx, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rowred

// sim (n, n) row-major fp32; m (n,) selection mask; total (n,); lam a
// device pointer to one float; idx (k,) int32 or null for the full sweep
// (then k == n); out (k,) allocated by the caller.  Returns
// cudaGetLastError().
extern "C" int gc_gains_launch(const float* sim, int64_t n, const float* m, const float* total,
                               const float* lam, const int32_t* idx, int64_t k, float* out,
                               void* stream) {
  return rowred::launch_gc(sim, n, m, total, lam, idx, k, out,
                           static_cast<cudaStream_t>(stream));
}
