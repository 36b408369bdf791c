// Dense graph-cut gain sweep (stateless, from the selection mask):
//   out_r = total_g - lam * sum_k S[g, k] * (2 * m_k + [g == k]),
//   g = r (the full sweep) or clip(idx[r]) (the gathered sweep)
// over a materialised (n, n) ground kernel S, computed as
//   out_r = total_g - lam * (sum_{c: m_c != 0} S[g, c] * 2 m_c + S_gg),
// the sum over the selected columns first, then the diagonal once, from the
// row's global id (for g in A: 2 S_gg + S_gg, as the TPU kernel's weight
// 2 m_k + [g == k] gives).
//
// Replaces src/repro/kernels/gc_gains.py::gc_gains_pallas (NaiveGreedy's
// every step on GraphCut with the kernel backend) and ::gc_gains_at_pallas
// (every LazyGreedy level).
//
// What bounds it on the H100: bytes, over the |A| selected columns alone:
// a gathered 4-byte element costs a whole 32-byte sector, so the floor of
// the full sweep is 32 n |A| bytes (0.048 ms at n = 50,000, |A| = 100),
// against 10 GB (2.985 ms at 3.35 TB/s) for a stream of every column.  A
// gathered sweep of k rows reads 32 k |A| bytes, bound by latency.
//
// Design: the launcher compacts the selected columns on the device first
// (select_cols.cu: the ascending list sel of the c with m_c != 0 and its
// count nsel; no host read), and row_reduce.cuh's selected-columns warp
// layout sums each row over them in its fixed order, set by nsel and the
// list alone: lane l adds t = l, l + 32, ..., then the in-warp halving
// tree; lane 0 adds S_gg and finishes total - lam * acc.  There is one path
// for every |A|: a sum has an order, so a stream branch, as dmin's, would
// change the bits.  Every product and sum goes through _rn intrinsics, so
// no fma contraction rounds differently from the plain version
// (kernels/gc_gains.py), which repeats the order and so equals the kernel
// bit for bit.  The gathered sweep reads
// the rows idx through the same code with their global ids, so it equals
// the full sweep bit for bit at the same index; idx < 0 slots return
// NEG_INF, and idx >= n reads row n - 1 as the JAX gather clips.  lam is
// read from device memory, so a greedy step never waits on the host.  Every
// element offset is 64-bit.

#include "row_reduce.cuh"

namespace rowred {
namespace {

// gc's terms S[g, c] * 2 m_c, then total_g - lam * (sum + S_gg)
struct GcOp {
  const float* sim;
  int64_t n;
  const float* total;
  const float* lam;
  __device__ __forceinline__ float weight(float m) const { return __fmul_rn(2.0f, m); }
  __device__ __forceinline__ float finish(float acc, int64_t g) const {
    return __fsub_rn(total[g], __fmul_rn(*lam, __fadd_rn(acc, sim[g * n + g])));
  }
};

}  // namespace
}  // namespace rowred

// sim (n, n) row-major fp32; m (n,) selection mask; sel (n,) and blk
// (ceil(n / SELECT_CHUNK) + 1,) int32 scratch for the compaction of the
// columns m_c != 0, which this launcher runs first; total (n,); lam a
// device pointer to one float; idx (k,) int32 or null for the full sweep
// (then k == n); out (k,).  All allocated by the caller.  Returns the first
// CUDA error code, or 0.
extern "C" int gc_gains_launch(const float* sim, int64_t n, const float* m, int32_t* sel,
                               int32_t* blk, const float* total, const float* lam,
                               const int32_t* idx, int64_t k, float* out, void* stream) {
  return rowred::launch_sel_rows(sim, n, m, sel, blk, idx, k, rowred::GcOp{sim, n, total, lam},
                                 out, static_cast<cudaStream_t>(stream));
}
