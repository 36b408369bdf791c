// Set-cover family gain sweeps over an (n, m) concept matrix:
//   sc:  out_j = sum_u w_u * max(G[j, u] - covered_u, 0)   (SetCover)
//   psc: out_j = sum_u wm_u * P[j, u],  wm = w * miss      (ProbabilisticSetCover)
// with G the incidence matrix, covered (m,) the memoized covered indicator,
// P the membership probabilities and miss (m,) the memoized miss
// probability prod_{i in A} (1 - p_iu).
//
// Replaces src/repro/kernels/sc_gains.py::sc_gains_pallas and
// ::psc_gains_pallas (NaiveGreedy's every step, and LazyGreedy's initial
// bounds, with the kernel backend; the lazy levels take the families'
// gathered torch path, as in the JAX package).
//
// What bounds them on the H100: bytes.  Each reads its matrix once: at
// n = 2^20, m = 1,000 that is 4.19 GB, 1.252 ms at 3.35 TB/s, against
// 3 (sc) or 2 (psc) fp32 operations per element, 0.1 ms at 67 TFLOP/s.
//
// Design, sc: row_reduce.cuh's vector warp layout (4-element chunks along
// the row, one 16-byte load of G per lane and chunk where the rows and the
// per-concept vectors are 16-byte aligned, covered and w read as one float4
// each per chunk for the 4 rows a warp keeps in flight, persistent blocks;
// no atomics, one pass): a quarter of the loads per element of G that the
// warp layout issues, and more bytes in flight, for a sweep whose only limit
// is the bytes of G.  psc: the warp layout (one warp per
// row, lanes strided along the row, an in-warp halving tree), with w * miss
// formed once by the wrapper (the JAX kernel forms it outside its tile
// loop), so its inner step is one product and one add.  Products and sums
// go through _rn intrinsics, so no fma contraction rounds differently from
// the plain versions (kernels/sc_gains.py), which repeat each layout's
// order.  With a binary cover, a binary covered and unit weights every sc
// term is 0 or 1, so any order gives the same integer: the sweep then
// equals SetCover's torch path exactly.

#include "row_reduce.cuh"

namespace rowred {
namespace {

struct ScTerm {
  const float* covered;  // (m,) covered indicator
  const float* w;        // (m,) concept weights
  struct Cols {
    float4 covered, w;
  };
  // the per-concept operands of chunk c (concepts 4c .. 4c + 3)
  template <bool VEC>
  __device__ __forceinline__ Cols cols(int64_t c, int64_t m) const {
    return {load_chunk<VEC, false>(covered, c, m), load_chunk<VEC, false>(w, c, m)};
  }
  __device__ __forceinline__ float term(float g, const Cols& p, int e) const {
    return __fmul_rn(fmaxf(__fsub_rn(g, elem(p.covered, e)), 0.0f), elem(p.w, e));
  }
};

struct PscTerm {
  const float* wm;  // (m,) w * miss
  __device__ __forceinline__ float term(float p, int64_t u) const {
    return __fmul_rn(p, __ldg(wm + u));
  }
};

}  // namespace
}  // namespace rowred

// cover (n, m) row-major fp32; covered, w (m,); out (n,) allocated by the
// caller.  With m % 4 == 0 and all three 16-byte aligned the sweep takes the
// 16-byte loads, else element loads, with the same bits.  Returns
// cudaGetLastError().
extern "C" int sc_gains_launch(const float* cover, int64_t n, int64_t m, const float* covered,
                               const float* w, float* out, void* stream) {
  const auto aligned = [](const float* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = m % 4 == 0 && aligned(cover) && aligned(covered) && aligned(w);
  return rowred::launch_warp4_rows(cover, n, m, rowred::ScTerm{covered, w}, vec, out,
                                   static_cast<cudaStream_t>(stream));
}

// probs (n, m) row-major fp32; wm (m,) = w * miss; out (n,) allocated by
// the caller.  Returns cudaGetLastError().
extern "C" int psc_gains_launch(const float* probs, int64_t n, int64_t m, const float* wm,
                                float* out, void* stream) {
  return rowred::launch_warp_rows(probs, n, m, rowred::PscTerm{wm},
                                  static_cast<const int32_t*>(nullptr), n, out,
                                  static_cast<cudaStream_t>(stream));
}
