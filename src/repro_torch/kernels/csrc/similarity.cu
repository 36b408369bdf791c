// Pairwise similarity S[i, j] = metric(<x_i, y_j>), (n, d) x (m, d) -> (n, m), fp32.
//
// Replaces src/repro/kernels/similarity_kernel.py:73 similarity_pallas (its
// pl.pallas_call at :100), the TPU kernel that builds the dense kernel
// matrix for create_kernel(): dot / cosine / euclidean / rbf.
//
// What bounds it on the H100: operations.  2*n*m*d fp32 FLOP run on the
// CUDA cores (67 TFLOP/s), not the tensor cores: TF32 keeps a 10-bit
// mantissa and misses the 1e-4 parity bars, and 3xTF32 would change the
// bits of every element, so neither is used.  At n = m = 50,000, d = 512
// that is 2.56e12 FLOP = 38.21 ms, against 10 GB of output written = 3.0 ms
// at 3.35 TB/s.
//
// Design: the 128 x 128 tile on the pipelined mainloop of sgemm_pipe.cuh
// (cp.async copies of 32-k strips into a ring, up to three strips ahead, one
// barrier per strip, conflict-free shared memory), so the CUDA cores do not
// wait on device memory or on barriers as they did on the 8-k strips of
// tile::mainloop.  Each element is the same fmaf chain over k = 0 .. d-1
// as before, so the output is the same bits.  The TPU grid carried the K
// axis in the output block across grid steps; GPU blocks run in no order,
// so the whole K loop runs inside the block.  The blocks are persistent,
// one per SM, each walking its share of the tiles with one stream of strips
// through its ring (pipe::tile_loop), so a tile's first copies are in flight
// while the previous tile stores its output.  The tiles go in groups of 16
// row tiles (pipe::grouped): the tiles in work at once share a few y tiles
// in the 50 MB L2, where a row-by-row order would stream all of y (102 MB at
// 50,000 x 512) from device memory once per row tile.  The
// metric epilogue (cosine shift, euclidean, rbf) runs in registers before
// the one store of each element, a float4 streaming store (st.global.cs:
// the 10 GB are not read again soon) where m % 4 == 0.  Rows arrive
// pre-normalised for cosine, and xx / yy (row sums of squares) are computed
// by the wrapper, as the JAX wrapper does.  Ragged edges are masked on load
// (zeros) and on store; every element offset is 64-bit.

#include "sgemm_pipe.cuh"

// Everything but the exported functions sits in tile_common.cuh's namespace:
// no using-directive, which nvcc's host stubs would find ambiguous.
namespace tile {
namespace {

template <int METRIC, bool VEC, bool TAIL>
__global__ void __launch_bounds__(THREADS, pipe::MIN_BLOCKS) similarity_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy,
    float* __restrict__ out, int64_t n, int64_t m, int64_t d, float inv2s2, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;  // column group
  const int ty = tid / GROUPS;  // row group
  const int64_t nbx = (m + BN - 1) / BN, nby = (n + BM - 1) / BM;

  const auto rows = [&](int64_t tile, const float*& a_row, bool& a_ok, const float*& b_row,
                        bool& b_ok) {
    int64_t row0, col0;
    pipe::tile_origin(tile, nbx, nby, row0, col0);
    const int64_t gx = row0 + (tid >> 1);  // the rows this thread loads
    const int64_t gy = col0 + (tid >> 1);
    a_ok = gx < n;
    b_ok = gy < m;
    a_row = x + (a_ok ? gx : 0) * d;
    b_row = y + (b_ok ? gy : 0) * d;
  };
  const auto done = [&](int64_t tile, float (&acc)[8][8]) {
    int64_t row0, col0;
    pipe::tile_origin(tile, nbx, nby, row0, col0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t r = row0 + tile_pos(ty, i);
      if (r >= n) continue;
      const float xr = (METRIC >= kEuclidean) ? xx[r] : 0.0f;
      float* orow = out + r * m;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // columns tile_pos(tx, 4h) .. tile_pos(tx, 4h + 3)
        const int64_t c = col0 + tile_pos(tx, 4 * h);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float yc = (METRIC >= kEuclidean && c + e < m) ? yy[c + e] : 0.0f;
          v[e] = epilogue<METRIC>(acc[i][4 * h + e], xr, yc, inv2s2);
        }
        if (vec_out && c < m) {  // m % 4 == 0: c + 3 < m
          __stcs(reinterpret_cast<float4*>(orow + c), make_float4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c + e < m) __stcs(orow + c + e, v[e]);
        }
      }
    }
  };
  pipe::tile_loop<float, float, VEC, TAIL>(nbx * nby, d, smem, rows, done);
}

using SimilarityKernel = void (*)(const float*, const float*, const float*, const float*, float*,
                                  int64_t, int64_t, int64_t, float, int);

template <bool VEC, bool TAIL>
SimilarityKernel kernel_for(int metric) {
  switch (metric) {
    case kDot: return similarity_kernel<kDot, VEC, TAIL>;
    case kCosine: return similarity_kernel<kCosine, VEC, TAIL>;
    case kEuclidean: return similarity_kernel<kEuclidean, VEC, TAIL>;
    case kRbf: return similarity_kernel<kRbf, VEC, TAIL>;
    default: return nullptr;
  }
}

SimilarityKernel kernel_for(int metric, int vec, int tail, int* smem) {
  *smem = vec ? pipe::smem_bytes<float, float, true>() : pipe::smem_bytes<float, float, false>();
  if (vec) return tail ? kernel_for<true, true>(metric) : kernel_for<true, false>(metric);
  return tail ? kernel_for<false, true>(metric) : kernel_for<false, false>(metric);
}

int launch_similarity(const float* x, const float* y, const float* xx, const float* yy,
                      float* out, int64_t n, int64_t m, int64_t d, int metric, float inv2s2,
                      cudaStream_t s) {
  if (d > pipe::MAX_D) return (int)cudaErrorInvalidValue;
  const int vec = pipe::aligned_rows(x, d, 4) && pipe::aligned_rows(y, d, 4);
  int smem;
  const SimilarityKernel kernel = kernel_for(metric, vec, d % pipe::BK != 0, &smem);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = pipe::allow_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec_out = (m % 4 == 0) && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  unsigned grid;
  err = pipe::persistent_grid((const void*)kernel, smem, ((m + BN - 1) / BN) * ((n + BM - 1) / BM),
                              &grid);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, THREADS, smem, s>>>(x, y, xx, yy, out, n, m, d, inv2s2, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tile

// x (n, d), y (m, d) row-major fp32; xx (n,), yy (m,) row sums of squares
// (read only for euclidean / rbf); out (n, m) row-major.  metric: 0 dot,
// 1 cosine (rows pre-normalised), 2 euclidean, 3 rbf.  Rows that all start
// 16-byte aligned take the 16-byte copy path, others the element-wise one,
// with the same bits.  Returns cudaGetLastError() after the launch.
extern "C" int similarity_launch(const float* x, const float* y, const float* xx,
                                 const float* yy, float* out, int64_t n, int64_t m,
                                 int64_t d, int metric, float inv2s2, void* stream) {
  return tile::launch_similarity(x, y, xx, yy, out, n, m, d, metric, inv2s2,
                                 static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of the kernel that similarity_launch runs for
// `metric` at d % 32 == 0 on its 16-byte copy path (vec = 1) or its
// element-wise one (vec = 0), into *blocks.  Returns a CUDA error code.
extern "C" int similarity_blocks_per_sm(int metric, int vec, int* blocks) {
  int smem;
  const tile::SimilarityKernel kernel = tile::kernel_for(metric, vec, 0, &smem);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)tile::pipe::blocks_per_sm((const void*)kernel, smem, blocks);
}
