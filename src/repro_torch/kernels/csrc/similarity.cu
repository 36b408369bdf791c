// Pairwise similarity S[i, j] = metric(<x_i, y_j>), (n, d) x (m, d) -> (n, m), fp32.
//
// Replaces src/repro/kernels/similarity_kernel.py::similarity_pallas, the
// TPU kernel that builds the dense kernel matrix for create_kernel().
//
// What bounds it on the H100: operations.  2*n*m*d fp32 FLOP run on the
// CUDA cores (67 TFLOP/s), not the tensor cores: TF32 keeps a 10-bit
// mantissa and misses the 1e-4 parity bars, so it is not used.  At
// n = m = 50,000, d = 512 that is 2.56e12 FLOP = 38 ms, against 10 GB of
// output written = 3.0 ms at 3.35 TB/s.
//
// Design: the shared 128 x 128 x 8 register-blocked SGEMM tile
// (tile_common.cuh).  The TPU grid carried the K axis in the output block
// across grid steps; GPU blocks run in no order, so the whole K loop runs
// inside the block.  The metric epilogue (cosine shift, euclidean, rbf) is
// applied in registers before the one store of each output element.  Rows
// arrive pre-normalised for cosine, and xx / yy (row sums of squares) are
// computed by the wrapper, as the JAX wrapper does.  Ragged edges are masked
// on load (zeros) and on store; every element offset is 64-bit (n * m
// exceeds INT_MAX at 50k).

#include "tile_common.cuh"

// Everything but the exported launch function sits in tile_common.cuh's
// namespace: no using-directive, which nvcc's host stubs would find ambiguous.
namespace tile {
namespace {

template <int METRIC>
__global__ void __launch_bounds__(THREADS) similarity_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy,
    float* __restrict__ out, int64_t n, int64_t m, int64_t d, float inv2s2) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;  // column group
  const int ty = tid / GROUPS;  // row group
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;
  const int64_t gx = row0 + (tid >> 1);  // the rows this thread loads
  const int64_t gy = col0 + (tid >> 1);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  mainloop(x + gx * d, gx < n, y + gy * d, gy < m, d, As, Bs, acc);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t r = row0 + tile_pos(ty, i);
    if (r >= n) continue;
    const float xr = (METRIC >= kEuclidean) ? xx[r] : 0.0f;
    float* orow = out + r * m;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = col0 + tile_pos(tx, j);
      if (c >= m) continue;
      const float yc = (METRIC >= kEuclidean) ? yy[c] : 0.0f;
      orow[c] = epilogue<METRIC>(acc[i][j], xr, yc, inv2s2);
    }
  }
}

int launch_similarity(const float* x, const float* y, const float* xx, const float* yy,
                      float* out, int64_t n, int64_t m, int64_t d, int metric, float inv2s2,
                      cudaStream_t s) {
  const dim3 grid((unsigned)((m + BN - 1) / BN), (unsigned)((n + BM - 1) / BM));
  switch (metric) {
    case kDot:
      similarity_kernel<kDot><<<grid, THREADS, 0, s>>>(x, y, xx, yy, out, n, m, d, inv2s2);
      break;
    case kCosine:
      similarity_kernel<kCosine><<<grid, THREADS, 0, s>>>(x, y, xx, yy, out, n, m, d, inv2s2);
      break;
    case kEuclidean:
      similarity_kernel<kEuclidean><<<grid, THREADS, 0, s>>>(x, y, xx, yy, out, n, m, d, inv2s2);
      break;
    case kRbf:
      similarity_kernel<kRbf><<<grid, THREADS, 0, s>>>(x, y, xx, yy, out, n, m, d, inv2s2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tile

// x (n, d), y (m, d) row-major fp32; xx (n,), yy (m,) row sums of squares
// (read only for euclidean / rbf); out (n, m) row-major.  metric: 0 dot,
// 1 cosine (rows pre-normalised), 2 euclidean, 3 rbf.  Returns
// cudaGetLastError() after the launch.
extern "C" int similarity_launch(const float* x, const float* y, const float* xx,
                                 const float* yy, float* out, int64_t n, int64_t m,
                                 int64_t d, int metric, float inv2s2, void* stream) {
  return tile::launch_similarity(x, y, xx, yy, out, n, m, d, metric, inv2s2,
                                 static_cast<cudaStream_t>(stream));
}
