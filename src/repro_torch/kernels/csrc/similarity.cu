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
// Design: a tiled shared-memory SGEMM with register blocking.  One block of
// 256 threads owns a 128 x 128 output tile; K strips of 8 are staged through
// shared memory transposed (k-major), so each thread reads its 8 + 8 operands
// as four float4s and keeps an 8 x 8 accumulator tile in registers.  The
// TPU grid carried the K axis in the output block across grid steps; GPU
// blocks run in no order, so the whole K loop runs inside the block.  The
// metric epilogue (cosine shift, euclidean, rbf) is applied in registers
// before the one store of each output element.  Rows arrive pre-normalised
// for cosine, and xx / yy (row sums of squares) are computed by the wrapper,
// as the JAX wrapper does.  Ragged edges are masked on load (zeros) and on
// store; every element offset is 64-bit (n * m exceeds INT_MAX at 50k).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output cols per block
constexpr int BK = 8;    // contraction strip staged in shared memory
constexpr int THREADS = 256;

enum Metric { kDot = 0, kCosine = 1, kEuclidean = 2, kRbf = 3 };

template <int METRIC>
__device__ __forceinline__ float epilogue(float acc, float xx, float yy, float inv2s2) {
  if (METRIC == kDot) return acc;
  if (METRIC == kCosine) return 0.5f * (1.0f + acc);
  const float d2 = fmaxf(xx + yy - 2.0f * acc, 0.0f);
  if (METRIC == kEuclidean) return 1.0f / (1.0f + sqrtf(d2));
  return expf(-d2 * inv2s2);
}

// Row (or column) of the 128-wide tile held by register slot i of thread t:
// slots 0..3 sit at t*4 + i, slots 4..7 at 64 + t*4 + (i - 4), so a warp's
// shared-memory float4 reads are contiguous.
__device__ __forceinline__ int tile_pos(int t, int i) {
  return (i < 4) ? t * 4 + i : 64 + t * 4 + (i - 4);
}

template <int METRIC>
__global__ void __launch_bounds__(THREADS) similarity_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ xx, const float* __restrict__ yy,
    float* __restrict__ out, int64_t n, int64_t m, int64_t d, float inv2s2) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group
  const int ty = tid / 16;  // row group
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  // loader: 128 rows x 8 k per operand; thread loads 4 consecutive k of one row
  const int lr = tid >> 1;
  const int lk = (tid & 1) * 4;
  const int64_t gx = row0 + lr;
  const int64_t gy = col0 + lr;
  const float* xrow = x + gx * d;
  const float* yrow = y + gy * d;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int64_t k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t gk = k0 + lk + q;
      As[lk + q][lr] = (gx < n && gk < d) ? __ldg(xrow + gk) : 0.0f;
      Bs[lk + q][lr] = (gy < m && gk < d) ? __ldg(yrow + gk) : 0.0f;
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

}  // namespace

// x (n, d), y (m, d) row-major fp32; xx (n,), yy (m,) row sums of squares
// (read only for euclidean / rbf); out (n, m) row-major.  metric: 0 dot,
// 1 cosine (rows pre-normalised), 2 euclidean, 3 rbf.  Returns
// cudaGetLastError() after the launch.
extern "C" int similarity_launch(const float* x, const float* y, const float* xx,
                                 const float* yy, float* out, int64_t n, int64_t m,
                                 int64_t d, int metric, float inv2s2, void* stream) {
  const dim3 grid((unsigned)((m + BN - 1) / BN), (unsigned)((n + BM - 1) / BM));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
