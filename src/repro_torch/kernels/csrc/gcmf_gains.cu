// Matrix-free graph-cut gain sweep (stateless, from the selection mask):
//   out_r = total_g - lam * (2 * selsum_r + diag_g),
//   selsum_r = sum_{c: m_c != 0} metric(y_g, y_c) * m_c,   g = the candidate of slot r
// with the (j, |A|) similarity computed block by block in registers and
// never written.
//
// Replaces src/repro/kernels/gcmf_gains.py::gcmf_gains_pallas (the full
// sweep, g = r) and ::gcmf_gains_at_pallas (the gathered sweep, g = idx[r]).
//
// What bounds it on the H100: operations over the selected columns only,
// 2 j |A| d fp32 FLOP on the CUDA cores (67 TFLOP/s; TF32 would miss the
// 2e-5 bars): at j = n = 50,000, |A| = 100, d = 512, 5.1 GFLOP = 0.076 ms,
// against 102 MB of features read.  A sweep over every column would do n / |A|
// times that work.
//
// Design: the selected columns arrive compacted (select_cols.cu: the
// ascending list sel of the c with m_c != 0 and its count nsel, on the
// device); two passes, no atomics.
//   pass 1: the shared 128 x 128 x 8 SGEMM tile (tile_common.cuh), rows =
//           candidates y_g, columns = compacted positions p < nsel, whose
//           ground rows y_{sel[p]} the loader gathers.  The grid's x axis
//           is sized on the host for the most column blocks (every column
//           selected); a block walks the column blocks blockIdx.x,
//           blockIdx.x + gridDim.x, ... below ceil(nsel / 128) and leaves
//           when there are none.  The metric epilogue and s * m_c run in
//           registers; positions >= nsel add nothing.  The tile's 128
//           positions are summed in a fixed order: each thread adds its 8
//           in slot order, then one thread per row adds the 16 column
//           groups' sums in group order through shared memory, into
//           partial[column block, r].
//   pass 2: one thread adds the partials of its row in column-block order
//           (ceil(nsel / 128) of them, read on the device) and finishes
//           total - lam * (2 * selsum + diag) with _rn intrinsics, so no
//           fma contraction rounds differently from the plain version.
// lam is read from device memory: the caller passes the pointer of a 0-d
// tensor on the card, so a greedy step never waits on the host for it.
// A row's arithmetic depends on d, the mask and its own candidate alone,
// never on j, gridDim.x or its position: the gathered sweep (candidate
// rows, total and diag read through idx; idx < 0 slots return NEG_INF) is
// bit-identical to the full sweep at the same index for any k.  The
// launcher (kernels/gcmf_gains.py) caps the partial scratch at a fixed size
// by running a long sweep as candidate slices, which changes no row's sum.
// Every element offset is 64-bit.

#include "tile_common.cuh"

// Everything but the exported launch function sits in tile_common.cuh's
// namespace: no using-directive, which nvcc's host stubs would find ambiguous.
namespace tile {
namespace {

constexpr int64_t kTargetBlocks = 1024;  // pass 1's grid: enough blocks to fill the card

template <int METRIC>
__global__ void __launch_bounds__(THREADS) gcmf_partial_kernel(
    const float* __restrict__ y, const float* __restrict__ yy, const float* __restrict__ m,
    const int32_t* __restrict__ sel, const int32_t* __restrict__ nsel,
    const int32_t* __restrict__ idx, int64_t n, int64_t j, int64_t d, float inv2s2,
    float* __restrict__ partial) {
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[GROUPS][BM];

  const int tid = threadIdx.x;
  const int tx = tid % GROUPS;  // column group
  const int ty = tid / GROUPS;  // row group
  const int64_t k = *nsel;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t ar = row0 + (tid >> 1);  // the candidate row this thread loads
  const float* a_row = y + (ar < j ? gathered(idx, ar, n) : 0) * d;

  for (int64_t col0 = (int64_t)blockIdx.x * BN; col0 < k; col0 += (int64_t)gridDim.x * BN) {
    const int64_t bp = col0 + (tid >> 1);  // the compacted position this thread loads
    const bool b_ok = bp < k;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0f;
    mainloop(a_row, ar < j, y + (b_ok ? (int64_t)sel[bp] : 0) * d, b_ok, d, As, Bs, acc);

    float ycol[8], mcol[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int64_t p = col0 + tile_pos(tx, jj);
      const int64_t c = p < k ? (int64_t)sel[p] : 0;
      ycol[jj] = (METRIC >= kEuclidean && p < k) ? yy[c] : 0.0f;
      mcol[jj] = p < k ? m[c] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t r = row0 + tile_pos(ty, i);
      const float xr = (METRIC >= kEuclidean && r < j) ? yy[gathered(idx, r, n)] : 0.0f;
      float rowsum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        if (col0 + tile_pos(tx, jj) >= k) continue;  // a position past nsel adds exactly nothing
        const float s = epilogue<METRIC>(acc[i][jj], xr, ycol[jj], inv2s2);
        rowsum = __fadd_rn(rowsum, __fmul_rn(s, mcol[jj]));
      }
      red[tx][tile_pos(ty, i)] = rowsum;
    }
    __syncthreads();
    if (tid < BM) {
      const int64_t r = row0 + tid;
      if (r < j) {
        float sum = 0.0f;
#pragma unroll
        for (int t = 0; t < GROUPS; ++t) sum += red[t][tid];
        partial[(col0 / BN) * j + r] = sum;
      }
    }
    __syncthreads();  // red and the tiles serve the next column block
  }
}

__global__ void gcmf_finish_kernel(const float* __restrict__ partial,
                                   const int32_t* __restrict__ nsel, int64_t j, int64_t n,
                                   const int32_t* __restrict__ idx,
                                   const float* __restrict__ total,
                                   const float* __restrict__ diag,
                                   const float* __restrict__ lam, float* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= j) return;
  const int64_t nblocks = ((int64_t)*nsel + BN - 1) / BN;
  float selsum = 0.0f;
  for (int64_t b = 0; b < nblocks; ++b) selsum += partial[b * j + r];
  const int64_t g = gathered(idx, r, n);
  const float t = __fadd_rn(__fmul_rn(2.0f, selsum), diag[g]);
  const float gain = __fsub_rn(total[g], __fmul_rn(*lam, t));
  out[r] = (idx != nullptr && idx[r] < 0) ? kNegInf : gain;
}

template <int METRIC>
void launch_partial(dim3 grid, cudaStream_t s, const float* y, const float* yy,
                    const float* m, const int32_t* sel, const int32_t* nsel,
                    const int32_t* idx, int64_t n, int64_t j, int64_t d, float inv2s2,
                    float* partial) {
  gcmf_partial_kernel<METRIC><<<grid, THREADS, 0, s>>>(y, yy, m, sel, nsel, idx, n, j, d, inv2s2,
                                                       partial);
}

int launch_gcmf(const float* y, const float* yy, const float* m, const int32_t* sel,
                const int32_t* nsel, const float* total, const float* diag, const float* lam,
                const int32_t* idx, int64_t n, int64_t j, int64_t d, int metric, float inv2s2,
                float* partial, float* out, cudaStream_t s) {
  if (j <= 0 || n <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int64_t rblocks = (j + BM - 1) / BM;
  if (rblocks > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  const int64_t most = (n + BN - 1) / BN;  // column blocks when every column is selected
  int64_t cblocks = kTargetBlocks / rblocks;
  cblocks = cblocks < 1 ? 1 : (cblocks > most ? most : cblocks);
  const dim3 grid((unsigned)cblocks, (unsigned)rblocks);
  switch (metric) {
    case kDot:
      launch_partial<kDot>(grid, s, y, yy, m, sel, nsel, idx, n, j, d, inv2s2, partial);
      break;
    case kCosine:
      launch_partial<kCosine>(grid, s, y, yy, m, sel, nsel, idx, n, j, d, inv2s2, partial);
      break;
    case kEuclidean:
      launch_partial<kEuclidean>(grid, s, y, yy, m, sel, nsel, idx, n, j, d, inv2s2, partial);
      break;
    case kRbf:
      launch_partial<kRbf>(grid, s, y, yy, m, sel, nsel, idx, n, j, d, inv2s2, partial);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gcmf_finish_kernel<<<(unsigned)((j + 255) / 256), 256, 0, s>>>(partial, nsel, j, n, idx, total,
                                                                  diag, lam, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tile

// y (n, d) row-major fp32 ground features; yy (n,) row sums of squares
// (read only for euclidean / rbf); m (n,) selection mask; sel / nsel the
// compacted columns m_c != 0 and their count (select_cols_launch, pred 1);
// total, diag (n,); lam a device pointer to one float; idx (j,) int32 or
// null for the full sweep (then j == n); partial (ceil(n / 128), j)
// scratch and out (j,) allocated by the caller.  metric: 0 dot, 1 cosine
// (rows pre-normalised), 2 euclidean, 3 rbf.  Returns cudaGetLastError().
extern "C" int gcmf_gains_launch(const float* y, const float* yy, const float* m,
                                 const int32_t* sel, const int32_t* nsel, const float* total,
                                 const float* diag, const float* lam, const int32_t* idx,
                                 int64_t n, int64_t j, int64_t d, int metric, float inv2s2,
                                 float* partial, float* out, void* stream) {
  return tile::launch_gcmf(y, yy, m, sel, nsel, total, diag, lam, idx, n, j, d, metric, inv2s2,
                           partial, out, static_cast<cudaStream_t>(stream));
}
