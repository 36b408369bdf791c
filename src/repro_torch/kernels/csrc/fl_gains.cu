// Facility-location gain sweeps: out_j = sum_i max(S[i, col_j] - curmax_i, 0).
//
// Replaces src/repro/kernels/fl_gains.py::fl_gains_pallas (the full sweep,
// col_j = j, NaiveGreedy's every step) and ::fl_gains_at_pallas (the
// gathered sweep, col_j = idx[j], every LazyGreedy level).
//
// What bounds it on the H100: bytes.  The full sweep reads S (u, n) once
// and does 3 fp32 operations per element: at u = n = 50,000 that is 10 GB
// at 3.35 TB/s = 3.0 ms, while the 7.5e9 operations take 0.11 ms at
// 67 TFLOP/s.  The gathered sweep reads one column per slot: each element
// lies a whole row from the next, so a 32-byte sector brings 4 useful
// bytes (12.8 MB of sectors at k = 8, 4 us; a LazyGreedy level's call is
// bound by the host and by memory latency there).
//
// Order: the u rows are cut into fixed chunks of `rows_per_chunk`; a
// column's chunk sum adds its rows in row order from 0.0f, and the column's
// result adds the chunk sums in chunk order from 0.0f.  The order depends
// on u alone, never on n, k, the column's position or the launch's shape:
// that is what makes the gathered sweep bit-identical to the full sweep at
// the same index.  kernels/fl_gains.py::_column_sums repeats it.
//
// The full sweep: two passes, no atomics.  Pass 1: one thread sums one
// column over one chunk into partial[c, j], neighbouring threads on
// neighbouring columns, so a warp reads 128 contiguous bytes of a row and
// the blocks in flight stream whole rows of S; the chunks run along the
// grid's y axis and loop past its 65,535 rows.  Pass 2: one thread adds its
// column's partials in chunk order (tile_common.cuh's sum_partials_kernel).
//
// The gathered sweep: one launch, no scratch.  A thread-block cluster of
// CLUSTER blocks owns G gathered columns; the caller picks G = ceil(k / 8)
// (at most a block's 256 threads), so that eight clusters run at once and
// walk the rows together, window by window: the blocks in flight read a
// band of CLUSTER * L chunks across every gathered column, where more,
// narrower clusters were slower on the card (kernels/fl_gains.py,
// CLUSTERS).  A window holds CLUSTER * L chunks, dealt
// to the cluster's blocks in turn (chunk c to block c % CLUSTER); a block's
// thread t sums one chunk of one column per window: column t % G of its
// slot t / G (so a warp reads neighbouring gathered columns of one row, the
// curmax value one broadcast), BATCH rows' loads in flight before it adds
// them, into the block's shared memory.  After cluster.sync() the folding
// thread of each column (column g: thread g / CLUSTER of block g %
// CLUSTER) reads the window's chunk sums in chunk order through distributed
// shared memory and adds them to its running sum; a second cluster.sync()
// frees the slots for the next window.  So the second pass and its
// (nchunks, k) buffer are gone, and the window loop takes any u.
//
// Wide gathered sweeps (the caller's crossover, kernels/fl_gains.py) run the
// full sweep into the caller's n-long scratch and gather the k slots from
// it in the same call: bit-identical by the order above.
//
// Slots with idx < 0 are padding and return NEG_INF; idx >= n reads column
// n - 1, as the JAX gather clips; duplicates are allowed.  The ids are int32
// or int64 (the LazyGreedy engine's sort hands int64 over).  Every element
// offset is 64-bit: S at 50,000 x 50,000 holds 2.5e9 elements.
//
// Element type: S is fp32 or bf16 (SimT), as the TPU kernel takes either and
// widens each element to fp32 as it loads it; curmax, the sums and the
// output are fp32.  Widening is exact and the order above does not change,
// so a bf16 sweep equals the fp32 sweep of the widened S bit for bit.
//
// Waves: B members of one shape (the batched engine's stacked S, member b at
// sim + b * member_stride, its curmax, ids and output rows likewise) ride one
// launch, the JAX package's vmap of the Pallas sweep.  The full sweep takes
// the members on grid.z (scratch (B, nchunks, n)), the gathered sweep and
// the crossover's gather on grid.y.  A member's sums keep the order above,
// which its own u fixes, so its row of a wave equals its own launch bit for
// bit; zero-padded rows (S = 0, curmax = 0) add +0.0, which changes no sum.
// Each kernel takes WAVE as a template flag: a single sweep (one member)
// runs the WAVE = false instance, whose code has no member offsets (with
// them, the single full sweep at u = n = 50,000 ran 3.6% slower on an
// NVIDIA H100 80GB HBM3 at 700 W: 3.497 against 3.375 ms).

#include <cooperative_groups.h>

#include "tile_common.cuh"

#if !defined(FL_CLUSTER)
#error "FL_CLUSTER is set by kernels/_build.py"
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = FL_CLUSTER;  // blocks per cluster (8: the portable maximum)
constexpr int MAX_THREADS = 256;
constexpr int BATCH = 16;            // rows of a chunk loaded before they are added
constexpr int MAX_GRID_Y = 65535;    // CUDA's grid.y limit: the full sweep loops past it

// The chunk sum of column col over rows r0 .. r0 + len - 1, in row order.
template <typename SimT>
__device__ __forceinline__ float chunk_sum(const SimT* __restrict__ sim, int64_t ld,
                                           const float* __restrict__ curmax, int64_t col,
                                           int64_t r0, int64_t len) {
  const SimT* p = sim + r0 * ld + col;
  const float* m = curmax + r0;
  float acc = 0.0f;
  int64_t r = 0;
  for (; r + BATCH <= len; r += BATCH) {
    float v[BATCH], c[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      v[i] = tile::load_f32(p + (r + i) * ld);
      c[i] = __ldg(m + r + i);
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) acc += fmaxf(v[i] - c[i], 0.0f);
  }
  for (; r < len; ++r) acc += fmaxf(tile::load_f32(p + r * ld) - __ldg(m + r), 0.0f);
  return acc;
}

// The strides of a wave's members (in elements): S, curmax, the ids (a
// row of the engine's sorted ids) and the output rows.
struct Wave {
  int64_t sim, curmax, idx, out;
};

// out[j] for the k gathered columns clip(idx[j]).  Grid: ceil(k / G)
// clusters of CLUSTER blocks along x, the members along y; block: G columns
// x L slots, G * L <= blockDim.x <= MAX_THREADS.
template <typename SimT, typename IdxT, bool WAVE>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_THREADS)
    fl_gather_kernel(const SimT* __restrict__ sim, int64_t ld, int64_t u, int64_t n,
                     const float* __restrict__ curmax, const IdxT* __restrict__ idx, int64_t k,
                     int64_t rows_per_chunk, int G, int L, Wave wave, float* __restrict__ out) {
  __shared__ float part[MAX_THREADS];  // part[s * G + g]: column g's chunk w0 + s * CLUSTER + rank
  if (WAVE) {
    sim += blockIdx.y * wave.sim;
    curmax += blockIdx.y * wave.curmax;
    idx += blockIdx.y * wave.idx;
    out += blockIdx.y * wave.out;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t first = (int64_t)(blockIdx.x / CLUSTER) * G;  // the cluster's first slot
  const int g = threadIdx.x % G;
  const int s = threadIdx.x / G;  // this thread's slot in each window
  const int64_t j = first + g;
  const bool live = s < L && j < k && idx[j] >= 0;  // pads read nothing
  const int64_t col = live ? tile::gathered(idx, j, n) : 0;
  const int64_t nchunks = (u + rows_per_chunk - 1) / rows_per_chunk;
  const int64_t window = (int64_t)CLUSTER * L;
  const int fg = rank + CLUSTER * (int)threadIdx.x;  // the column this thread folds
  const bool folds = fg < G;
  float run = 0.0f;
  for (int64_t w0 = 0; w0 < nchunks; w0 += window) {
    const int64_t c = w0 + (int64_t)s * CLUSTER + rank;
    if (live && c < nchunks) {
      const int64_t r0 = c * rows_per_chunk;
      const int64_t len = u - r0 < rows_per_chunk ? u - r0 : rows_per_chunk;
      part[s * G + g] = chunk_sum(sim, ld, curmax, col, r0, len);
    }
    cluster.sync();  // every chunk sum of the window is in place
    if (folds) {
      const int64_t count = nchunks - w0 < window ? nchunks - w0 : window;
      const float* src[CLUSTER];
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) src[q] = cluster.map_shared_rank(part, q) + fg;
#pragma unroll 4
      for (int t = 0; t * CLUSTER < count; ++t) {
        float v[CLUSTER];
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) v[q] = t * CLUSTER + q < count ? src[q][t * G] : 0.0f;
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q)
          if (t * CLUSTER + q < count) run += v[q];  // chunk order: nothing past nchunks
      }
    }
    cluster.sync();  // the window's slots are read; the next window may overwrite them
  }
  if (folds && first + fg < k) out[first + fg] = idx[first + fg] < 0 ? tile::kNegInf : run;
}

// Pass 1 of the full sweep: partial[b, c, j] = member b's column j's sum over
// chunk c (the members on grid.z).
template <typename SimT, bool WAVE>
__global__ void fl_partial_kernel(const SimT* __restrict__ sim, int64_t ld, int64_t u,
                                  int64_t n, const float* __restrict__ curmax,
                                  int64_t rows_per_chunk, int64_t nchunks, Wave wave,
                                  float* __restrict__ partial) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  if (WAVE) {
    sim += blockIdx.z * wave.sim;
    curmax += blockIdx.z * wave.curmax;
    partial += blockIdx.z * nchunks * n;
  }
  for (int64_t c = (int64_t)blockIdx.y * blockDim.y + threadIdx.y; c < nchunks;
       c += (int64_t)gridDim.y * blockDim.y) {
    const int64_t r0 = c * rows_per_chunk;
    const int64_t r1 = (r0 + rows_per_chunk < u) ? r0 + rows_per_chunk : u;
    const SimT* p = sim + r0 * ld + j;
    float acc = 0.0f;
#pragma unroll 8
    for (int64_t r = r0; r < r1; ++r, p += ld)
      acc += fmaxf(tile::load_f32(p) - __ldg(curmax + r), 0.0f);
    partial[c * n + j] = acc;
  }
}

// Pass 2 of a wave's full sweep: member blockIdx.y's column sums from its
// partials, in chunk order (tile::sum_partials_kernel's order, member by
// member).
__global__ void wave_sum_partials_kernel(const float* __restrict__ partial, int64_t nchunks,
                                         int64_t n, float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  partial += blockIdx.y * nchunks * n;
  float acc = 0.0f;
  for (int64_t c = 0; c < nchunks; ++c) acc += partial[c * n + j];
  out[blockIdx.y * n + j] = acc;
}

// The full sweep of `members` members into out (members, n), with partial
// (members, ceil(u / rows_per_chunk), n) scratch.
template <typename SimT>
int launch_full(const SimT* sim, int64_t ld, int64_t u, int64_t n, int64_t members,
                const float* curmax, Wave wave, int64_t rows_per_chunk, float* partial,
                float* out, cudaStream_t s) {
  const int64_t nchunks = (u + rows_per_chunk - 1) / rows_per_chunk;
  // block = bx columns x by chunks, 256 threads; a narrow sweep spends its
  // threads on chunks instead of idle columns
  int bx = 1;
  while (bx < n && bx < 256) bx *= 2;
  const int by = 256 / bx;
  const int64_t rows = (nchunks + by - 1) / by;
  const dim3 grid((unsigned)((n + bx - 1) / bx), (unsigned)(rows < MAX_GRID_Y ? rows : MAX_GRID_Y),
                  (unsigned)members);
  if (members > 1)
    fl_partial_kernel<SimT, true><<<grid, dim3(bx, by), 0, s>>>(sim, ld, u, n, curmax,
                                                                rows_per_chunk, nchunks, wave,
                                                                partial);
  else
    fl_partial_kernel<SimT, false><<<grid, dim3(bx, by), 0, s>>>(sim, ld, u, n, curmax,
                                                                 rows_per_chunk, nchunks, wave,
                                                                 partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (members > 1)
    wave_sum_partials_kernel<<<dim3((unsigned)((n + 255) / 256), (unsigned)members), 256, 0, s>>>(
        partial, nchunks, n, out);
  else
    tile::sum_partials_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        partial, nchunks, n, static_cast<const int32_t*>(nullptr), out);
  return (int)cudaGetLastError();
}

// out[j] = full[clip(idx[j])], NEG_INF where idx[j] < 0 (the members on
// grid.y: full (members, n)).
template <typename IdxT, bool WAVE>
__global__ void gather_kernel(const float* __restrict__ full, int64_t n,
                              const IdxT* __restrict__ idx, int64_t k, Wave wave,
                              float* __restrict__ out) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (WAVE) {
    full += blockIdx.y * n;
    idx += blockIdx.y * wave.idx;
    out += blockIdx.y * wave.out;
  }
  if (j < k) out[j] = idx[j] < 0 ? tile::kNegInf : full[tile::gathered(idx, j, n)];
}

template <typename SimT, typename IdxT>
int launch_at(const SimT* sim, int64_t ld, int64_t u, int64_t n, int64_t members,
              const float* curmax, Wave wave, const IdxT* idx, int64_t k, int64_t rows_per_chunk,
              int group, int slots, int threads, float* partial, float* full, float* out,
              cudaStream_t s) {
  if (full != nullptr) {  // past the crossover: every column into full, then the k slots
    const int rc = launch_full(sim, ld, u, n, members, curmax, wave, rows_per_chunk, partial, full,
                               s);
    if (rc != 0) return rc;
    const dim3 grid((unsigned)((k + 255) / 256), (unsigned)members);
    if (members > 1)
      gather_kernel<IdxT, true><<<grid, 256, 0, s>>>(full, n, idx, k, wave, out);
    else
      gather_kernel<IdxT, false><<<grid, 256, 0, s>>>(full, n, idx, k, wave, out);
    return (int)cudaGetLastError();
  }
  // one launch: the k gathered columns
  if (group < 1 || slots < 1 || (int64_t)group * slots > threads || threads > MAX_THREADS ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (k + group - 1) / group * CLUSTER;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks, (unsigned)members);
  if (members > 1)
    fl_gather_kernel<SimT, IdxT, true><<<grid, threads, 0, s>>>(
        sim, ld, u, n, curmax, idx, k, rows_per_chunk, group, slots, wave, out);
  else
    fl_gather_kernel<SimT, IdxT, false><<<grid, threads, 0, s>>>(
        sim, ld, u, n, curmax, idx, k, rows_per_chunk, group, slots, wave, out);
  return (int)cudaGetLastError();
}

// The wave entry below for S of element type SimT.
template <typename SimT>
int wave_launch(const SimT* sim, int64_t sim_stride, int64_t ld, int64_t u, int64_t n,
                int64_t members, const float* curmax, int64_t curmax_stride, const void* idx,
                int idx_bytes, int64_t idx_stride, int64_t k, int64_t rows_per_chunk, int group,
                int slots, int threads, float* partial, float* full, float* out, void* stream) {
  if (k <= 0 || u <= 0 || n <= 0 || rows_per_chunk <= 0 || members <= 0 || members > MAX_GRID_Y)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Wave wave{sim_stride, curmax_stride, idx_stride, k};
  if (idx == nullptr)
    return k == n ? launch_full(sim, ld, u, n, members, curmax, wave, rows_per_chunk, partial, out,
                                s)
                  : (int)cudaErrorInvalidValue;
  if (full != nullptr && partial == nullptr) return (int)cudaErrorInvalidValue;
  if (idx_bytes == 4)
    return launch_at(sim, ld, u, n, members, curmax, wave, static_cast<const int32_t*>(idx), k,
                     rows_per_chunk, group, slots, threads, partial, full, out, s);
  if (idx_bytes == 8)
    return launch_at(sim, ld, u, n, members, curmax, wave, static_cast<const int64_t*>(idx), k,
                     rows_per_chunk, group, slots, threads, partial, full, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A wave of `members` sweeps: member b's S (u, n) with row stride ld at
// sim + b * sim_stride (elements of sim_bytes: 4, fp32, or 2, bf16), its
// curmax (u,) at curmax + b * curmax_stride, its output row (k,) at
// out + b * k.  idx null: the full sweep (k == n), with partial (members,
// ceil(u / rows_per_chunk), n) scratch.  idx with idx_bytes 4 (int32) or 8
// (int64), member b's k ids at idx + b * idx_stride: the gathered sweep;
// with full null, one launch laid out as group (G) columns x slots (L) in
// blocks of threads (kernels/fl_gains.py::sweep_layout); with full
// (members, n) and partial scratch, the crossover: the full sweep into
// full, then out gathered from it.  out and the scratch are allocated by
// the caller.  Returns cudaGetLastError().
extern "C" int fl_gains_wave_launch(const void* sim, int64_t sim_stride, int64_t ld, int64_t u,
                                    int64_t n, int64_t members, const float* curmax,
                                    int64_t curmax_stride, const void* idx, int idx_bytes,
                                    int64_t idx_stride, int64_t k, int64_t rows_per_chunk,
                                    int group, int slots, int threads, float* partial, float* full,
                                    float* out, void* stream, int sim_bytes) {
  if (sim_bytes == 4)
    return wave_launch(static_cast<const float*>(sim), sim_stride, ld, u, n, members, curmax,
                       curmax_stride, idx, idx_bytes, idx_stride, k, rows_per_chunk, group, slots,
                       threads, partial, full, out, stream);
  if (sim_bytes == 2)
    return wave_launch(static_cast<const tile::bf16_t*>(sim), sim_stride, ld, u, n, members,
                       curmax, curmax_stride, idx, idx_bytes, idx_stride, k, rows_per_chunk, group,
                       slots, threads, partial, full, out, stream);
  return (int)cudaErrorInvalidValue;
}

// One fp32 sweep (the wave entry with one member): sim (u, n) fp32 with row
// stride ld, curmax (u,), idx (k,) or null, out (k,); partial (ceil(u /
// rows_per_chunk), n) and full (n,) as above.
extern "C" int fl_gains_launch(const float* sim, int64_t ld, int64_t u, int64_t n,
                               const float* curmax, const void* idx, int idx_bytes, int64_t k,
                               int64_t rows_per_chunk, int group, int slots, int threads,
                               float* partial, float* full, float* out, void* stream) {
  return fl_gains_wave_launch(sim, 0, ld, u, n, 1, curmax, 0, idx, idx_bytes, 0, k,
                              rows_per_chunk, group, slots, threads, partial, full, out, stream, 4);
}

// Message for a code returned by the launch functions above.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
