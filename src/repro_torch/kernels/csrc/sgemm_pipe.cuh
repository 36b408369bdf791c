// The pipelined mainloop of the 128 x 128 fp32 SGEMM tile, written for
// Hopper's SMs (similarity.cu, fused_fl_sweep.cu, flmf_gains.cu).
//
// It computes what tile::mainloop computes (tile_common.cuh): the same 256
// threads, the same 8 x 8 accumulators per thread at tile_pos(ty, i) /
// tile_pos(tx, j), and each accumulator one fmaf chain over k = 0 .. d-1 in
// order, so both give every element the same bits.  What differs is how the
// operands reach shared memory, how they are read there, and how often the
// block waits:
//
// - Copies.  Strips of BK = 32 k are copied with cp.async into a ring of
//   slots in dynamic shared memory, up to STAGES - 1 strips ahead of the one
//   being computed, with one barrier per strip (wait for the strip, barrier,
//   issue the next copy, compute): 16 barriers per tile at d = 512 where
//   tile::mainloop has 128, and no wait on device memory once the ring is
//   full.  The per-row-pointer interface stays (a thread copies half of row
//   tid / 2 of each operand), so a gathered kernel can take it: that is why
//   the copies are cp.async and not TMA, whose tiled loads cannot gather
//   rows.
// - Load paths, picked by the launcher from d, the dtypes and the pointers
//   (aligned_rows below).  VEC: every row is 16-byte aligned (fp32
//   d % 4 == 0, bf16 d % 8 == 0, aligned bases); !VEC: some row is not.
//     fp32, VEC: 16-byte cp.async.cg straight into the ring;
//     fp32, !VEC: 4-byte cp.async.ca straight into the ring;
//     bf16, VEC: 16-byte cp.async.cg (8 elements) into a bf16 staging ring;
//       after its wait each thread widens the chunks it copied itself, exactly
//       (the 16 bits become the high half of the fp32), into the fp32 ring;
//     bf16, !VEC: element loads, widened, stored into the ring when the
//       strip's turn comes (no prefetch: a bf16 row may start 2 bytes off).
//   Whatever the path, the ring holds the same fp32 values, so every path
//   gives the same bits.  Rows past a ragged edge and k past d load zeros
//   (cp.async's src-size operand 0), as tile::mainloop's do, and the last
//   strip stops where tile::mainloop's last 8-k strip stops: both add the
//   same zero tail, so even the sign of an exact zero agrees.
// - Layout.  A slot holds 128 rows of 32 floats, k-contiguous, each row
//   padded to 36 floats (144 bytes), and row r stored at slot row
//   (r % 4) * 32 + r / 4.  A thread's 8 rows then sit at compile-time offsets
//   from one base, and each read is a float4 along k (16 LDS.128 per 4 k,
//   as in tile::mainloop).  Among the 8 lanes of one LDS.128 phase the B rows
//   are consecutive slot rows, which the 144-byte stride puts in 8 different
//   bank groups; the copies rotate their chunk order by r % 4 so that the
//   cp.async writes of a phase hit 8 different bank groups too.  No bank
//   conflict either way.
// - Resources.  One block per SM (__launch_bounds__(256, 1)).  The unrolled
//   strip wants about 165 registers: 64 accumulators, 36 operand registers
//   and the next reads' in flight.  Held to 128 (two blocks per SM), ptxas
//   spilled 8 to 136 bytes in each of the variants tried on an H100 (operand
//   reads as float4 or float2, half the A rows at a time, the loader's row
//   pointers kept in shared memory), and none ran more than 7% faster than
//   the one-block build, which spills nothing.  With the SM to itself the
//   ring takes 4 fp32 slots (144 KB), or 3 when an operand is bf16 (with
//   its staging ring beside them).
// - Tiles.  With one block per SM nothing else on the SM hides a tile's
//   first copies or its epilogue, so the blocks are persistent (tile_loop):
//   the grid has one block per SM, each walks its share of the tiles, and
//   the strips of all its tiles form one stream through the ring, so the
//   next tile's first strips are in flight while a tile finishes and stores.

#pragma once

#include <type_traits>

#include "tile_common.cuh"

namespace tile {
namespace {
namespace pipe {

constexpr int MIN_BLOCKS = 1;       // resident blocks per SM the kernels are built for
constexpr int BK = 32;              // k per strip
constexpr int ROW = BK + 4;         // floats per slot row: 144 bytes
constexpr int SLOT = BM * ROW;      // floats of one operand's strip (BM == BN)
constexpr int STEP = 2 * SLOT * 4;  // bytes from one ring slot to the next (A and B strips)
constexpr int STAGE_BF16 = BM * BK * 2;  // bytes of one bf16 staging slot
constexpr int GROUP_ROWS = 16;      // row tiles walked together by grouped()
constexpr int64_t MAX_D = (1 << 30);  // k stays a 32-bit int: launchers refuse more
static_assert(BM == BN, "one slot shape serves both operands");

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16_t>::value;
}

template <typename TA, typename TB>
__host__ __device__ constexpr int stages() {
  return (!is_bf16<TA>() && !is_bf16<TB>()) ? 4 : 3;
}

template <typename T, bool VEC>
__host__ __device__ constexpr int staging_bytes() {
  return (VEC && is_bf16<T>()) ? STAGE_BF16 : 0;
}

// Dynamic shared memory of one block: the fp32 ring, then any bf16 staging.
template <typename TA, typename TB, bool VEC>
__host__ __device__ constexpr int smem_bytes() {
  return stages<TA, TB>() * (STEP + staging_bytes<TA, VEC>() + staging_bytes<TB, VEC>());
}

// Slot row of tile row r.
__device__ __forceinline__ int slot_row(int r) { return (r & 3) * 32 + (r >> 2); }

// Slot row of register slot i of thread group t, less t: tile_pos(t, i)
// sits at slot row t + group_row(i).
__host__ __device__ constexpr int group_row(int i) { return 32 * (i & 3) + 16 * (i >> 2); }

// Copy 16 bytes from src to the shared address dst, of which the first
// src_bytes are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// The same for 4 bytes (cached in L1: .cg takes 16-byte copies only).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c),
               "f"(d)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float widen_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float widen_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One operand's copies into the ring: this thread's half of tile row
// threadIdx.x / 2 of the tile it was last pointed at.
template <typename T, bool VEC>
struct Loader {
  const T* row = nullptr;  // a valid row even past a ragged edge: it is then never read
  int len = 0;             // elements of it this thread may read: d, or 0 past the edge
  uint32_t ring;           // shared address of the row in this operand's slot 0
  uint32_t staging;        // shared address of the row in bf16 staging slot 0

  __device__ __forceinline__ Loader(uint32_t ring_, uint32_t staging_) {
    const int r = threadIdx.x >> 1;
    ring = ring_ + slot_row(r) * ROW * 4;
    staging = staging_ + r * 64;
  }
  __device__ __forceinline__ void point(const T* row_, bool ok, int d) {
    row = row_;
    len = ok ? d : 0;
  }

  // fp32 chunk (4 k) of this thread's q-th copy: the half of its row that
  // threadIdx.x % 2 picks, in chunk pairs rotated by (row % 4)
  __device__ __forceinline__ static int chunk(int q) {
    return 2 * ((q + (threadIdx.x >> 1)) & 3) + (threadIdx.x & 1);
  }
  __device__ __forceinline__ uint32_t dst(int slot, int c) const {
    return ring + slot * STEP + 16 * c;
  }
  // bf16 staging: 4 chunks of 8 k per 64-byte row, pairs swapped on rows
  // 2, 3 mod 4 so that a phase's 8 copies hit 8 bank groups
  __device__ __forceinline__ uint32_t stage(int slot, int cb) const {
    return staging + slot * STAGE_BF16 + 16 * (cb ^ (threadIdx.x & 4 ? 2 : 0));
  }

  // Start the copies of strip p into ring slot `slot` (all paths but bf16
  // element loads).
  __device__ __forceinline__ void issue(int p, int slot) const {
    if constexpr (VEC && is_bf16<T>()) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cb = 2 * q + (threadIdx.x & 1);
        const int k = p * BK + 8 * cb;
        const bool in = k < len;  // d % 8 == 0: a chunk is all in or all out
        cp_async16(stage(slot, cb), in ? row + k : row, in ? 16 : 0);
      }
    } else if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = chunk(q);
        const int k = p * BK + 4 * c;
        const bool in = k < len;  // d % 4 == 0
        cp_async16(dst(slot, c), in ? row + k : row, in ? 16 : 0);
      }
    } else if constexpr (!is_bf16<T>()) {
      // fp32 rows that are not 16-byte aligned: 4-byte copies.  A lane takes
      // its chunk's elements from element (row / 4) % 4 on, so the 32 copies
      // of one instruction hit 32 different banks.
      const int rot = (threadIdx.x >> 3) & 3;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e0 = 0; e0 < 4; ++e0) {
          const int c = chunk(q), e = (e0 + rot) & 3;
          const int k = p * BK + 4 * c + e;
          const bool in = k < len;
          cp_async4(dst(slot, c) + 4 * e, in ? row + k : row, in ? 4 : 0);
        }
    }
  }

  // Finish strip p in ring slot `slot` once this thread's copies of it have
  // landed: widen the bf16 staging, or load bf16 rows element by element.
  __device__ __forceinline__ void land(int p, int slot) const {
    if constexpr (VEC && is_bf16<T>()) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cb = 2 * q + (threadIdx.x & 1);
        const uint4 v = ld_shared4(stage(slot, cb));
        st_shared4(dst(slot, 2 * cb), widen_lo(v.x), widen_hi(v.x), widen_lo(v.y), widen_hi(v.y));
        st_shared4(dst(slot, 2 * cb + 1), widen_lo(v.z), widen_hi(v.z), widen_lo(v.w),
                   widen_hi(v.w));
      }
    } else if constexpr (!VEC && is_bf16<T>()) {
      float v[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = p * BK + 4 * chunk(q) + e;
          v[q][e] = k < len ? load_f32(row + k) : 0.0f;
        }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        st_shared4(dst(slot, chunk(q)), v[q][0], v[q][1], v[q][2], v[q][3]);
    }
  }
};

// acc[i][j] += the products of 4 k of one ring slot, from k = 4 kq on, in
// order.  a / b point at the slot's A / B rows of this thread's group (ty /
// tx).
__device__ __forceinline__ void quad_fma(const float* a, const float* b, int kq,
                                         float (&acc)[8][8]) {
  float4 av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    av[i] = *reinterpret_cast<const float4*>(a + group_row(i) * ROW + 4 * kq);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 bv = *reinterpret_cast<const float4*>(b + group_row(j) * ROW + 4 * kq);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
      acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
      acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
      acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
    }
  }
}

// acc[i][j] += the strip's products, k in order: all 32 (quads = 8, the
// unrolled path), or its first 4 * quads (a ragged last strip; compiled in
// only where d % BK != 0, so the full strips of the other build keep the
// registers to themselves).
template <bool TAIL>
__device__ __forceinline__ void strip_fma(const float* a, const float* b, int quads,
                                          float (&acc)[8][8]) {
  if (TAIL && quads != BK / 4) {
#pragma unroll 1
    for (int kq = 0; kq < quads; ++kq) quad_fma(a, b, kq, acc);
  } else {
#pragma unroll
    for (int kq = 0; kq < BK / 4; ++kq) quad_fma(a, b, kq, acc);
  }
}

// The tile loop: this block's share of an ntiles-tile output, the tiles
// blockIdx.x, blockIdx.x + gridDim.x, ... of grouped()'s order (the grid is
// one block per resident slot: a persistent block).  For each, acc[i][j] =
// <a_{tile_pos(ty, i)}, b_{tile_pos(tx, j)}> over k = 0 .. d-1, with
// ty = threadIdx.x / 16, tx = threadIdx.x % 16: tile::mainloop's contract.
// The strips of all the block's tiles form one stream through the ring, so
// a tile's first strips are in flight while the previous tile finishes and
// runs its epilogue.
//   rows(tile, a_row, a_ok, b_row, b_ok): this thread's rows of a tile, row
//     threadIdx.x / 2 of its A and B tiles, each a valid row even when its
//     flag is false (the row then lies past a ragged edge and loads zeros);
//   done(tile, acc): the tile's epilogue, called by every thread; it may
//     synchronise the block but must leave the first smem_bytes<TA, TB,
//     VEC>() bytes of `smem` alone.
// VEC: every row of both operands starts 16-byte aligned and holds a whole
// number of 16-byte chunks.  TAIL: d % BK != 0.  d <= MAX_D.
template <typename TA, typename TB, bool VEC, bool TAIL, typename Rows, typename Done>
__device__ __forceinline__ void tile_loop(int64_t ntiles, int64_t d, unsigned char* smem,
                                          Rows rows, Done done) {
  constexpr int S = stages<TA, TB>();
  const int64_t first = blockIdx.x, step = gridDim.x;
  if (first >= ntiles) return;
  const int64_t count = (ntiles - 1 - first) / step + 1;  // tiles of this block
  const int strips = (int)((d + BK - 1) / BK);
  // k of the last strip that tile::mainloop's 8-k strips reach: the same
  // zero tail, so even the sign of an exact zero matches it
  const int last_quads = 2 * (int)((d - (int64_t)(strips - 1) * BK + 7) / 8);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t stage_a = base + S * STEP;
  const uint32_t stage_b = stage_a + S * staging_bytes<TA, VEC>();
  // the copies' tile runs S - 1 strips ahead of the tile being landed
  Loader<TA, VEC> A(base, stage_a), LA(base, stage_a);
  Loader<TB, VEC> B(base + SLOT * 4, stage_b), LB(base + SLOT * 4, stage_b);
  const auto point = [&](Loader<TA, VEC>& a, Loader<TB, VEC>& b, int64_t local) {
    const TA* a_row;
    const TB* b_row;
    bool a_ok, b_ok;
    rows(first + local * step, a_row, a_ok, b_row, b_ok);
    a.point(a_row, a_ok, (int)d);
    b.point(b_row, b_ok, (int)d);
  };
  int64_t next_tile = 0;  // the next copy: strip next_strip of local tile next_tile
  int next_strip = 0;
  const auto issue_next = [&](int slot) {
    if (next_tile < count) {
      if (next_strip == 0) point(A, B, next_tile);
      A.issue(next_strip, slot);
      B.issue(next_strip, slot);
      if (++next_strip == strips) {
        next_strip = 0;
        ++next_tile;
      }
    }
    cp_async_commit();  // one group per strip, empty past the end
  };
#pragma unroll
  for (int p = 0; p < S - 1; ++p) issue_next(p);

  const float* ring = reinterpret_cast<const float*>(smem);
  const float* a = ring + (threadIdx.x / GROUPS) * ROW;
  const float* b = ring + SLOT + (threadIdx.x % GROUPS) * ROW;
  int slot = 0;  // ring slot of the strip being landed
  for (int64_t t = 0; t < count; ++t) {
    point(LA, LB, t);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int s = 0; s < strips; ++s) {
      cp_async_wait<S - 2>();  // this thread's copies of the strip have landed
      LA.land(s, slot);
      LB.land(s, slot);
      __syncthreads();  // the strip is in the ring; the previous strip's slot is free
      issue_next((slot == 0) ? S - 1 : slot - 1);
      strip_fma<TAIL>(a + slot * 2 * SLOT, b + slot * 2 * SLOT,
                      s + 1 < strips ? BK / 4 : last_quads, acc);
      slot = (slot + 1 == S) ? 0 : slot + 1;
    }
    done(first + t * step, acc);
  }
}

// Output tile (bx, by) of block `lin` (the block's linear index over an
// nbx x nby grid): blocks walk GROUP_ROWS row tiles of one column tile, then
// the next column tile, so the blocks resident at once share their row tiles
// and a few column tiles in L2 instead of sweeping every column tile once
// per row tile.
__device__ __forceinline__ void grouped(int64_t lin, int64_t nbx, int64_t nby, int64_t& bx,
                                        int64_t& by) {
  const int64_t per_group = GROUP_ROWS * nbx;
  const int64_t first = lin / per_group * GROUP_ROWS;
  const int64_t rows = (nby - first < GROUP_ROWS) ? nby - first : GROUP_ROWS;
  const int64_t in = lin % per_group;
  by = first + in % rows;
  bx = in / rows;
}

// First row and column of output tile `tile` of an nbx x nby grid of tiles.
__device__ __forceinline__ void tile_origin(int64_t tile, int64_t nbx, int64_t nby,
                                            int64_t& row0, int64_t& col0) {
  int64_t bx, by;
  grouped(tile, nbx, nby, bx, by);
  row0 = by * BM;
  col0 = bx * BN;
}

// Let `kernel` take `bytes` of dynamic shared memory (past the default 48 KB)
// with the carveout set for the most shared memory.
inline cudaError_t allow_smem(const void* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Resident blocks per SM of `kernel` at THREADS threads and `bytes` of
// dynamic shared memory.
inline cudaError_t blocks_per_sm(const void* kernel, int bytes, int* blocks) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, THREADS, (size_t)bytes);
}

// The persistent grid of `kernel` for ntiles tiles: as many blocks as fit on
// the card at once, and no more than there are tiles.
inline cudaError_t persistent_grid(const void* kernel, int bytes, int64_t ntiles, unsigned* grid) {
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  return resident_grid(kernel, THREADS, bytes, ntiles, grid);
}

// Whether rows of d elements of `bytes` each, starting at p, are all 16-byte
// aligned: the VEC paths' condition, from which the launchers pick the path.
inline bool aligned_rows(const void* p, int64_t d, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (d * bytes) % 16 == 0;
}

}  // namespace pipe
}  // namespace
}  // namespace tile
