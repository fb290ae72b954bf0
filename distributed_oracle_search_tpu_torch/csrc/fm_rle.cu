// The build's compressed device-to-host fetch (K7): the run-length code of
// an int8 [C, N] first-move block along its target axis.
//
// Replaces no Pallas kernel: it serves the JAX package's XLA stage
// models/cpd.py::_fm_run_count + _fm_rle_encode_impl (the device side of
// fetch_fm). There the block is transposed, flattened column-major
// (index j * C + i holds fm[i, j]), and a run starts at every entry that
// differs from the one before and at every column's first entry (i = 0);
// the runs, in that order, are (len uint16, val int8). A run never passes
// a column's end, so len <= C <= 65535 (callers gate C).
//
// fm_run_count: counts[j] = the runs of column j (int32 [N]).
// fm_rle_encode: column j's runs written at offsets[j] + k, k = 0, 1, ...
//   (offsets: int64 [N], the exclusive prefix sum of counts), which is the
//   JAX run order. Offsets and positions are int64: a block past 2^31
//   cells (a whole shard's delta recompute) indexes correctly.
//
// Bound: bytes. The count must read the block once (C x N bytes) and
// write 4 N; the encode reads the block and the offsets once and writes
// 3 bytes a run.
// The count: one thread a column walks i = 0 .. C-1, so the threads of a
// warp read 32 adjacent bytes of one row (one sector a load) and no
// transposed copy is made; the row loop is unrolled so that each thread
// keeps several independent loads in flight (the column's state is a byte
// and a count).
// The encode: a store a run at its column's cursor, one thread a column,
// would send a warp's stores to 32 regions at once, each a partial
// sector, under divergent branches (7x the bound on the H100). Instead a
// block takes 64 adjacent columns and walks them down in tiles of 256
// rows:
// * the tile lands transposed in shared memory, a column's rows
//   contiguous: where a row is whole 32-bit words (N % 4 == 0), each
//   thread loads 4 x 4 bytes (a warp two rows' 64 bytes a load) into
//   registers and transposes them by __byte_perm, a word a store, and the
//   next tile's loads are issued before this tile is walked (in flight
//   meanwhile); else a warp reads 32 adjacent bytes of a row, a byte a
//   thread, straight to the tile;
// * a warp walks one column at a time, 8 rows a lane (two words): a byte
//   that differs from the one before starts a run (and every column's row
//   0), found for 4 bytes at once by a carry trick; a scan of the lanes'
//   counts gives each start its slot in the column's run order, and the
//   starts (row, value) go to the warp's ring in shared memory;
// * 32 runs whose ends are known (the next run has started) are written
//   by the warp's 32 lanes at consecutive addresses (offsets[j] + k: the
//   JAX order), lens as 64 bytes and vals as 32; a column's last runs at
//   its end, its length C - start;
// * a column's state (the last byte, the runs not yet written, up to 32,
//   and the count written) waits in shared memory for the next tile.
// Both launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
    run_count_kernel(const int8_t* __restrict__ fm, int* __restrict__ counts,
                     long long c, long long n) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const int8_t* p = fm + j;
  int8_t prev = __ldg(p);
  int cnt = 1;
#pragma unroll kUnroll
  for (long long i = 1; i < c; ++i) {
    const int8_t cur = __ldg(p + i * n);
    cnt += cur != prev;
    prev = cur;
  }
  counts[j] = cnt;
}

// the encode's tiles: columns a block, rows a tile, a column's stride in
// shared memory (a multiple of 4, 4 times an odd number: no two lanes of
// a warp on one bank), the warp's ring of run starts (up to 32 carried +
// 256 new), the runs a column carries to the next tile
constexpr int kTileCols = 64;
constexpr int kTileRows = 256;
constexpr int kColStride = kTileRows + 4;
constexpr int kColWords = kColStride / 4;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerWarp = kTileCols / kWarps;
constexpr int kRing = 512;
constexpr int kCarry = 32;
constexpr int kQuads = kTileRows / 64;  // 4-row groups a thread loads
constexpr unsigned kFull = 0xffffffffu;

// bit k set where byte k of x is not zero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  const unsigned hi = (((x & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x) & 0x80808080u;
  return ((hi >> 7) * 0x01020408u) >> 24;
}

// The 4-byte-aligned tile load: thread (q = tid % 16, rq = tid / 16)
// reads columns 4 q .. 4 q + 3 of rows 4 (rq + 16 i) .. + 3, one 32-bit
// word a row, into registers (a warp reads two rows' 64 bytes a load).
__device__ __forceinline__ void load_quads(unsigned (&pre)[kQuads][4],
                                           const int8_t* __restrict__ fm,
                                           long long r0, int rows, int cols,
                                           long long j0, long long n) {
  const int q = threadIdx.x & 15, rq = threadIdx.x >> 4;
  const int8_t* const src = fm + r0 * n + j0 + 4 * q;
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int rr = 4 * (rq + 16 * i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      pre[i][k] = 4 * q < cols && rr + k < rows
                      ? __ldg(reinterpret_cast<const unsigned*>(
                            src + (rr + k) * n))
                      : 0u;
    }
  }
}

// ... and into the tile transposed: 4 x 4 bytes by __byte_perm, a word of
// 4 rows of a column a store.
__device__ __forceinline__ void store_quads(const unsigned (&pre)[kQuads][4],
                                            unsigned char* tile, int rows,
                                            int cols) {
  const int q = threadIdx.x & 15, rq = threadIdx.x >> 4;
  if (4 * q >= cols) return;
  unsigned* const d = reinterpret_cast<unsigned*>(tile + 4 * q * kColStride);
#pragma unroll
  for (int i = 0; i < kQuads; ++i) {
    const int w = rq + 16 * i;
    if (4 * w >= rows) break;
    const unsigned t0 = __byte_perm(pre[i][0], pre[i][1], 0x5140);
    const unsigned t1 = __byte_perm(pre[i][2], pre[i][3], 0x5140);
    const unsigned t2 = __byte_perm(pre[i][0], pre[i][1], 0x7362);
    const unsigned t3 = __byte_perm(pre[i][2], pre[i][3], 0x7362);
    d[w] = __byte_perm(t0, t1, 0x5410);
    d[kColWords + w] = __byte_perm(t0, t1, 0x7632);
    d[2 * kColWords + w] = __byte_perm(t2, t3, 0x5410);
    d[3 * kColWords + w] = __byte_perm(t2, t3, 0x7632);
  }
}

__global__ void __launch_bounds__(kThreads)
    rle_encode_kernel(const int8_t* __restrict__ fm,
                      const long long* __restrict__ offsets,
                      uint16_t* __restrict__ lens, int8_t* __restrict__ vals,
                      long long c, long long n) {
  __shared__ __align__(16) unsigned char tile[kTileCols * kColStride];
  __shared__ uint16_t ring_start[kWarps][kRing];
  __shared__ int8_t ring_val[kWarps][kRing];
  __shared__ uint16_t carry_start[kTileCols][kCarry];
  __shared__ int8_t carry_val[kTileCols][kCarry];
  __shared__ int col_prev[kTileCols], col_pending[kTileCols],
      col_written[kTileCols];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTileCols;
  const int cols = n - j0 < kTileCols ? static_cast<int>(n - j0) : kTileCols;
  // whole 32-bit words a row: the register path, the next tile's loads in
  // flight while this one is walked; else byte loads straight to the tile
  const bool quad =
      n % 4 == 0 && (reinterpret_cast<unsigned long long>(fm) & 3) == 0;
  unsigned pre[kQuads][4];
  if (tid < kTileCols) col_pending[tid] = col_written[tid] = 0;
  if (quad) {
    load_quads(pre, fm, 0, c < kTileRows ? static_cast<int>(c) : kTileRows,
               cols, j0, n);
  }
  uint16_t* const rs = ring_start[warp];
  int8_t* const rv = ring_val[warp];
  for (long long r0 = 0; r0 < c; r0 += kTileRows) {
    const int rows = c - r0 < kTileRows ? static_cast<int>(c - r0) : kTileRows;
    if (quad) {
      store_quads(pre, tile, rows, cols);
    } else {
      // a warp reads 32 adjacent bytes of a row
      const int tc = tid % kTileCols, tr = tid / kTileCols;
      if (tc < cols) {
        const int8_t* src = fm + (r0 + tr) * n + j0 + tc;
        unsigned char* dst = tile + tc * kColStride;
        constexpr int kStep = kThreads / kTileCols;
#pragma unroll 8
        for (int r = tr; r < rows; r += kStep) {
          dst[r] = static_cast<unsigned char>(__ldg(src));
          src += kStep * n;
        }
      }
    }
    __syncthreads();
    if (quad && r0 + kTileRows < c) {
      const long long r1 = r0 + kTileRows;
      load_quads(pre, fm, r1,
                 c - r1 < kTileRows ? static_cast<int>(c - r1) : kTileRows,
                 cols, j0, n);
    }
    for (int cc = 0; cc < kColsPerWarp; ++cc) {
      const int col = warp * kColsPerWarp + cc;
      if (col >= cols) break;
      const long long out = offsets[j0 + col];
      int pending = col_pending[col], written = col_written[col];
      unsigned head = 0;
      if (lane < pending) {
        rs[lane] = carry_start[col][lane];
        rv[lane] = carry_val[col][lane];
      }
      __syncwarp();
      // lane l holds the tile's rows 8 l .. 8 l + 7 (byte k: row 8 l + k)
      const unsigned* const words =
          reinterpret_cast<const unsigned*>(tile + col * kColStride);
      const unsigned w0 = words[2 * lane], w1 = words[2 * lane + 1];
      const unsigned up = __shfl_up_sync(kFull, w1, 1);
      const unsigned before =
          lane == 0 ? static_cast<unsigned>(col_prev[col]) : up >> 24;
      unsigned bits = nonzero_bytes(w0 ^ ((w0 << 8) | (before & 0xffu))) |
                      (nonzero_bytes(w1 ^ ((w1 << 8) | (w0 >> 24))) << 4);
      if (r0 == 0 && lane == 0) bits |= 1u;  // a column's first row
      if (rows < kTileRows) {
        const int valid = rows - 8 * lane;
        bits &= valid >= 8 ? 0xffu : valid > 0 ? (1u << valid) - 1u : 0u;
      }
      // each start's slot in the column's run order: a scan of the counts
      const int cnt = __popc(bits);
      int incl = cnt;
#pragma unroll
      for (int dd = 1; dd < 32; dd <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, dd);
        if (lane >= dd) incl += t;
      }
      unsigned slot = pending + incl - cnt;
      const int row = static_cast<int>(r0) + 8 * lane;
      while (bits) {
        const int k = __ffs(bits) - 1;
        rs[slot & (kRing - 1)] = static_cast<uint16_t>(row + k);
        rv[slot & (kRing - 1)] =
            static_cast<int8_t>((k < 4 ? w0 : w1) >> (8 * (k & 3)));
        ++slot;
        bits &= bits - 1u;
      }
      pending += __shfl_sync(kFull, incl, 31);
      __syncwarp();
      // 32 runs whose next run has started: their lengths are known
      while (pending > 32) {
        const unsigned a = (head + lane) & (kRing - 1);
        const long long at = out + written + lane;
        lens[at] = static_cast<uint16_t>(rs[(a + 1) & (kRing - 1)] - rs[a]);
        vals[at] = rv[a];
        head += 32;
        pending -= 32;
        written += 32;
      }
      __syncwarp();
      if (r0 + rows == c) {
        // the column's end: its last runs, the last one up to row C
        if (lane < pending) {
          const unsigned a = (head + lane) & (kRing - 1);
          const int end = lane + 1 < pending ? rs[(a + 1) & (kRing - 1)]
                                             : static_cast<int>(c);
          lens[out + written + lane] = static_cast<uint16_t>(end - rs[a]);
          vals[out + written + lane] = rv[a];
        }
      } else {
        if (lane < pending) {
          carry_start[col][lane] = rs[(head + lane) & (kRing - 1)];
          carry_val[col][lane] = rv[(head + lane) & (kRing - 1)];
        }
        if (lane == 0) {
          col_pending[col] = pending;
          col_written[col] = written;
          col_prev[col] = tile[col * kColStride + rows - 1];
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

unsigned blocks_for(long long n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

// fm int8 [c, n] (row-major, contiguous) -> counts int32 [n]. One launch.
extern "C" int fm_run_count(const void* fm, void* counts, long long c,
                            long long n, void* stream) {
  if (c < 1 || n < 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    run_count_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(fm), static_cast<int*>(counts), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// fm int8 [c, n], offsets int64 [n] -> lens uint16 / vals int8, one entry
// a run (sum of the counts). c <= 65535. One launch.
extern "C" int fm_rle_encode(const void* fm, const void* offsets, void* lens,
                             void* vals, long long c, long long n,
                             void* stream) {
  if (c < 1 || c > 65535 || n < 0 ||
      (n + kTileCols - 1) / kTileCols > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    rle_encode_kernel<<<blocks_for(n, kTileCols), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(fm), static_cast<const long long*>(offsets),
        static_cast<uint16_t*>(lens), static_cast<int8_t*>(vals), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}
