// CPD build kernels: the Jacobi relax step, the first-move extraction and
// the fast-sweeping grid cycle, over int32 distances in batch-minor [N, B]
// layout (node x's B target columns contiguous).
//
// They replace no Pallas kernel: the JAX package's build stages are jitted
// XLA (ops/bellman_ford.py, ops/ell_split.py, ops/shift_relax.py,
// ops/grid_sweep.py), and these kernels take over the work that those
// stages do on the card, each held bit for bit against the port's plain
// torch version of the same stage.
//
// relax_jacobi (K1): out[x, b] = min(d[x, b], min over the out-edges e of
//   x of min(w[e] + d[v_e, b], INF)), read from d, written to out, over a
//   CSR edge set. The full out-edge CSR gives one step of the ell,
//   ellsplit and shift builds, which all compute this same Jacobi iterate
//   (ell_split.py:115-120, shift_relax.py:76-87 both read the previous
//   iterate); the grid sweep's off-lattice stage is two launches, its
//   shift-plane edges then its straggler edges on the result
//   (grid_sweep.py:212-224). Sets *flag when any out < d.
//   Bound: bytes. Each step must read d and write out (8 B a cell) and
//   gathers one neighbour row segment per edge and column (4 B), which
//   are L2 hits only while the column tile's rows fit in L2. Design: a
//   warp is one node's 32 consecutive columns (one 128 B segment a
//   gather), blocks are ordered column tile by column tile so the blocks
//   in flight share one 32-column tile of d (N x 128 B: 34 MB at 264k
//   nodes, 8 MB at 65k), and the edge lists are read once per warp.
//
// first_moves (K2): ops/bellman_ford.py::first_move_from_dist. For each
//   (x, b) the first out-slot, in ascending slot order with a strict <,
//   minimising min(w + d[nbr, b], INF); -1 when that minimum is INF, at
//   the target's own node and for pad targets (t < 0). The CSR keeps the
//   ELL slot order (slot = e - row_ptr[x]). Reads [N, B], writes int8
//   fm[B, N]: a block computes a 64-node x 32-column tile into shared
//   memory, then writes it out row by row so the byte stores coalesce.
//   Offsets are int64 (a whole-index table is past 2^31 bytes).
//   Bound: bytes (d read once, neighbour segments, fm written once).
//
// grid_sweep_cycle (K3): one cycle of the fast sweeping method on the
//   H x W lattice (ops/grid_sweep.py::cycle without off_lattice): four
//   quadrant sweeps (+,+), (-,-), (+,-), (-,+); a sweep visits the
//   anti-diagonals in order, each cell reading its two in-quadrant
//   neighbours on the previous diagonal, already updated (Gauss-Seidel
//   across diagonals, Jacobi within one), in place. A diagonal depends on
//   the one before it, so one block owns a group of `cols` batch columns
//   and runs the whole chain, a barrier between diagonals; the blocks are
//   independent. Bound: the chain of 4 (H + W - 1) dependent diagonal
//   steps a cycle, each a round trip to L2, far above the bytes (one
//   read and at most one write of d a sweep). Sets *flag when any cell
//   falls.
//
// INF = 1e9, so w + d <= 2e9 fits int32 for every w, d <= INF.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1000000000;

// K1 / K2 shape: 8 warps a block, a warp = 32 consecutive columns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// K1: nodes a warp relaxes
constexpr int kRelaxNodesPerWarp = 4;
// K2: nodes a warp extracts; tile = kWarps * kFmNodesPerWarp nodes
constexpr int kFmNodesPerWarp = 8;
constexpr int kFmTileNodes = kWarps * kFmNodesPerWarp;
// K3 threads a block
constexpr int kSweepThreads = 512;

__global__ void __launch_bounds__(kThreads)
relax_jacobi_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const int* __restrict__ wt,
                    const int* __restrict__ d, int* __restrict__ out,
                    int* __restrict__ flag, long long n, int b,
                    int node_blocks) {
  // column tile major: consecutive blocks share a column tile
  const int tile = blockIdx.x / node_blocks;
  const long long node_block = blockIdx.x % node_blocks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = tile * 32 + lane;
  const bool live = c < b;
  bool fell = false;
  const long long x0 =
      (node_block * kWarps + warp) * static_cast<long long>(kRelaxNodesPerWarp);
#pragma unroll
  for (int i = 0; i < kRelaxNodesPerWarp; ++i) {
    const long long x = x0 + i;
    if (x >= n) break;
    const int e0 = __ldg(row_ptr + x);
    const int e1 = __ldg(row_ptr + x + 1);
    if (live) {
      const long long at = x * b + c;
      const int cur = __ldg(d + at);
      int acc = cur;
      for (int e = e0; e < e1; ++e) {
        const int v = __ldg(col + e);
        const int via = __ldg(wt + e) + __ldg(d + static_cast<long long>(v) * b + c);
        acc = min(acc, min(via, kInf));
      }
      out[at] = acc;
      fell |= acc < cur;
    }
  }
  if (__syncthreads_or(fell) && threadIdx.x == 0) *flag = 1;
}

__global__ void __launch_bounds__(kThreads)
first_moves_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col, const int* __restrict__ wt,
                   const int* __restrict__ d, const int* __restrict__ targets,
                   int8_t* __restrict__ fm, long long n, int b, int rows,
                   int node_tiles) {
  __shared__ int8_t tile[32][kFmTileNodes + 4];
  const int col_tile = blockIdx.x / node_tiles;
  const long long x0 =
      static_cast<long long>(blockIdx.x % node_tiles) * kFmTileNodes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = col_tile * 32;
  const int c = c0 + lane;
  const int t = c < b ? __ldg(targets + c) : -1;
#pragma unroll
  for (int i = 0; i < kFmNodesPerWarp; ++i) {
    const int xo = warp * kFmNodesPerWarp + i;
    const long long x = x0 + xo;
    int8_t slot = -1;
    if (x < n && t >= 0 && x != t) {
      const int e0 = __ldg(row_ptr + x);
      const int e1 = __ldg(row_ptr + x + 1);
      int best = kInf;
      int arg = 0;
      for (int e = e0; e < e1; ++e) {
        const int v = __ldg(col + e);
        const int via = min(
            __ldg(wt + e) + __ldg(d + static_cast<long long>(v) * b + c), kInf);
        if (via < best) {
          best = via;
          arg = e - e0;
        }
      }
      slot = best >= kInf ? -1 : static_cast<int8_t>(arg);
    }
    tile[lane][xo] = slot;
  }
  __syncthreads();
  // write the tile out row by row: a warp stores 32 consecutive bytes
  for (int k = threadIdx.x; k < 32 * kFmTileNodes; k += kThreads) {
    const int r = k / kFmTileNodes;
    const int xo = k % kFmTileNodes;
    const long long x = x0 + xo;
    if (c0 + r < rows && x < n) {
      fm[static_cast<long long>(c0 + r) * n + x] = tile[r][xo];
    }
  }
}

__global__ void __launch_bounds__(kSweepThreads)
grid_sweep_kernel(const int* __restrict__ wl, const int* __restrict__ wr,
                  const int* __restrict__ wd, const int* __restrict__ wu,
                  int* d, int* __restrict__ flag, int h, int w, int b,
                  int cols) {
  const int lane_c = threadIdx.x % cols;
  const int ylane = threadIdx.x / cols;
  const int ylanes = blockDim.x / cols;
  const int c = blockIdx.x * cols + lane_c;
  const bool live = c < b && ylane < ylanes;
  bool fell = false;
  const int diagonals = h + w - 1;
  for (int q = 0; q < 4; ++q) {
    // (sx, sy) = (+,+), (-,-), (+,-), (-,+): a cell's in-quadrant
    // neighbours are (x - sx, y) and (x, y - sy)
    const int sx = (q == 0 || q == 2) ? 1 : -1;
    const int sy = (q == 0 || q == 3) ? 1 : -1;
    const int* __restrict__ w_same = sx > 0 ? wl : wr;
    const int* __restrict__ w_cross = sy > 0 ? wd : wu;
    const long long step_same = static_cast<long long>(sx) * b;
    const long long step_cross = static_cast<long long>(sy) * w * b;
    for (int j = 0; j < diagonals; ++j) {
      if (live) {
        // quadrant-local coordinates X + Y = j
        const int ylo = j - (w - 1) > 0 ? j - (w - 1) : 0;
        const int yhi = j < h - 1 ? j : h - 1;
        for (int yy = ylo + ylane; yy <= yhi; yy += ylanes) {
          const int xx = j - yy;
          const int x = sx > 0 ? xx : w - 1 - xx;
          const int y = sy > 0 ? yy : h - 1 - yy;
          const long long u = static_cast<long long>(y) * w + x;
          int* cell = d + u * b + c;
          const int cur = *cell;
          int best = cur;
          if (xx >= 1) best = min(best, __ldg(w_same + u) + *(cell - step_same));
          if (yy >= 1) best = min(best, __ldg(w_cross + u) + *(cell - step_cross));
          if (best < cur) {
            *cell = best;
            fell = true;
          }
        }
      }
      __syncthreads();
    }
  }
  if (__syncthreads_or(fell) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` without
// synchronising and returns cudaGetLastError() so a refused launch is
// seen. CSR arrays are int32: row_ptr [n + 1], col and wt [m].

extern "C" int relax_jacobi(const void* row_ptr, const void* col,
                            const void* wt, const void* d, void* out,
                            void* flag, long long n, int b, void* stream) {
  if (n > 0 && b > 0) {
    const long long per_block = static_cast<long long>(kWarps) * kRelaxNodesPerWarp;
    const long long node_blocks = (n + per_block - 1) / per_block;
    const long long blocks = node_blocks * ((b + 31) / 32);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    relax_jacobi_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const int*>(wt), static_cast<const int*>(d),
        static_cast<int*>(out), static_cast<int*>(flag), n, b,
        static_cast<int>(node_blocks));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int first_moves(const void* row_ptr, const void* col,
                           const void* wt, const void* d, const void* targets,
                           void* fm, long long n, int b, int rows,
                           void* stream) {
  if (n > 0 && rows > 0) {
    const long long node_tiles = (n + kFmTileNodes - 1) / kFmTileNodes;
    const long long blocks = node_tiles * ((rows + 31) / 32);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    first_moves_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(row_ptr), static_cast<const int*>(col),
        static_cast<const int*>(wt), static_cast<const int*>(d),
        static_cast<const int*>(targets), static_cast<int8_t*>(fm), n, b,
        rows, static_cast<int>(node_tiles));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_sweep_cycle(const void* wl, const void* wr,
                                const void* wd, const void* wu, void* d,
                                void* flag, int h, int w, int b, int cols,
                                void* stream) {
  if (cols < 1 || cols > kSweepThreads || kSweepThreads % cols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h > 0 && w > 0 && b > 0) {
    const int blocks = (b + cols - 1) / cols;
    grid_sweep_kernel<<<blocks, kSweepThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(wl), static_cast<const int*>(wr),
        static_cast<const int*>(wd), static_cast<const int*>(wu),
        static_cast<int*>(d), static_cast<int*>(flag), h, w, b, cols);
  }
  return static_cast<int>(cudaGetLastError());
}
