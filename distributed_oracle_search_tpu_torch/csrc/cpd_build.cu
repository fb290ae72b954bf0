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
//   gathers one neighbour row segment per edge and column, which are L2
//   hits only while the rows the blocks in flight touch stay resident.
//   Design: a warp owns 4 nodes x one column group of 32 * V columns
//   (V = 1, 2 or 4 consecutive columns a lane, one int/int2/int4 load a
//   row segment), so the edge list and index math are paid once per V
//   columns. It takes its nodes' ids and edge ranges in one load, then
//   their edge lists laid end to end 32 edges at a time in one load
//   (lane j takes the j-th edge), broadcasts each edge with __shfl_sync,
//   and issues up to kUnroll neighbour-segment loads before it folds any
//   of them, so a node costs one L2 round trip, not a chain of two per
//   edge. The nodes are visited in the CSR's visit order (breadth first
//   over the graph, `order` / `span`; by id without it), so the warps in
//   flight gather from a band of rows a few hops wide that stays in L2
//   whatever the node ids. Blocks are ordered column group by column
//   group, and out is written with evict-first stores.
//   Settled tiles (optional): a changed map, one byte per (column group,
//   node), [T, N]. chg_prev says where step i-1 lowered a value; the step
//   skips (node, group) when neither the node nor any out-neighbour
//   changed there (then min(w + d[v]) is the step before's, which the
//   node already holds, and with two buffers out still holds it, since
//   the node did not change either), gathers only the out-neighbours
//   that changed (an unchanged w + d[v] is at least the node's value
//   already), and writes chg_cur for every node. Without chg_prev every
//   pair is relaxed over every edge. `active`, when given, counts the
//   relaxed (node, group) pairs into kActiveSlots counters 128 B apart,
//   one atomic a block, so the counts do not serialise on one address.
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

// K1 / K2 shape: 8 warps a block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// K1: nodes a warp relaxes (each lane holds one of their row_ptr entries)
constexpr int kRelaxNodesPerWarp = 4;
// K1: counters of active (node, group) pairs, 128 B apart
constexpr int kActiveSlots = 64;
constexpr int kActiveStride = 16;
// K2: nodes a warp extracts; tile = kWarps * kFmNodesPerWarp nodes
constexpr int kFmNodesPerWarp = 8;
constexpr int kFmTileNodes = kWarps * kFmNodesPerWarp;
// K3 threads a block
constexpr int kSweepThreads = 512;

// V consecutive int32 columns at p (4 V-byte aligned): one load
template <int V>
__device__ __forceinline__ void load_cols(const int* __restrict__ p,
                                          int (&v)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (V == 2) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

// ... and one evict-first store
template <int V>
__device__ __forceinline__ void store_cols(int* p, const int (&v)[V]) {
  if constexpr (V == 4) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
  } else if constexpr (V == 2) {
    __stcs(reinterpret_cast<int2*>(p), make_int2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// p[i] for a run-time i, without indexing a register array (which would
// put it in local memory)
__device__ __forceinline__ int pick(const int (&p)[kRelaxNodesPerWarp + 1],
                                    int i) {
  int v = p[0];
#pragma unroll
  for (int j = 1; j <= kRelaxNodesPerWarp; ++j) v = i == j ? p[j] : v;
  return v;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
relax_jacobi_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ col, const int* __restrict__ wt,
                    const int* __restrict__ order,
                    const int2* __restrict__ span,
                    const int* __restrict__ d, int* __restrict__ out,
                    int* __restrict__ flag,
                    const uint8_t* __restrict__ chg_prev,
                    uint8_t* __restrict__ chg_cur,
                    unsigned long long* __restrict__ active, long long n,
                    int b, int node_blocks) {
  // segment loads a warp issues before it folds them
  constexpr int kUnroll = V == 4 ? 4 : 8;
  // column group major: consecutive blocks share a group
  const int group = blockIdx.x / node_blocks;
  const long long node_block =
      blockIdx.x - static_cast<long long>(group) * node_blocks;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = (group * 32 + lane) * V;
  const bool live = c < b;  // b % V == 0: a lane's V columns are all live
  // the warp's nodes: visit slots s0 .. s0 + np - 1
  const long long s0 =
      (node_block * kWarps + warp) * static_cast<long long>(kRelaxNodesPerWarp);
  const int np = s0 >= n ? 0
      : static_cast<int>(min(n - s0, static_cast<long long>(kRelaxNodesPerWarp)));
  const uint8_t* __restrict__ prev = chg_prev ? chg_prev + group * n : nullptr;
  // lane j < np: node j (its id, its edge range)
  long long xj = 0;
  int ej0 = 0, ej1 = 0;
  if (lane < np) {
    const long long s = s0 + lane;
    if (order) {
      xj = __ldg(order + s);
      const int2 r = __ldg(span + s);
      ej0 = r.x;
      ej1 = r.y;
    } else {
      xj = s;
      ej0 = __ldg(row_ptr + s);
      ej1 = __ldg(row_ptr + s + 1);
    }
  }
  // bit j: node j changed in the step before
  const unsigned own_chg = __ballot_sync(
      kFull, lane < np && (prev == nullptr || __ldg(prev + xj) != 0));
  // the nodes' edges laid end to end: node j's are q in [p[j], p[j + 1])
  int p[kRelaxNodesPerWarp + 1];
  p[0] = 0;
#pragma unroll
  for (int j = 0; j < kRelaxNodesPerWarp; ++j) {
    p[j + 1] = p[j] + __shfl_sync(kFull, ej1 - ej0, j);
  }
  const int total = p[kRelaxNodesPerWarp];
  // the chunk q in [cb, cb + 32), one a lane: destination, weight, and
  // (bit j of ebits) whether q = cb + j's destination changed
  int cb = 0x7fffffff;
  int ecol = 0, ewt = 0;
  unsigned ebits = 0;
  auto load_chunk = [&](int at) {
    cb = at;
    const int q = at + lane;
    int i = 0;
#pragma unroll
    for (int j = 1; j < kRelaxNodesPerWarp; ++j) i += q >= p[j];
    const int e = __shfl_sync(kFull, ej0, i) + q - pick(p, i);
    bool ch = false;
    ecol = 0;
    ewt = 0;
    if (q < total) {
      ecol = __ldg(col + e);
      ewt = __ldg(wt + e);
      if (prev) ch = __ldg(prev + ecol) != 0;
    }
    ebits = __ballot_sync(kFull, ch);
  };
  unsigned act_nodes = 0, fell_nodes = 0;
  for (int i = 0; i < np; ++i) {
    const long long x = __shfl_sync(kFull, xj, i);
    const int q0 = pick(p, i), q1 = pick(p, i + 1);
    if (q0 < cb || q1 - cb > 32) load_chunk(q0);
    // active: the node changed in the step before, or an out-neighbour did
    bool act = true;
    if (prev) {
      const int lo = q0 - cb;
      const int hi = min(q1 - cb, 32);
      const unsigned bits =
          hi > lo ? (hi - lo == 32 ? kFull : ((1u << (hi - lo)) - 1u) << lo)
                  : 0u;
      act = ((own_chg >> i) & 1u) || (ebits & bits);
      // a node past 32 out-edges: the rest of its list, 32 at a time
      const int e0 = __shfl_sync(kFull, ej0, i) - q0;
      for (int k = cb + 32; !act && k < q1; k += 32) {
        const int q = k + lane;
        act = __any_sync(kFull, q < q1 && __ldg(prev + __ldg(col + e0 + q)) != 0);
      }
    }
    if (!act) continue;  // out already holds this node's value
    act_nodes |= 1u << i;
    int own[V], acc[V];
    if (live) {
      load_cols<V>(d + x * b + c, own);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) own[j] = kInf;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = own[j];
    for (int k = q0; k < q1; k += kUnroll) {
      // past 32 out-edges (then cb == q0 and kUnroll divides 32, so a
      // round never straddles two chunks)
      if (k - cb >= 32) load_chunk(k);
      int val[kUnroll][V];
      int wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int src = (k + u - cb) & 31;
        const int v = __shfl_sync(kFull, ecol, src);
        const int w = __shfl_sync(kFull, ewt, src);
        wv[u] = 0;
#pragma unroll
        for (int j = 0; j < V; ++j) val[u][j] = kInf;
        // with a map, only the neighbours that changed: an unchanged
        // w + d[v] is at least the node's value already (the step before
        // folded it in)
        if (live && k + u < q1 && (prev == nullptr || ((ebits >> src) & 1u))) {
          wv[u] = w;
          load_cols<V>(d + static_cast<long long>(v) * b + c, val[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          acc[j] = min(acc[j], min(val[u][j] + wv[u], kInf));
        }
      }
    }
    // an active node is written even when nothing fell: the second
    // buffer holds the iterate before the one it just had
    bool fell = false;
    if (live) {
      store_cols<V>(out + x * b + c, acc);
#pragma unroll
      for (int j = 0; j < V; ++j) fell |= acc[j] < own[j];
    }
    if (__any_sync(kFull, fell)) fell_nodes |= 1u << i;
  }
  // lane j < np writes node j's changed byte, skipped nodes' too
  if (chg_cur && lane < np) {
    chg_cur[group * n + xj] = static_cast<uint8_t>((fell_nodes >> lane) & 1u);
  }
  const int block_fell =
      __syncthreads_count(lane < np && ((fell_nodes >> lane) & 1u));
  const int block_active =
      __syncthreads_count(lane < np && ((act_nodes >> lane) & 1u));
  if (threadIdx.x == 0) {
    if (block_fell && *flag == 0) *flag = 1;
    if (active && block_active) {
      atomicAdd(active + (blockIdx.x % kActiveSlots) * kActiveStride,
                static_cast<unsigned long long>(block_active));
    }
  }
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

// relax_jacobi: vec (columns a lane: 1, 2 or 4) divides b; a column
// group is 32 * vec columns. order (int32 [n], a permutation of the
// nodes) and span (int32 [n, 2], the out-edge range of node order[s]) set
// the visit order; null visits the nodes by id. chg_prev, chg_cur (uint8
// [T, n], T = ceil(b / (32 vec))) and active (uint64 [kActiveSlots *
// kActiveStride]) may each be null; d and out are 4 vec-byte aligned.
extern "C" int relax_jacobi(const void* row_ptr, const void* col,
                            const void* wt, const void* order,
                            const void* span, const void* d, void* out,
                            void* flag, const void* chg_prev, void* chg_cur,
                            void* active, long long n, int b, int vec,
                            void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || b % vec ||
      (order == nullptr) != (span == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && b > 0) {
    const long long per_block = static_cast<long long>(kWarps) * kRelaxNodesPerWarp;
    const long long node_blocks = (n + per_block - 1) / per_block;
    const long long cols = 32LL * vec;
    const long long blocks = node_blocks * ((b + cols - 1) / cols);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const auto grid = static_cast<unsigned>(blocks);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto rp = static_cast<const int*>(row_ptr);
    const auto cl = static_cast<const int*>(col);
    const auto w = static_cast<const int*>(wt);
    const auto ord = static_cast<const int*>(order);
    const auto sp = static_cast<const int2*>(span);
    const auto din = static_cast<const int*>(d);
    const auto dout = static_cast<int*>(out);
    const auto f = static_cast<int*>(flag);
    const auto prev = static_cast<const uint8_t*>(chg_prev);
    const auto cur = static_cast<uint8_t*>(chg_cur);
    const auto act = static_cast<unsigned long long*>(active);
    const auto nb = static_cast<int>(node_blocks);
    if (vec == 4) {
      relax_jacobi_kernel<4><<<grid, kThreads, 0, s>>>(
          rp, cl, w, ord, sp, din, dout, f, prev, cur, act, n, b, nb);
    } else if (vec == 2) {
      relax_jacobi_kernel<2><<<grid, kThreads, 0, s>>>(
          rp, cl, w, ord, sp, din, dout, f, prev, cur, act, n, b, nb);
    } else {
      relax_jacobi_kernel<1><<<grid, kThreads, 0, s>>>(
          rp, cl, w, ord, sp, din, dout, f, prev, cur, act, n, b, nb);
    }
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
