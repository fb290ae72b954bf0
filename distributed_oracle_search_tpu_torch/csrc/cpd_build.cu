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
//   fm[B, N]. Offsets are int64 (a whole-index table is past 2^31 bytes).
//   Bound: bytes (d read once, fm written once; the neighbour segments it
//   gathers, M x B x 4 bytes, are L2 hits only while the rows that the
//   warps in flight touch stay resident).
//   Design (K1's): a warp owns 8 nodes x 32 V columns (V = 1, 2 or 4 a
//   lane, one load a row segment); it takes its nodes' edge ranges in
//   one load, their edge lists laid end to end in one load,
//   broadcasts each edge with __shfl_sync and issues up to kUnroll
//   neighbour-segment loads before it folds them, in slot order. Blocks
//   are column group major. Nodes are taken by id: a block extracts 64
//   consecutive nodes into a shared-memory tile and writes it out row by
//   row, so the byte stores coalesce. (Taking them in the CSR's visit
//   order, through a slot-major scratch and a second launch that writes
//   the rows, was measured slower on the grid and campaign graphs.)
//
// grid_sweep_cycle (K3): cycles of the fast sweeping method on the
//   H x W lattice (ops/grid_sweep.py::cycle without off_lattice): four
//   quadrant sweeps (+,+), (-,-), (+,-), (-,+) in place. A cell's new
//   value is min(old, w_cross + new(x, y - sy), w_same + new(x - sx, y))
//   (each term saturated at INF): it depends on its own old value and on
//   its two in-quadrant neighbours' new values only, so every order that
//   reaches a cell after those two gives the same sweep, bit for bit. The
//   kernel takes the rows in sy order and runs a min-plus scan along each
//   row in sx order: the cell maps v -> min(a, w + v), a = min(old,
//   w_cross + new above), compose to maps of the same form with the
//   weight sum saturated at INF (exact: weights and values are <= INF, so
//   a term past INF never wins, and INF + INF fits int32).
//   Bound: bytes. Each sweep must read d and write what fell; d (1.06 MB
//   a column on the 514 x 514 grid) does not fit on chip, so four sweeps
//   that stream it are the realistic floor, 4x the one-read-one-write
//   figure. The chain is long: 4 H rows a cycle, each depending on the
//   one before.
//   Design: the launch copies d into a column-major [B, H, Wp] buffer
//   (Wp = W rounded up to 4; a tiled transpose each way, about 0.37 ms
//   each at B = 512 on the 514 x 514 grid), so a column's row is one
//   16-byte aligned run. A block owns `cols` columns (1 by default: 512
//   blocks, four resident an SM, four independent chains), one warp a
//   column (or `row_warps` warps splitting a row wider than 32 x 33
//   cells), L cells a lane (L odd: the lanes' shared-memory reads hit
//   distinct banks). A row wider than the shared memory holds (past 2,552
//   cells at one column a block) is swept in pieces: all the rows of one
//   piece, then the next in sx order; a piece's first cell takes its
//   same-row neighbour's new value from the piece before, read back with
//   the row (the same sweep: that neighbour is final by then). The row
//   the chain depends on stays in registers (each lane keeps its own L
//   cells of the row above). Lanes 0 .. cols + 1 of warp 0 copy a row's
//   columns and its two weight rows with one TMA bulk copy each, up to
//   kSweepMaxStages - 2 rows ahead of the front, into a shared-memory ring
//   whose stages complete on mbarriers, so device memory is off the
//   dependency chain: a row costs a wait, a lane-local pass, a 5-step
//   shuffle scan and a second lane-local pass (stage indices and phases
//   are counted, not divided out). New values go to a separate pair of
//   rows in shared memory, and the columns where a cell fell are stored
//   whole, 16 bytes a thread, while the next row computes (a proxy fence
//   a piece orders them before the next piece's bulk reads); nothing
//   reads them back within the piece. With
//   max_cycles > 1 (a lattice with no off-lattice edges) a block runs its
//   own cycles until one lowers none of its columns or the cap: a
//   converged column is a fixed point of a cycle, so its iterate at a cut
//   is the batch loop's, and *cycles receives the largest count, which is
//   the batch loop's. Sets *flag when any cell falls.
//   Measured (NVIDIA H100 80GB HBM3, 700 W): a row costs about 1,650
//   cycles of one warp's chain, so a cycle at B = 512 takes about 3.3 ms,
//   2.6x the four-sweep floor; tried and slower: a producer warp for the
//   copies and stores, and the two sweeps of a row order fused into one
//   pass over the rows (register pressure).
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
// a tile row's bytes: 17 words, so lanes on consecutive rows hit distinct
// banks
constexpr int kFmTileStride = kFmTileNodes + 4;
// K3: warps a block (one a column, or a few splitting a wide row)
constexpr int kSweepMaxWarps = 8;

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
template <int K>
__device__ __forceinline__ int pick(const int (&p)[K], int i) {
  int v = p[0];
#pragma unroll
  for (int j = 1; j < K; ++j) v = i == j ? p[j] : v;
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

// K2's write-out: the shared-memory tile (column r of the group in row
// (r % V) * 32 + r / V, node i at byte i) into fm rows group * 32 V + r,
// nodes x0 .. x0 + kFmTileNodes - 1, one 4-byte store a thread where fm
// allows it
template <int V>
__device__ __forceinline__ void write_tile(const int8_t* tile, int8_t* fm,
                                           int group, long long x0,
                                           long long n, int rows) {
  constexpr int kCols = 32 * V;
  constexpr int kWords = kFmTileNodes / 4;
  const bool word = n % 4 == 0 && (reinterpret_cast<uintptr_t>(fm) & 3) == 0;
  for (int k = threadIdx.x; k < kCols * kWords; k += kThreads) {
    const int r = k / kWords;
    const int q = k % kWords;
    const int cr = group * kCols + r;
    const long long x = x0 + 4 * q;
    if (cr >= rows || x >= n) continue;
    const int8_t* src = tile + ((r % V) * 32 + r / V) * kFmTileStride + 4 * q;
    int8_t* dst = fm + static_cast<long long>(cr) * n + x;
    if (word && x + 4 <= n) {
      *reinterpret_cast<int*>(dst) = *reinterpret_cast<const int*>(src);
    } else {
      for (int e = 0; e < 4 && x + e < n; ++e) dst[e] = src[e];
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
first_moves_kernel(const int* __restrict__ row_ptr,
                   const int* __restrict__ col, const int* __restrict__ wt,
                   const int* __restrict__ d, const int* __restrict__ targets,
                   int8_t* __restrict__ fm, long long n, int b, int rows,
                   int node_tiles) {
  // segment loads a warp issues before it folds them
  constexpr int kUnroll = V == 4 ? 4 : 8;
  __shared__ __align__(16) int8_t tile[32 * V * kFmTileStride];
  // column group major: consecutive blocks share a group
  const int group = blockIdx.x / node_tiles;
  const long long s_tile =
      static_cast<long long>(blockIdx.x - group * node_tiles) * kFmTileNodes;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = (group * 32 + lane) * V;
  const bool live = c < rows;  // rows <= b, b % V == 0
  int t[V];
  if (c < b) {
    load_cols<V>(targets + c, t);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = -1;
  }
  // the warp's nodes: s0 .. s0 + np - 1
  const long long s0 = s_tile + warp * kFmNodesPerWarp;
  const int np = s0 >= n ? 0
      : static_cast<int>(min(n - s0, static_cast<long long>(kFmNodesPerWarp)));
  // lane j < np: node j's edge range
  int ej0 = 0, ej1 = 0;
  if (lane < np) {
    ej0 = __ldg(row_ptr + s0 + lane);
    ej1 = __ldg(row_ptr + s0 + lane + 1);
  }
  // the nodes' edges laid end to end: node j's are q in [p[j], p[j + 1])
  int p[kFmNodesPerWarp + 1];
  p[0] = 0;
#pragma unroll
  for (int j = 0; j < kFmNodesPerWarp; ++j) {
    p[j + 1] = p[j] + __shfl_sync(kFull, ej1 - ej0, j);
  }
  const int total = p[kFmNodesPerWarp];
  // the chunk q in [cb, cb + 32), one a lane: destination and weight
  int cb = 0x7fffffff;
  int ecol = 0, ewt = 0;
  auto load_chunk = [&](int at) {
    cb = at;
    const int q = at + lane;
    int i = 0;
#pragma unroll
    for (int j = 1; j < kFmNodesPerWarp; ++j) i += q >= p[j];
    const int e = __shfl_sync(kFull, ej0, i) + q - pick(p, i);
    ecol = 0;
    ewt = 0;
    if (q < total) {
      ecol = __ldg(col + e);
      ewt = __ldg(wt + e);
    }
  };
  for (int i = 0; i < np; ++i) {
    const long long x = s0 + i;
    const int q0 = pick(p, i), q1 = pick(p, i + 1);
    if (q0 < cb || q1 - cb > 32) load_chunk(q0);
    int best[V], arg[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      best[j] = kInf;
      arg[j] = 0;
    }
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
        if (live && k + u < q1) {
          wv[u] = w;
          load_cols<V>(d + static_cast<long long>(v) * b + c, val[u]);
        }
      }
      // fold in slot order: the first minimal slot wins
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int via = min(val[u][j] + wv[u], kInf);
          if (via < best[j]) {
            best[j] = via;
            arg[j] = k + u - q0;
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      tile[(j * 32 + lane) * kFmTileStride + warp * kFmNodesPerWarp + i] =
          (best[j] >= kInf || t[j] < 0 || x == t[j])
              ? static_cast<int8_t>(-1) : static_cast<int8_t>(arg[j]);
    }
  }
  __syncthreads();
  write_tile<V>(tile, fm, group, s_tile, n, rows);
}

// K3 works on a column-major copy of d, [B, H, Wp], its rows padded to
// Wp = W rounded up to 4 ints, so every row starts on 16 bytes. to_cols:
// dt[c, y, x] = d[y * W + x, c]; else the copy back. A block moves 32
// nodes x 32 columns through shared memory, so both sides are read and
// written in whole lines.
__global__ void __launch_bounds__(kThreads)
transpose_kernel(int* __restrict__ d, int* __restrict__ dt, long long n,
                 int b, int w, int wp, long long hwp, int to_cols,
                 long long col_tiles) {
  __shared__ int tile[32][33];
  const long long u0 = static_cast<long long>(blockIdx.x / col_tiles) * 32;
  const long long c0 = static_cast<long long>(blockIdx.x % col_tiles) * 32;
  const int tx = threadIdx.x & 31;
  // node u's place in a padded column
  auto padded = [&](long long u) {
    const int v = static_cast<int>(u);  // n < 2^31
    return static_cast<long long>(v / w) * wp + v % w;
  };
  for (int ty = threadIdx.x >> 5; ty < 32; ty += kWarps) {
    if (to_cols) {
      if (u0 + ty < n && c0 + tx < b) tile[ty][tx] = d[(u0 + ty) * b + c0 + tx];
    } else if (c0 + ty < b && u0 + tx < n) {
      tile[tx][ty] = dt[(c0 + ty) * hwp + padded(u0 + tx)];
    }
  }
  __syncthreads();
  for (int ty = threadIdx.x >> 5; ty < 32; ty += kWarps) {
    if (to_cols) {
      if (c0 + ty < b && u0 + tx < n) {
        dt[(c0 + ty) * hwp + padded(u0 + tx)] = tile[tx][ty];
      }
    } else if (u0 + ty < n && c0 + tx < b) {
      d[(u0 + ty) * b + c0 + tx] = tile[ty][tx];
    }
  }
}

// K3 loads kSweepHalo ints past each end of a piece of a row, so the cell
// next to the piece (its new value, from the piece before in the sweep's
// order) comes with it and every copy stays 16-byte aligned
constexpr int kSweepHalo = 4;
// cells a K3 lane may scan (L), narrowest first; odd, so the lanes'
// shared-memory reads hit distinct banks
constexpr int kSweepSegs[] = {3, 5, 9, 17, 33};
constexpr int kSweepMaxSeg = 33;
// shared memory a K3 block may take (two blocks fit an SM), and its most
// ring stages (rows up to kSweepMaxStages - 2 in flight)
constexpr int kSweepSmemBytes = 112 * 1024;
constexpr int kSweepMaxStages = 8;

// K3's ring stage for a block's `cols` columns: each column's piece of a
// row, then the piece's same-row and cross-row weights, each with both
// halos
__host__ __device__ __forceinline__ int sweep_stage_ints(int piece,
                                                         int cols) {
  return (cols + 2) * (piece + 2 * kSweepHalo);
}

// where K3's mbarriers start (ints into its shared memory, 8-byte
// aligned): after the ring, two rows of new values, a map (2 ints) a
// warp and a row-fell flag a stage and column
__host__ __device__ __forceinline__ int sweep_bars_at(int piece, int cols,
                                                      int warps,
                                                      int stages) {
  return (stages * sweep_stage_ints(piece, cols) + 2 * cols * piece +
          2 * warps + stages * cols + 1) & ~1;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// the one arrival of a stage's phase, with the bytes its copies bring
__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for phase `parity` of bar to complete. A copy that never lands
// traps instead of hanging the card; a trap is a sticky error that
// poisons the whole CUDA context, so every later call in the process
// fails too and the process must restart.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spins > (1u << 24)) __trap();
  }
}

// TMA bulk copies (16-byte multiples, 16-byte aligned both sides)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// order this thread's device-memory writes before later bulk copies
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A block: `cols` columns x `row_warps` warps a column (blockDim.x = 32 x
// cols x row_warps); warp k sweeps column k % cols, lanes (k / cols) * 32
// .. + 31 of a piece's row, L cells a lane. A sweep takes the padded row's
// pieces of `piece` cells in sx order, each over all its rows in sy
// order. wpad: the weights wl, wr, wd, wu as [4, H, Wp].
template <int L>
__global__ void __launch_bounds__(kSweepMaxWarps * 32)
grid_sweep_kernel(const int* __restrict__ wpad, int* __restrict__ dt,
                  int* __restrict__ flag, int* __restrict__ cycles, int h,
                  int w, int wp, int piece, int cols, int row_warps,
                  int stages, int max_cycles) {
  extern __shared__ __align__(16) int ring[];
  const long long hwp = static_cast<long long>(h) * wp;
  const int span = piece + 2 * kSweepHalo;  // a ring row's ints
  const int stage = sweep_stage_ints(piece, cols);
  const int warps = blockDim.x >> 5;
  const int pieces = (wp + piece - 1) / piece;
  // two rows of new values (the row being computed, the row being
  // stored); per warp: its inclusive map over its part of the row (A, W);
  // per stage and column: whether a cell of that row fell; per stage: the
  // mbarrier its copies complete
  int* const out = ring + stages * stage;
  int* const tot = out + 2 * cols * piece;
  int* const row_fell = tot + 2 * warps;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(
      ring + sweep_bars_at(piece, cols, warps, stages));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int j = warp % cols;
  const int part = warp / cols;
  // the lane's cells: quadrant-local columns X0 .. X0 + L - 1 of a piece
  const int X0 = (part * 32 + lane) * L;
  // this block's first column: column c's row y at base + c * hwp + y * wp
  int* const base = dt + static_cast<long long>(blockIdx.x) * cols * hwp;
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) bar_init(bars + k);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the stages of the next row to fetch and to consume, the phase each
  // stage completes next (bit k), and the parity of the rows consumed
  int k_fetch = 0, k_cur = 0;
  unsigned phases = 0, odd = 0;
  auto next = [&](int k) { return k + 1 == stages ? 0 : k + 1; };
  bool fell_any = false;
  int cyc = 0;
  while (cyc < max_cycles) {
    bool fell = false;
    for (int q = 0; q < 4; ++q) {
      // (sx, sy) = (+,+), (-,-), (+,-), (-,+): a cell's in-quadrant
      // neighbours are (x - sx, y) and (x, y - sy)
      const int sx = (q == 0 || q == 2) ? 1 : -1;
      const int sy = (q == 0 || q == 3) ? 1 : -1;
      const int* const w_same = wpad + (sx > 0 ? 0 : 1) * hwp;
      const int* const w_cross = wpad + (sy > 0 ? 2 : 3) * hwp;
      auto row_of = [&](int yy) {
        return static_cast<long long>(sy > 0 ? yy : h - 1 - yy) * wp;
      };
      for (int pi = 0; pi < pieces; ++pi) {
        // the piece's cells a .. e - 1 of each row; a ring row holds
        // cells lo .. hi - 1 (the halos included), cell x at x - a +
        // kSweepHalo
        const int a = (sx > 0 ? pi : pieces - 1 - pi) * piece;
        const int e = min(a + piece, w);
        const int cells = e - a;
        const int lo = max(a - kSweepHalo, 0);
        const int hi = min(a + piece + kSweepHalo, wp);
        const unsigned bytes = 4u * (hi - lo);
        // the cell before the piece in sx order (piece-relative), new
        // since the piece before was swept; none before the first
        const bool has_edge = sx > 0 ? a > 0 : e < w;
        const int edge = sx > 0 ? -1 : cells;
        // row yy of the piece into the next stage: lanes 0 .. cols + 1
        // of warp 0 each issue the bulk copy of one row (a column, the
        // same-row weights, the cross-row weights) in one instruction
        auto fetch = [&](int yy) {
          if (yy >= h) return;
          const int k = k_fetch;
          if (warp == 0) {
            const long long row = row_of(yy) + lo;
            if (lane == 0) bar_expect(bars + k, (cols + 2) * bytes);
            if (lane < cols) row_fell[k * cols + lane] = 0;
            __syncwarp();
            if (lane < cols + 2) {
              const int* src = lane < cols ? base + lane * hwp + row
                  : (lane == cols ? w_same : w_cross) + row;
              bulk_load(ring + k * stage + lane * span + lo - a + kSweepHalo,
                        src, bytes, bars + k);
            }
          }
          k_fetch = next(k_fetch);
        };
        // the columns of row yy (stage k, new values in out[o]) where a
        // cell fell, back to device memory, the whole piece 16 bytes a
        // thread
        auto store = [&](int yy, int k, unsigned o) {
          const int* nw = out + o * cols * piece;
          const long long row = row_of(yy) + a;
          const int quads = (min(a + piece, wp) - a) / 4;
          for (int c = 0; c < cols; ++c) {
            if (!row_fell[k * cols + c]) continue;
            for (int i = threadIdx.x; i < quads; i += blockDim.x) {
              *reinterpret_cast<int4*>(base + c * hwp + row + 4 * i) =
                  *reinterpret_cast<const int4*>(nw + c * piece + 4 * i);
            }
          }
        };
        // the piece before is stored (its writes are ordered before the
        // copies below by each thread's fence)
        __syncthreads();
        for (int k = 0; k < stages - 2; ++k) fetch(k);
        // the row above: the lane's cells of the sweep's previous row
        int prev[L];
#pragma unroll
        for (int i = 0; i < L; ++i) prev[i] = kInf;
        for (int yy = 0; yy < h; ++yy) {
          bar_wait(bars + k_cur, (phases >> k_cur) & 1u);
          // row yy landed; row yy - 1 is computed, row yy - 2 stored
          __syncthreads();
          fetch(yy + stages - 2);  // into row yy - 2's stage
          if (yy > 0) {
            store(yy - 1, k_cur == 0 ? stages - 1 : k_cur - 1, odd ^ 1u);
          }
          const int* st = ring + k_cur * stage + kSweepHalo;
          const int* sv = st + j * span;
          int* nw = out + odd * cols * piece + j * piece;
          const int* sws = st + cols * span;
          const int* swc = sws + span;
          // the lane's cells, all loaded before the chain uses them (a
          // cell past the piece reads the last one and is masked below)
          int old[L], ws[L], wc[L];
#pragma unroll
          for (int i = 0; i < L; ++i) {
            const int X = min(X0 + i, cells - 1);
            const int x = sx > 0 ? X : cells - 1 - X;
            old[i] = sv[x];
            ws[i] = sws[x];
            wc[i] = swc[x];
          }
          // pass 1: a = min(old, w_cross + above), and the segment's map
          // v -> min(A, W + v) composed in scan order (a cell past the
          // piece is the identity)
          int A = kInf;
          int W = 0;
#pragma unroll
          for (int i = 0; i < L; ++i) {
            const bool in = X0 + i < cells;
            const int a = min(old[i], wc[i] + prev[i]);
            prev[i] = a;
            A = in ? min(a, ws[i] + A) : A;
            W = in ? min(ws[i] + W, kInf) : W;
          }
          // the warp's inclusive scan of the maps (a later map after an
          // earlier one)
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int ao = __shfl_up_sync(kFull, A, off);
            const int wo = __shfl_up_sync(kFull, W, off);
            if (lane >= off) {
              A = min(A, W + ao);
              W = min(W + wo, kInf);
            }
          }
          // the value left of the lane's segment: the cell before the
          // piece (INF where there is none), then the earlier warps' maps
          // of this column, then the earlier lanes'
          const int ew = __shfl_up_sync(kFull, W, 1);
          int v = __shfl_up_sync(kFull, A, 1);
          int vin = has_edge ? sv[edge] : kInf;
          if (row_warps > 1) {
            if (lane == 31) {
              tot[2 * warp] = A;
              tot[2 * warp + 1] = W;
            }
            __syncthreads();
            for (int k = 0; k < part; ++k) {
              const int* tk = tot + 2 * (k * cols + j);
              vin = min(tk[0], tk[1] + vin);
            }
          }
          v = lane == 0 ? vin : min(v, ew + vin);
          // pass 2: new = min(a, w_same + new left), into the row of new
          // values, to be stored during the next row
          bool row_ch = false;
#pragma unroll
          for (int i = 0; i < L; ++i) {
            const int nv = min(prev[i], ws[i] + v);
            prev[i] = nv;
            v = nv;
            if (X0 + i < cells) {
              nw[sx > 0 ? X0 + i : cells - 1 - X0 - i] = nv;
              row_ch |= nv < old[i];
            }
          }
          fell |= row_ch;
          if (__any_sync(kFull, row_ch) && lane == 0) {
            row_fell[k_cur * cols + j] = 1;
          }
          phases ^= 1u << k_cur;
          k_cur = next(k_cur);
          odd ^= 1u;
        }
        __syncthreads();
        store(h - 1, k_cur == 0 ? stages - 1 : k_cur - 1, odd ^ 1u);
        fence_async_global();
      }
    }
    ++cyc;
    const int any = __syncthreads_or(fell);
    fell_any |= any != 0;
    if (!any) break;  // this group is at a fixed point of the cycle
  }
  if (threadIdx.x == 0) {
    if (fell_any && *flag == 0) *flag = 1;
    if (cycles) atomicMax(cycles, cyc);
  }
}

size_t sweep_smem(int piece, int cols, int warps, int stages) {
  return sizeof(int) * static_cast<size_t>(
      sweep_bars_at(piece, cols, warps, stages)) + sizeof(uint64_t) * stages;
}

// K3's launch shape for rows of wp (padded) cells, `cols` columns a block
struct SweepShape {
  int piece;      // cells of a row a block holds at once (a multiple of 4)
  int row_warps;  // warps a column's piece is split over
  int seg;        // cells a lane scans (L)
  int stages;     // ring stages
  size_t smem;    // bytes of shared memory
};

// The fewest pieces a row is cut into (all as wide, rounded up to 4
// cells) such that three stages fit kSweepSmemBytes and the lanes of at
// most kSweepMaxWarps warps cover a piece; then the narrowest segment that
// covers it and as many stages as fit. One piece up to 2,552 cells at one
// column a block (514 x 514 grid: one piece, one warp, 17 cells a lane).
SweepShape sweep_shape(int wp, int cols) {
  SweepShape s{};
  for (int pieces = 1;; ++pieces) {
    s.piece = ((wp + pieces - 1) / pieces + 3) & ~3;
    s.row_warps = (s.piece + 32 * kSweepMaxSeg - 1) / (32 * kSweepMaxSeg);
    if (cols * s.row_warps <= kSweepMaxWarps &&
        sweep_smem(s.piece, cols, cols * s.row_warps, 3) <= kSweepSmemBytes) {
      break;
    }
  }
  for (const int seg : kSweepSegs) {
    if (32 * s.row_warps * seg >= s.piece) {
      s.seg = seg;
      break;
    }
  }
  const int warps = cols * s.row_warps;
  s.stages = 3;
  while (s.stages < kSweepMaxStages &&
         sweep_smem(s.piece, cols, warps, s.stages + 1) <= kSweepSmemBytes) {
    ++s.stages;
  }
  s.smem = sweep_smem(s.piece, cols, warps, s.stages);
  return s;
}

int launch_transpose(int* d, int* dt, int h, int w, int wp, int b, bool to,
                     cudaStream_t s) {
  const long long n = static_cast<long long>(h) * w;
  const long long col_tiles = (b + 31) / 32;
  const long long blocks = (n + 31) / 32 * col_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  transpose_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      d, dt, n, b, w, wp, static_cast<long long>(h) * wp, to ? 1 : 0,
      col_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int L>
int launch_sweep(const int* wpad, int* d, int* dt, int* flag, int* cycles,
                 int h, int w, int b, int cols, const SweepShape& sh,
                 int max_cycles, cudaStream_t s) {
  const int wp = (w + 3) & ~3;
  int e = launch_transpose(d, dt, h, w, wp, b, true, s);
  if (e) return e;
  const auto kernel = grid_sweep_kernel<L>;
  if (sh.smem > 48 * 1024) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sh.smem));
    if (a != cudaSuccess) return static_cast<int>(a);
  }
  kernel<<<b / cols, cols * sh.row_warps * 32, sh.smem, s>>>(
      wpad, dt, flag, cycles, h, w, wp, sh.piece, cols, sh.row_warps,
      sh.stages, max_cycles);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  return launch_transpose(d, dt, h, w, wp, b, false, s);
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

// first_moves: vec (columns a lane: 1, 2 or 4) divides b; fm is int8
// [rows, n] (rows <= b, rows n bytes apart).
extern "C" int first_moves(const void* row_ptr, const void* col,
                           const void* wt, const void* d,
                           const void* targets, void* fm, long long n, int b,
                           int rows, int vec, void* stream) {
  if ((vec != 1 && vec != 2 && vec != 4) || b % vec || rows > b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && rows > 0) {
    const long long node_tiles = (n + kFmTileNodes - 1) / kFmTileNodes;
    const long long cols = 32LL * vec;
    const long long blocks = node_tiles * ((rows + cols - 1) / cols);
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const auto grid = static_cast<unsigned>(blocks);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto rp = static_cast<const int*>(row_ptr);
    const auto cl = static_cast<const int*>(col);
    const auto w = static_cast<const int*>(wt);
    const auto din = static_cast<const int*>(d);
    const auto t = static_cast<const int*>(targets);
    const auto out = static_cast<int8_t*>(fm);
    const auto nt = static_cast<int>(node_tiles);
    if (vec == 4) {
      first_moves_kernel<4><<<grid, kThreads, 0, s>>>(rp, cl, w, din, t, out,
                                                      n, b, rows, nt);
    } else if (vec == 2) {
      first_moves_kernel<2><<<grid, kThreads, 0, s>>>(rp, cl, w, din, t, out,
                                                      n, b, rows, nt);
    } else {
      first_moves_kernel<1><<<grid, kThreads, 0, s>>>(rp, cl, w, din, t, out,
                                                      n, b, rows, nt);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// grid_sweep_cycle: up to max_cycles cycles; a block owns `cols`
// columns (1 to 8, dividing b) and sweeps each row in pieces sized to its
// shared memory (sweep_shape), so any width builds; a block stops after
// the first cycle that lowers none of its columns. wpad: int32 [4, h, wp],
// the weights wl, wr, wd, wu with rows padded to wp = w rounded up to 4
// (16-byte aligned). d [h * w, b] is copied into dt (int32 [b, h, wp],
// 16-byte aligned) before and back after. cycles (int32, may be null)
// receives the largest count of cycles a block ran, by atomicMax. Three
// launches on `stream`.
extern "C" int grid_sweep_cycle(const void* wpad, void* d, void* dt,
                                void* flag, void* cycles, int h, int w,
                                int b, int cols, int max_cycles,
                                void* stream) {
  if (cols < 1 || cols > kSweepMaxWarps || b % cols || max_cycles < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h <= 0 || w <= 0 || b <= 0) return static_cast<int>(cudaGetLastError());
  const auto wt = static_cast<const int*>(wpad);
  const auto dd = static_cast<int*>(d);
  const auto t = static_cast<int*>(dt);
  const auto f = static_cast<int*>(flag);
  const auto cy = static_cast<int*>(cycles);
  const auto s = static_cast<cudaStream_t>(stream);
  const SweepShape sh = sweep_shape((w + 3) & ~3, cols);
  switch (sh.seg) {
    case 3: return launch_sweep<3>(wt, dd, t, f, cy, h, w, b, cols, sh,
                                   max_cycles, s);
    case 5: return launch_sweep<5>(wt, dd, t, f, cy, h, w, b, cols, sh,
                                   max_cycles, s);
    case 9: return launch_sweep<9>(wt, dd, t, f, cy, h, w, b, cols, sh,
                                   max_cycles, s);
    case 17: return launch_sweep<17>(wt, dd, t, f, cy, h, w, b, cols, sh,
                                     max_cycles, s);
    default: return launch_sweep<33>(wt, dd, t, f, cy, h, w, b, cols, sh,
                                     max_cycles, s);
  }
}
