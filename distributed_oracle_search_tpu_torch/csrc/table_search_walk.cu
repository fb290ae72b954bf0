// Table-search walk: one CUDA thread per query lane.
//
// Replaces the TPU kernel ops/pallas_walk.py::_pallas_walk of the JAX
// package (body _make_kernel): per lane, slot = fm[row, x]; the lane stops
// on slot < 0, on the k_moves budget or at the step bound; otherwise
// cost += w[out_eid[x, slot]] and x = out_nbr[x, slot]. Returns
// (cost, plen, x == t) with pad lanes zeroed, bit-identical to the plain
// walk ops/table_search.py::table_search_batch.
//
// What bounds it on this card: the longest lane's chain of dependent
// reads. Every lane of a batch is resident at once, so the kernel lasts
// as long as its longest lane, and a lane's move cannot start before the
// previous move's reads have returned. Bytes are not the limit: a batch
// touches 70-100 MB of distinct sectors, a few hundredths of a
// millisecond of HBM time, against a chain of hundreds of moves at a
// memory latency each. And a warp moves on only when the slowest of its
// lanes' scattered reads has returned, so a move costs the worst latency
// among the warp's active lanes and among the reads each issues.
//
// What the design does about it:
// * one memory round trip a move, where the first version made two (the
//   fm byte, then the pair its slot names): at node x a lane issues the
//   read of x's fm byte together with the read of the head of x's
//   next-node row — its first kHead out-slots, two 16-byte loads — and
//   picks the chosen slot's next node in registers. Only a slot past the
//   head (out-degree > kHead: a few percent of a road graph's nodes,
//   none of a grid's) costs a second, dependent read. The weight of the
//   move is read off the chain: nothing waits for it but the cost sum.
//   So the pair table is planar, [2, n, k] (next nodes, then weights),
//   with k a multiple of 4 so each row starts on 16 bytes;
// * few lanes a warp: blocks are as small as keeps every lane resident
//   (8 lanes on 32,768 lanes and 132 SMs), so a warp waits on the worst
//   of 8 reads, not of 32;
// * lanes are dealt to blocks round-robin (lane = thread * blocks +
//   block): the engine sorts lanes by expected length, and this spreads
//   the longest ones over every block instead of packing them into the
//   last few, so the tail of the batch runs in warps with one or two
//   active lanes.
//
// Tried on the card and not kept: prefetching the out-neighbours' fm
// bytes into L2 one move ahead, or loading them into registers (slower
// on both shards, even when started only after a lane's first hundred
// moves: every extra scattered read lengthens the wait of its warp); L2
// evict-first / evict-last policies on fm and pair reads (slightly
// slower); interleaved (next, w) pairs read as 16-byte loads (a few
// percent slower than the planar rows: more reads on the chain).
// Staging whole target rows in shared memory (the TPU's VMEM row tile)
// was not taken: a raw 264k-node row (264 KB) is past one SM's 227 KB,
// and a packed one (132 KB) would take a block per row with one block per
// SM, while a batch has ~2.6 lanes a distinct row — ~1 GB of staging in
// dozens of waves, where today every lane is in flight at once.
//
// The pack4 variant (kPacked4, entry table_search_walk_pack4) replaces the
// same kernel's packed4=True body (widen, ops/pallas_walk.py:233-244): the
// table is models/resident.py's pack4 layout, uint8 [R, (n + 1) / 2], two
// slots a byte, low nibble first, 15 meaning -1. Each slot read is one
// byte of the lane's packed row, then a shift and a mask; a packed row
// is half a raw one, so horizontal moves on a grid find their byte in
// the sector an earlier move brought into L1.
//
// The fused multi-diff variant (K4, entry table_search_walk_multi) serves
// the JAX package's XLA stage ops/table_search.py::table_search_multi (no
// Pallas kernel there): one walk whose every move adds the moved edge's
// weight under each of d weight sets. It is bound like the raw walk, by
// the longest lane's chain. What it adds are the d weights of a move: the
// move's edge id (read where B1 reads its weight) and then the edge's row
// of w_t [M + 1, dp], a read behind a read. The first version (PR 9)
// waited for both before the next move's visit, and past d = 8 added its
// sums into the lane's column of cost in device memory, d
// read-modify-writes a move (6x its register path at d = 9). This one:
// * takes the weights off the chain: a move issues the next node's visit
//   before it waits on the edge id, and adds the weights one move later,
//   so the edge id and the weight row are in flight under the next
//   move's reads; two 16-byte loads a thread (w_t rows padded to a
//   multiple of 8: with one load at d <= 4 the compiler put the weight
//   read back on the chain, 0.3359 ms at d = 2 on the H100 where two
//   loads take 0.2994 ms);
// * keeps every sum in registers at any d: a query takes G = ceil(d / 8)
//   threads (rounded up to a power of two, at most 32) on neighbouring
//   lanes of one warp, each summing 8 weight sets. All G
//   walk the same chain, so their fm byte and head reads go to the same
//   addresses and are served together. The group's first thread writes
//   plen and fin. Past 256 weight sets (32 threads x 8) the group walks
//   the chain again in turns of 256;
// * sizes blocks as the raw walk (walk_threads over G x lanes threads) and
//   deals queries to blocks round-robin, a group never split over warps.
// Tried and not kept: the weights read by (node, slot) from a slot-weight
// table [n, k, dp] beside the next nodes, built once a call (a faster
// kernel at d = 2, 0.2880 ms, slower at d >= 5, and the table's build, a
// gather of its rows, cost 0.80 ms a call: PERF.md, section 6).

// Parity traps kept from the TPU kernel:
// * the row offset is int64 (8,250 rows x 264,000 nodes is past 2^31);
// * birth rule: x0 = valid ? s : t, halted0 = fm[row, x0] < 0 || !valid;
// * a lane that never halts takes exactly `steps` moves, the caller's
//   ceil(limit / unroll) * unroll (the TPU loop steps `unroll` moves per
//   iteration while it < limit) — this matters for corrupted, cyclic rows;
// * budget < 0 means unlimited: no per-step plen compare;
// * costs wrap like the reference's int32 adds (summed as unsigned).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 16-byte weight vectors a fused-walk thread reads a move (8 weight sets)
constexpr int kWv = 2;

// lanes a block: the fewest of 8, 16, ..., 256 that keep every lane
// resident
constexpr int kMinThreads = 8;
constexpr int kMaxThreads = 256;
// out-slots of a node read with every move, as kHead / 4 int4 loads
constexpr int kHead = 8;

// Address of node x's entry in one lane's row: a raw int8 byte, or the
// pack4 byte holding x's nibble.
template <bool kPacked4>
__device__ __forceinline__ const uint8_t* fm_at(const uint8_t* row, int x) {
  return row + (kPacked4 ? (x >> 1) : x);
}

template <bool kPacked4>
__device__ __forceinline__ int decode_slot(unsigned int byte, int x) {
  if constexpr (kPacked4) {
    const int v = (byte >> ((x & 1) * 4)) & 0xF;
    return v == 15 ? -1 : v;
  } else {
    return static_cast<int>(static_cast<int8_t>(byte));
  }
}

// Visit node x: issue the read of its fm byte, then the reads of its
// head next-node ids, and return x's slot. Head slots past the row
// (j >= k) read as x itself; they are never chosen.
template <bool kPacked4>
__device__ __forceinline__ int visit(const uint8_t* row,
                                     const int* __restrict__ next, int k,
                                     int x, int (&head)[kHead]) {
  const unsigned int byte = __ldg(fm_at<kPacked4>(row, x));
  const int4* nrow =
      reinterpret_cast<const int4*>(next + static_cast<long long>(x) * k);
#pragma unroll
  for (int v = 0; v < kHead / 4; ++v) {
    if (4 * v < k) {
      const int4 four = __ldg(nrow + v);
      head[4 * v] = four.x;
      head[4 * v + 1] = four.y;
      head[4 * v + 2] = four.z;
      head[4 * v + 3] = four.w;
    } else {
      head[4 * v] = head[4 * v + 1] = head[4 * v + 2] = head[4 * v + 3] = x;
    }
  }
  return decode_slot<kPacked4>(byte, x);
}

template <bool kPacked4>
__global__ void __launch_bounds__(kMaxThreads)
table_search_walk_kernel(const uint8_t* __restrict__ fm, long long n,
                         const int* __restrict__ rows,
                         const int* __restrict__ s,
                         const int* __restrict__ t,
                         const uint8_t* __restrict__ valid,
                         const int* __restrict__ pair, int k,
                         long long steps, int budget,
                         int* __restrict__ cost, int* __restrict__ plen,
                         uint8_t* __restrict__ fin, int q) {
  // lanes dealt round-robin over the blocks
  const int i = threadIdx.x * gridDim.x + blockIdx.x;
  if (i >= q) return;
  const bool v = valid[i] != 0;
  const int tt = t[i];
  int x = v ? s[i] : tt;
  unsigned int c = 0;
  int p = 0;
  if (v) {
    // row width in bytes: n raw, (n + 1) / 2 packed; int64 offset
    const long long width = kPacked4 ? (n + 1) / 2 : n;
    const uint8_t* row = fm + static_cast<long long>(rows[i]) * width;
    const int* __restrict__ next = pair;
    const int* __restrict__ weight = pair + n * k;
    int head[kHead];
    int slot = visit<kPacked4>(row, next, k, x, head);
    if (slot >= 0) {
      for (long long step = 0; step < steps; ++step) {
        if (budget >= 0 && p >= budget) break;
        const long long at = static_cast<long long>(x) * k + slot;
        int nx = head[0];
#pragma unroll
        for (int j = 1; j < kHead; ++j) {
          if (slot == j) nx = head[j];
        }
        if (slot >= kHead) nx = __ldg(next + at);
        c += static_cast<unsigned int>(__ldg(weight + at));
        p += 1;
        x = nx;
        slot = visit<kPacked4>(row, next, k, x, head);
        if (slot < 0) break;
      }
    }
  }
  cost[i] = v ? static_cast<int>(c) : 0;
  plen[i] = v ? p : 0;
  fin[i] = (v && x == tt) ? 1 : 0;
}

// Threads a block: the fewest of kMinThreads, 2 x that, ... kMaxThreads
// that keep all q lanes resident on the card at once.
cudaError_t walk_threads(int q, int* threads) {
  int dev = 0, sms = 0, blocks_per_sm = 0, threads_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &blocks_per_sm, cudaDevAttrMaxBlocksPerMultiprocessor, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &threads_per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  }
  if (err != cudaSuccess) return err;
  auto resident = [&](int th) {
    const long long per_sm =
        blocks_per_sm < threads_per_sm / th ? blocks_per_sm
                                            : threads_per_sm / th;
    return static_cast<long long>(sms) * per_sm * th;
  };
  int th = kMinThreads;
  while (th < kMaxThreads && resident(th) < q) th *= 2;
  *threads = th;
  return cudaSuccess;
}

template <bool kPacked4>
int launch(const void* fm, long long n, const void* rows, const void* s,
           const void* t, const void* valid, const void* pair, int k,
           long long steps, int budget, void* cost, void* plen, void* fin,
           int q, void* stream) {
  if (q > 0) {
    int threads = 0;
    const cudaError_t err = walk_threads(q, &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (q + threads - 1) / threads;
    table_search_walk_kernel<kPacked4><<<blocks, threads, 0,
                                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(fm), n, static_cast<const int*>(rows),
        static_cast<const int*>(s), static_cast<const int*>(t),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(pair),
        k, steps, budget, static_cast<int*>(cost), static_cast<int*>(plen),
        static_cast<uint8_t*>(fin), q);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fused multi-diff walk (K4): the raw walk's chain, the move's edge id
// read where B1 reads its weight, and the edge's weights w_t[eid, j0 ..
// j0 + 8) read off the chain: the next node's visit is issued before
// the wait on the edge id, and the weights are added one move later. A
// query takes g threads (a power of two), thread gl summing the 8 weight
// sets from turn * 8 g + gl * 8, read as two 16-byte vectors.
__global__ void __launch_bounds__(kMaxThreads)
table_search_walk_multi_kernel(const uint8_t* __restrict__ fm, long long n,
                               const int* __restrict__ rows,
                               const int* __restrict__ s,
                               const int* __restrict__ t,
                               const uint8_t* __restrict__ valid,
                               const int* __restrict__ pair, int k,
                               const int* __restrict__ w_t, int dp, int d,
                               int g, long long steps, int budget,
                               int* __restrict__ cost,
                               int* __restrict__ plen,
                               uint8_t* __restrict__ fin, int q) {
  // groups of g neighbouring threads, dealt round-robin over the blocks
  const int gl = threadIdx.x & (g - 1);
  const int i = (threadIdx.x / g) * gridDim.x + blockIdx.x;
  if (i >= q) return;
  const bool v = valid[i] != 0;
  const int tt = t[i];
  const uint8_t* row = fm + static_cast<long long>(rows[i]) * n;
  const int* __restrict__ next = pair;
  const int* __restrict__ eids = pair + n * k;
  const int stride = dp / 4;
  for (int j0 = gl * 8; j0 < d; j0 += 8 * g) {
    const int4* __restrict__ wv = reinterpret_cast<const int4*>(w_t + j0);
    int x = v ? s[i] : tt;
    unsigned int c[4 * kWv];
    int4 pend[kWv];  // the last move's weights, added one move later
#pragma unroll
    for (int u = 0; u < kWv; ++u) {
      c[4 * u] = c[4 * u + 1] = c[4 * u + 2] = c[4 * u + 3] = 0;
      pend[u] = make_int4(0, 0, 0, 0);
    }
    int p = 0;
    if (v) {
      int head[kHead];
      int slot = visit<false>(row, next, k, x, head);
      if (slot >= 0) {
        for (long long step = 0; step < steps; ++step) {
          if (budget >= 0 && p >= budget) break;
          const long long at = static_cast<long long>(x) * k + slot;
          int nx = head[0];
#pragma unroll
          for (int j = 1; j < kHead; ++j) {
            if (slot == j) nx = head[j];
          }
          if (slot >= kHead) nx = __ldg(next + at);
          const int eid = __ldg(eids + at);
          p += 1;
          x = nx;
          slot = visit<false>(row, next, k, x, head);
#pragma unroll
          for (int u = 0; u < kWv; ++u) {
            c[4 * u] += static_cast<unsigned int>(pend[u].x);
            c[4 * u + 1] += static_cast<unsigned int>(pend[u].y);
            c[4 * u + 2] += static_cast<unsigned int>(pend[u].z);
            c[4 * u + 3] += static_cast<unsigned int>(pend[u].w);
            pend[u] = __ldg(wv + static_cast<long long>(eid) * stride + u);
          }
          if (slot < 0) break;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kWv; ++u) {
      c[4 * u] += static_cast<unsigned int>(pend[u].x);
      c[4 * u + 1] += static_cast<unsigned int>(pend[u].y);
      c[4 * u + 2] += static_cast<unsigned int>(pend[u].z);
      c[4 * u + 3] += static_cast<unsigned int>(pend[u].w);
    }
#pragma unroll
    for (int j = 0; j < 4 * kWv; ++j) {
      if (j0 + j < d) {
        cost[static_cast<long long>(j0 + j) * q + i] =
            v ? static_cast<int>(c[j]) : 0;
      }
    }
    if (j0 == 0) {
      plen[i] = v ? p : 0;
      fin[i] = (v && x == tt) ? 1 : 0;
    }
  }
}

// Threads a query: ceil(d / 8) rounded up to a power of two, at most 32.
int multi_group(int d) {
  int g = 1;
  while (g < 32 && 8 * g < d) g *= 2;
  return g;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` without
// synchronising and returns cudaGetLastError() so a refused launch is
// seen. `fm` is int8 [R, n] raw, or uint8 [R, (n + 1) / 2] pack4; `pair`
// is int32 [2, n, k]: the next node, then the query-time weight, per
// out-slot, k a multiple of 4 and the table 16-byte aligned
// (ops/table_search.py::walk_pairs).
extern "C" int table_search_walk(const void* fm, long long n,
                                 const void* rows, const void* s,
                                 const void* t, const void* valid,
                                 const void* pair, int k, long long steps,
                                 int budget, void* cost, void* plen,
                                 void* fin, int q, void* stream) {
  return launch<false>(fm, n, rows, s, t, valid, pair, k, steps, budget,
                       cost, plen, fin, q, stream);
}

extern "C" int table_search_walk_pack4(const void* fm, long long n,
                                       const void* rows, const void* s,
                                       const void* t, const void* valid,
                                       const void* pair, int k,
                                       long long steps, int budget,
                                       void* cost, void* plen, void* fin,
                                       int q, void* stream) {
  return launch<true>(fm, n, rows, s, t, valid, pair, k, steps, budget,
                      cost, plen, fin, q, stream);
}

// The fused multi-diff walk (K4). `pair` is int32 [2, n, k]: the next
// node, then the edge id, per out-slot (ops/table_search.py::
// walk_eid_pairs); `w_t` is int32 [M + 1, dp], the d padded weight rows
// transposed and zero past d (dp = d rounded up to 8; weights_t),
// 16-byte aligned; `cost` is int32 [d, q].
extern "C" int table_search_walk_multi(const void* fm, long long n,
                                       const void* rows, const void* s,
                                       const void* t, const void* valid,
                                       const void* pair, int k,
                                       const void* w_t, int dp, int d,
                                       long long steps, int budget,
                                       void* cost, void* plen, void* fin,
                                       int q, void* stream) {
  if (q > 0 && d > 0) {
    const int g = multi_group(d);
    if (dp != (d + 7) / 8 * 8 ||
        static_cast<long long>(q) * g >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    int threads = 0;
    const cudaError_t err = walk_threads(q * g, &threads);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (threads < g) threads = g;
    const int blocks = (q + threads / g - 1) / (threads / g);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    table_search_walk_multi_kernel<<<blocks, threads, 0, st>>>(
        static_cast<const uint8_t*>(fm), n, static_cast<const int*>(rows),
        static_cast<const int*>(s), static_cast<const int*>(t),
        static_cast<const uint8_t*>(valid), static_cast<const int*>(pair), k,
        static_cast<const int*>(w_t), dp, d, g, steps, budget,
        static_cast<int*>(cost), static_cast<int*>(plen),
        static_cast<uint8_t*>(fin), q);
  }
  return static_cast<int>(cudaGetLastError());
}
