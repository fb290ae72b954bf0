// Pointer doubling (K5): every sweep of a row's successor and cost tables
// in one launch, the row held on chip, by a cluster of blocks
// (doubling_rows) or, for a row no cluster holds, by a team of
// co-resident blocks (doubling_team); and the one-sweep kernel over device
// memory for rows too large for any team of the card (doubling_sweep).
//
// Serves the JAX package's XLA stage ops/pointer_doubling.py
// (doubled_tables / doubled_tables_multi, the while_loop; there is no
// Pallas kernel there). Each (row r, node x) entry is one int32 record
// (succ, plen, cost[0:d]) padded to g 16-byte groups; one sweep makes,
// from the previous sweep's records only (Jacobi, as the JAX loop),
//   succ' = rec[r, succ].succ
//   plen' = plen + rec[r, succ].plen
//   cost' = cost + rec[r, succ].cost      (int32 adds, wrapping)
// Bit-identical to ops/pointer_doubling.py::double_rows (and, sweep by
// sweep, to sweep_records).
//
// What bounds it on this card. The recursion never leaves a row. The
// first version (PR 9, kept as doubling_sweep) streamed the whole chunk
// through HBM every sweep (the record, its successor's gathered at a
// 32-byte sector while successors scatter, the new record written), ~10
// sweeps a chunk with a host read of a flag after each: ~10x the bytes of
// one pass over the records. On chip a row is read from device memory
// once and written once (1.3 ms of HBM time for a 2,048-row chunk of
// 65,536 nodes); what is left is the gathers, from the block's own shared
// memory or from another block's of its cluster (distributed shared
// memory). On the H100 a sweep whose gathers are all local runs several
// times faster than one whose gathers are mostly remote, about linear in
// the remote share: the SM-to-SM network's rate for scattered 16-byte
// reads sets the time (PERF.md, section 6).
//
// The shape rule (ops/cuda_doubling.py::shape_rule, from the card's
// figures that doubling_card reports) picks the tier: the fewest blocks
// whose shared memory holds the row at no more than 16 nodes a thread of
// 512; a cluster when that is at most the largest cluster the card holds,
// else a team when the card holds that many blocks at once, else the
// sweep loop.
//
// What doubling_rows does about it:
// * one block a row where the row fits one block's shared memory, else a
//   cluster a row of the fewest blocks (up to 16: past 8 the non-portable
//   size) that hold it, each block owning a contiguous range of positions;
//   doubling_rows launches the plan the shape rule gives it;
// * the caller lays a row out in a Z-order of the node coordinates
//   (ops/pointer_doubling.py::record_order, which the oracle makes once
//   and passes in), so a block's range is a compact region of the
//   map and a successor, until the jumps grow long, lies in the same
//   block: fewer remote gathers;
// * a record is read as 16-byte groups: one remote load a group, where a
//   field-by-field layout took one a field;
// * the row comes in once by TMA bulk copies on an mbarrier (the records
//   lie in device memory as they lie in shared memory) and goes back once
//   by coalesced 16-byte stores;
// * a sweep is Jacobi without a second buffer: per group, every thread
//   issues its nodes' remote reads, adds, and holds the new group in
//   registers; the cluster meets at a barrier, then every thread writes.
//   Group 0 holds succ: the gathers of later groups use the addresses
//   taken at the start of the sweep;
// * a node whose successor is a fixed point with a record zero past succ
//   (a target or a stuck node) never changes again: a bit a node marks it
//   done and later sweeps skip its gathers;
// * "some successor moved" is an OR over the cluster (each block's OR in
//   its own shared slot, read by every block after the barrier; two slots
//   alternate), so a row stops at its own sweep count with no host sync;
// * the row is written back with settled[r] (the 1-based index of the
//   first sweep that moved no successor, 0 if none moved at the start,
//   the cap if none settled) and live[r] (a fixed point whose record is
//   not zero past succ: a cycle of the first-move table);
// * no block leaves while another block of its cluster may still read its
//   shared memory: the kernel ends with a cluster barrier.
//
// The team tier, for a row past the largest cluster (a road row
// of 264,000 nodes x 16 bytes, 4.2 MB, takes 33 blocks of 8,000 nodes):
// * one cooperative launch of as many teams as the card holds at once
//   (132 blocks: 4 teams of 33 on the H100); the teams stride over the
//   rows, so a chunk is one launch with no host sync and no spare buffer
//   the size of the records;
// * each block keeps its window of the row in shared memory as above, and
//   gathers a successor outside it from the row's copy in device memory
//   (ld.global.cg: the copies change during the launch, so never through
//   L1): a team's two copies (the row itself and one scratch row, 4.2 MB
//   each) stay in the 50 MB L2, so a remote gather is an L2 hit, not an
//   HBM sector;
// * the copies alternate by sweep (Jacobi), so one team barrier a sweep
//   (an arrival counter in device memory, release/acquire) separates a
//   sweep's reads from the next sweep's writes; it also carries the OR
//   "some successor moved" (three slots in turn), so each row stops at
//   its own sweep count. The barrier is split: a block arrives after its
//   stores and waits only after it has gathered the next sweep's
//   successors in its own window, so the wait overlaps that work;
// * a done node neither gathers nor publishes: both copies already hold
//   its final record.
//
// Exactness. JAX runs the same number of sweeps K on every row of a chunk:
// K = min(limit, max_r settled[r]). A settled row that is not live gains
// zeros from further sweeps, so it is exact at its own count. A live row
// is not (a cycle adds its cost and plen every sweep); the caller reruns
// the live rows with settled[r] < K from their first records with `fixed`
// set: exactly K sweeps. `cap` is also how tests stop after 1, 2, 3
// sweeps.
//
// Tried and not kept: the record field by field in shared memory
// (structure of arrays, 4-byte gathers, cp.async copies that transposed
// the records on the way: slower than the wide path's sweeps); 1,024
// threads and 8 nodes a thread (registers spill; issuing every remote
// read before using any was no faster there); an RCM order of the nodes
// (its bands are thin strips of the map: less local than the Z-order).
//
// doubling_sweep, the wide path: one sweep over rows x n records, cur ->
// nxt in device memory, one thread an entry, the successor's record
// gathered in one or two 16-byte loads; sets *flag when a successor moved,
// at most once a block (blocks stride over tiles of 256 nodes of a row).
// The caller loops and reads the flag.
//
// Parity traps kept from the JAX loop: every read is of the previous
// sweep; the sums wrap like int32 adds (summed as unsigned); self-loops
// (target, stuck) carry plen 0 and cost 0 and are never special-cased.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kRowThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kPortableCluster = 8;
// nodes a thread owns at most (registers: a 16-byte group and an address
// a node, 128 registers a thread at 512 threads)
constexpr int kMaxNpt = 16;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) +
                          static_cast<unsigned int>(b));
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(wrap_add(a.x, b.x), wrap_add(a.y, b.y),
                   wrap_add(a.z, b.z), wrap_add(a.w, b.w));
}

// ------------------------------------------------------ the on-chip rows

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes of shared memory by 32-bit address: the block's own
// (kCluster false) or any block's of the cluster (a mapa address)
template <bool kCluster>
__device__ __forceinline__ int4 ld_shared4(unsigned addr) {
  int4 v;
  if constexpr (kCluster) {
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
                 : "memory");
  } else {
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr)
                 : "memory");
  }
  return v;
}

__device__ __forceinline__ int ld_cluster(unsigned addr) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned map_rank(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// mbarrier and TMA bulk-copy helpers (as csrc/cpd_build.cu's K3)
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for phase `parity` of bar; a copy that never lands traps (a sticky
// error that poisons the CUDA context) instead of hanging the card
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

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <bool kCluster>
__device__ __forceinline__ void row_sync() {
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// OR of `v` over the row's threads: each block's OR goes to its own slot
// (two alternate, so a slot is rewritten only after every block has read
// it), then the first threads read every block's slot.
template <bool kCluster>
__device__ __forceinline__ bool row_or(bool v, int* slots, int& parity,
                                       int csize) {
  const int mine = __syncthreads_or(v);
  if constexpr (!kCluster) {
    return mine != 0;
  } else {
    if (threadIdx.x == 0) slots[parity] = mine;
    cg::this_cluster().sync();
    int got = 0;
    if (static_cast<int>(threadIdx.x) < csize) {
      got = ld_cluster(map_rank(smem_u32(slots + parity), threadIdx.x));
    }
    parity ^= 1;
    return __syncthreads_or(got) != 0;
  }
}

// One row (kCluster false: a block; true: a cluster of csize blocks, each
// owning nodes [rank * nl, rank * nl + nl)) of `rec` (int32 [rows, n,
// 4 g]: g 16-byte groups a record, (succ, plen, cost[0:d]) and zero
// padding) doubled in place: up to `cap` sweeps, ending after the first
// that moves no successor unless `fixed` (then exactly `cap`). Shared
// memory: the block's records as they lie in device memory, then an
// mbarrier and two slots. A thread owns nodes tid + k * blockDim.x.
template <int kNpt, bool kCluster>
__global__ void __launch_bounds__(kRowThreads, 1)
doubling_rows_kernel(int4* __restrict__ rec, int n, int g, int nl, int cap,
                     int fixed, int* __restrict__ settled_out,
                     uint8_t* __restrict__ live_out) {
  extern __shared__ __align__(16) int4 recs[];
  int csize = 1, rank = 0;
  if constexpr (kCluster) {
    cg::cluster_group cl = cg::this_cluster();
    csize = static_cast<int>(cl.num_blocks());
    rank = static_cast<int>(cl.block_rank());
  }
  const long long row = blockIdx.x / csize;
  const int x0 = rank * nl;
  const int nh = n - x0 < nl ? (n - x0 > 0 ? n - x0 : 0) : nl;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  int4* const base = rec + (row * n + x0) * g;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(recs + nl * g);
  int* const slots = reinterpret_cast<int*>(bar + 1);
  // the block's records in one pass: TMA bulk copies on one mbarrier
  const unsigned bytes = static_cast<unsigned>(nh) * g * 16u;
  if (tid == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && bytes > 0) {
    bar_expect(bar, bytes);
    constexpr unsigned kPiece = 32768;
    for (unsigned at = 0; at < bytes; at += kPiece) {
      bulk_load(reinterpret_cast<char*>(recs) + at,
                reinterpret_cast<const char*>(base) + at,
                bytes - at < kPiece ? bytes - at : kPiece, bar);
    }
  }
  if (bytes > 0) bar_wait(bar, 0);
  bool mv = false;
  for (int x = tid; x < nh; x += T) mv |= recs[x * g].x != x0 + x;
  int parity = 0;
  const bool moving = row_or<kCluster>(mv, slots, parity, csize);
  int settled = 0;
  if (moving || fixed) {
    const unsigned sbase = smem_u32(recs);
    const unsigned rstride = static_cast<unsigned>(g) * 16u;
    // done bit k: node tid + k T points at a fixed point whose record is
    // all zero past succ, so its own record no longer changes
    unsigned done = 0;
    for (int i = 1; i <= cap; ++i) {
      // the successor's record, in the window of the block that owns it
      unsigned addr[kNpt];
#pragma unroll
      for (int k = 0; k < kNpt; ++k) {
        const int x = tid + k * T;
        if (x < nh && !((done >> k) & 1u)) {
          const unsigned s = static_cast<unsigned>(recs[x * g].x);
          if constexpr (kCluster) {
            const unsigned owner = s / static_cast<unsigned>(nl);
            addr[k] = map_rank(sbase + (s - owner * nl) * rstride, owner);
          } else {
            addr[k] = sbase + s * rstride;
          }
        }
      }
      bool m = false;
      unsigned zero = 0;  // bit k: the gathered record is zero past succ
      bool moved = false;
      for (int j = 0; j < g; ++j) {
        // every remote read of the group in flight before any is used
        int4 nv[kNpt];
#pragma unroll
        for (int k = 0; k < kNpt; ++k) {
          const int x = tid + k * T;
          if (x < nh && !((done >> k) & 1u)) {
            nv[k] = ld_shared4<kCluster>(addr[k] + j * 16u);
          }
        }
#pragma unroll
        for (int k = 0; k < kNpt; ++k) {
          const int x = tid + k * T;
          if (x < nh && !((done >> k) & 1u)) {
            const int4 got = nv[k];
            const int4 own = recs[x * g + j];
            nv[k] = add4(own, got);
            int rest = got.y | got.z | got.w;
            if (j == 0) {
              nv[k].x = got.x;
              m |= got.x != own.x;
              if (got.x == own.x && rest == 0) zero |= 1u << k;
            } else {
              rest |= got.x;
              if (rest != 0) zero &= ~(1u << k);
            }
          }
        }
        // the last group's barrier is the OR's: it also ends every
        // block's reads of this sweep
        if (j + 1 == g) {
          moved = row_or<kCluster>(m, slots, parity, csize);
        } else {
          row_sync<kCluster>();
        }
#pragma unroll
        for (int k = 0; k < kNpt; ++k) {
          const int x = tid + k * T;
          if (x < nh && !((done >> k) & 1u)) recs[x * g + j] = nv[k];
        }
      }
      done |= zero;
      row_sync<kCluster>();
      if (!moved && moving && settled == 0) {
        settled = i;
        if (!fixed) break;
      }
    }
    if (moving && settled == 0) settled = cap;
  }
  // live: a fixed point whose record is not zero past succ (a cycle)
  bool lv = false;
  for (int x = tid; x < nh; x += T) {
    if (recs[x * g].x == x0 + x) {
      int rest = recs[x * g].y | recs[x * g].z | recs[x * g].w;
      for (int j = 1; j < g; ++j) {
        const int4 q = recs[x * g + j];
        rest |= q.x | q.y | q.z | q.w;
      }
      lv |= rest != 0;
    }
  }
  const bool live = row_or<kCluster>(lv, slots, parity, csize);
  for (int idx = tid; idx < nh * g; idx += T) base[idx] = recs[idx];
  if (rank == 0 && tid == 0) {
    settled_out[row] = settled;
    live_out[row] = live ? 1 : 0;
  }
  // no block leaves while a block of its cluster may still read its slots
  row_sync<kCluster>();
}

using RowsKernel = void (*)(int4*, int, int, int, int, int, int*, uint8_t*);

template <bool kCluster>
RowsKernel rows_kernel(int npt) {
  if (npt <= 1) return doubling_rows_kernel<1, kCluster>;
  if (npt <= 2) return doubling_rows_kernel<2, kCluster>;
  if (npt <= 4) return doubling_rows_kernel<4, kCluster>;
  if (npt <= 8) return doubling_rows_kernel<8, kCluster>;
  return doubling_rows_kernel<kMaxNpt, kCluster>;
}

struct RowPlan {
  int blocks;   // blocks a row: a cluster's, or a team's
  int threads;
  int nl;       // nodes a block
  int smem;     // dynamic shared memory bytes a block
  int teams;    // 0: a cluster a row; > 0: the teams of co-resident blocks
};

// Whether `pl` holds a row of n nodes of g groups within the kernels'
// limits (the card checks the rest when it launches).
bool plan_holds(const RowPlan& pl, int n, int g) {
  return pl.blocks >= 1 && pl.threads >= 32 && pl.threads <= kRowThreads &&
         pl.threads % 32 == 0 &&
         static_cast<long long>(pl.nl) * pl.blocks >= n &&
         pl.nl <= kMaxNpt * pl.threads &&
         pl.smem >= static_cast<long long>(pl.nl) * g * 16 + 16;
}

cudaLaunchConfig_t rows_config(const RowPlan& pl, long long rows,
                               cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * pl.blocks), 1, 1);
  cfg.blockDim = dim3(pl.threads, 1, 1);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.blocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Lets `k` take the card's opt-in shared memory a block (and, with
// `cluster` past 8, a non-portable cluster). The same values every call,
// so threads that launch the kernel at once never race on them.
cudaError_t ready_kernel(const void* k, int cluster, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *max_smem);
  }
  if (err == cudaSuccess && cluster > kPortableCluster) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  return err;
}

// ---------------------------------------------------- the team tier

// a barrier that waits this long has lost a block: trap (a sticky error)
// rather than hang the card
constexpr long long kSpinCycles = 1LL << 32;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The team's barrier, in two halves, with an OR of a flag over the
// team's blocks. team_arrive publishes the block's OR and every store its
// threads made before it; team_wait returns the team's OR once every
// block has arrived, and every thread of the team then sees those stores.
// A block may work on its own shared memory in between. `sync` is the
// team's state in device memory: [0] its arrivals (monotonic over the
// launch; the caller zeroes it), [1..3] the OR slots of three barriers in
// turn. `epoch` counts the block's barriers (every block of a team passes
// the same ones). Slot e % 3 is zeroed by the team's first block once
// barrier e - 1's slot has been read by all (after barrier e), and is
// next written after barrier e + 1.
__device__ __forceinline__ void team_arrive(bool v, unsigned* sync,
                                            unsigned epoch) {
  const int mine = __syncthreads_or(v);
  if (threadIdx.x == 0) {
    if (mine) atomicOr(sync + 1 + epoch % 3, 1u);
    __threadfence();
    atomicAdd(sync, 1u);
  }
}

__device__ __forceinline__ bool team_wait(unsigned* sync, unsigned& epoch,
                                          unsigned csize, bool lead,
                                          int* flag) {
  if (threadIdx.x == 0) {
    const unsigned target = (epoch + 1) * csize;
    const long long t0 = clock64();
    while (static_cast<int>(ld_acquire(sync) - target) < 0) {
      if (clock64() - t0 > kSpinCycles) __trap();
    }
    __threadfence();
    *flag = ld_acquire(sync + 1 + epoch % 3) != 0;
    if (lead) atomicExch(sync + 1 + (epoch + 2) % 3, 0u);
  }
  __syncthreads();
  ++epoch;
  return *flag != 0;
}

// Rows of `rec` (int32 [rows, n, 4 g]) doubled in place by teams of
// `csize` co-resident blocks (a cooperative launch of teams x csize
// blocks); team t doubles rows t, t + teams, ... Each block owns nodes
// [rank * nl, rank * nl + nl) of the row and holds their records in
// shared memory (as doubling_rows_kernel: TMA in, done bits, the row's
// own stop); a successor outside the block's window is gathered from the
// row's copy in device memory. Sweep i reads the copy of sweep i - 1 and
// publishes its new records to the other copy: the row itself in `rec`
// (odd sweeps read it) and the team's row of `scratch` (int32 [teams, n,
// 4 g]); the copies alternate, so one team barrier a sweep (which also
// carries the "some successor moved" OR) separates a sweep's reads from
// the next sweep's writes; a block waits at it only after gathering the
// next sweep's successors in its own window. A done node publishes
// nothing: both copies already hold its record. The row goes back to
// `rec` from shared memory at the end. Shared memory: the window, an
// mbarrier, the OR's flag.
template <int kNpt>
__global__ void __launch_bounds__(kRowThreads, 1)
doubling_team_kernel(int4* rec, int4* scratch, unsigned* sync,
                     long long rows, int n, int g, int nl, int csize,
                     int cap, int fixed, int* __restrict__ settled_out,
                     uint8_t* __restrict__ live_out) {
  extern __shared__ __align__(16) int4 recs[];
  const int team = blockIdx.x / csize;
  const int rank = blockIdx.x - team * csize;
  const int teams = gridDim.x / csize;
  const int x0 = rank * nl;
  const int nh = n - x0 < nl ? (n - x0 > 0 ? n - x0 : 0) : nl;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const bool lead = rank == 0;
  const long long rlen = static_cast<long long>(n) * g;  // int4 a row
  int4* const scr = scratch + team * rlen;
  unsigned* const ts = sync + 4 * team;
  uint64_t* const bar = reinterpret_cast<uint64_t*>(recs + nl * g);
  int* const flag = reinterpret_cast<int*>(bar + 1);
  const unsigned bytes = static_cast<unsigned>(nh) * g * 16u;
  const unsigned sbase = smem_u32(recs);
  const unsigned rstride = static_cast<unsigned>(g) * 16u;
  if (tid == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned epoch = 0, phase = 0;
  for (long long row = team; row < rows; row += teams) {
    int4* const rowp = rec + row * rlen;
    int4* const base = rowp + static_cast<long long>(x0) * g;
    // the last row's accesses to the window come before the copy's writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0 && bytes > 0) {
      bar_expect(bar, bytes);
      constexpr unsigned kPiece = 32768;
      for (unsigned at = 0; at < bytes; at += kPiece) {
        bulk_load(reinterpret_cast<char*>(recs) + at,
                  reinterpret_cast<const char*>(base) + at,
                  bytes - at < kPiece ? bytes - at : kPiece, bar);
      }
    }
    if (bytes > 0) {
      bar_wait(bar, phase);
      phase ^= 1;
    }
    bool mv = false;
    for (int x = tid; x < nh; x += T) mv |= recs[x * g].x != x0 + x;
    team_arrive(mv, ts, epoch);
    // an arrival is waited for at the next sweep, once the block has
    // gathered the successors in its own window (the wait then costs less)
    bool pending = true, moving = false;
    int settled = 0;
    unsigned done = 0;
    for (int i = 1; i <= cap; ++i) {
      const int4* const prev = (i & 1) ? rowp : scr;
      int4* const next = (i & 1) ? scr : rowp;
      // the successor's record: a shared address in the window (bit k of
      // `local`: its group 0 gathered now) or its node id in the copy
      unsigned addr[kNpt];
      unsigned local = 0;
      int4 nv[kNpt];
#pragma unroll
      for (int k = 0; k < kNpt; ++k) {
        const int x = tid + k * T;
        if (x < nh && !((done >> k) & 1u)) {
          const unsigned s = static_cast<unsigned>(recs[x * g].x);
          const unsigned o = s - static_cast<unsigned>(x0);
          if (o < static_cast<unsigned>(nh)) {
            local |= 1u << k;
            addr[k] = sbase + o * rstride;
            nv[k] = ld_shared4<false>(addr[k]);
          } else {
            addr[k] = s;
          }
        }
      }
      // the last barrier's OR: whether the row moved at all, or in the
      // last sweep
      const bool r = team_wait(ts, epoch, csize, lead, flag);
      pending = false;
      if (i == 1) {
        moving = r;
        if (!moving && !fixed) break;
      } else if (!r && moving && settled == 0) {
        settled = i - 1;
        if (!fixed) break;
      }
      bool m = false;
      unsigned zero = 0;  // bit k: the gathered record is zero past succ
      for (int j = 0; j < g; ++j) {
#pragma unroll
        for (int k = 0; k < kNpt; ++k) {
          const int x = tid + k * T;
          if (x < nh && !((done >> k) & 1u)) {
            if (!((local >> k) & 1u)) {
              nv[k] = __ldcg(prev + static_cast<long long>(addr[k]) * g + j);
            } else if (j > 0) {
              nv[k] = ld_shared4<false>(addr[k] + j * 16u);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < kNpt; ++k) {
          const int x = tid + k * T;
          if (x < nh && !((done >> k) & 1u)) {
            const int4 got = nv[k];
            const int4 own = recs[x * g + j];
            nv[k] = add4(own, got);
            int rest = got.y | got.z | got.w;
            if (j == 0) {
              nv[k].x = got.x;
              m |= got.x != own.x;
              if (got.x == own.x && rest == 0) zero |= 1u << k;
            } else {
              rest |= got.x;
              if (rest != 0) zero &= ~(1u << k);
            }
          }
        }
        // every read of the window's group j in this sweep comes first
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kNpt; ++k) {
          const int x = tid + k * T;
          if (x < nh && !((done >> k) & 1u)) {
            recs[x * g + j] = nv[k];
            __stcg(next + static_cast<long long>(x0 + x) * g + j, nv[k]);
          }
        }
      }
      done |= zero;
      team_arrive(m, ts, epoch);
      pending = true;
    }
    if (pending) {
      const bool r = team_wait(ts, epoch, csize, lead, flag);
      if (cap == 0) moving = r;
    }
    if (moving && settled == 0) settled = cap;
    bool lv = false;
    for (int x = tid; x < nh; x += T) {
      if (recs[x * g].x == x0 + x) {
        int rest = recs[x * g].y | recs[x * g].z | recs[x * g].w;
        for (int j = 1; j < g; ++j) {
          const int4 q = recs[x * g + j];
          rest |= q.x | q.y | q.z | q.w;
        }
        lv |= rest != 0;
      }
    }
    // after it no block reads this row's copies
    team_arrive(lv, ts, epoch);
    const bool live = team_wait(ts, epoch, csize, lead, flag);
    for (int idx = tid; idx < nh * g; idx += T) base[idx] = recs[idx];
    if (lead && tid == 0) {
      settled_out[row] = settled;
      live_out[row] = live ? 1 : 0;
    }
  }
}

using TeamKernel = void (*)(int4*, int4*, unsigned*, long long, int, int, int,
                            int, int, int, int*, uint8_t*);

TeamKernel team_kernel(int npt) {
  if (npt <= 1) return doubling_team_kernel<1>;
  if (npt <= 2) return doubling_team_kernel<2>;
  if (npt <= 4) return doubling_team_kernel<4>;
  if (npt <= 8) return doubling_team_kernel<8>;
  return doubling_team_kernel<kMaxNpt>;
}

// The card's figures for the shape rule (ops/cuda_doubling.py::
// shape_rule): SMs, opt-in shared memory a block, the team kernel's
// blocks an SM holds at that shared memory (its largest template) and the
// largest cluster (1 to 16) of the row kernel at that shared memory the
// card can make resident. Readies every kernel it asks about.
cudaError_t card_figures(int* out) {
  int dev = 0, sms = 0, max_smem = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const void* team = reinterpret_cast<const void*>(team_kernel(kMaxNpt));
  if (err == cudaSuccess) err = ready_kernel(team, 0, &max_smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, team_kernel(kMaxNpt), kRowThreads, max_smem);
  }
  if (err != cudaSuccess) return err;
  int largest = 1;
  for (int c = kMaxCluster; c > 1; --c) {
    const RowsKernel k = rows_kernel<true>(kMaxNpt);
    err = ready_kernel(reinterpret_cast<const void*>(k), c, &max_smem);
    if (err != cudaSuccess) return err;
    const RowPlan pl{c, kRowThreads, 0, max_smem, 0};
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = rows_config(pl, 1, nullptr, &attr);
    int fits = 0;
    if (cudaOccupancyMaxActiveClusters(&fits, k, &cfg) != cudaSuccess) {
      // a cluster shape the card refuses: not an error of the call
      cudaGetLastError();
      continue;
    }
    if (fits > 0) {
      largest = c;
      break;
    }
  }
  out[0] = sms;
  out[1] = max_smem;
  out[2] = per_sm;
  out[3] = largest;
  return cudaSuccess;
}

// ------------------------------------------------ the wide path (PR 9)

// kV > 0: records of kV vectors; kV == 0: of v vectors (any width). A
// tile is kThreads consecutive nodes of one row; blocks stride over the
// tiles, so a block raises the flag at most once a sweep.
template <int kV>
__global__ void __launch_bounds__(kThreads)
doubling_sweep_kernel(const int4* __restrict__ cur, int4* __restrict__ nxt,
                      int* __restrict__ flag, int tiles, int tiles_per_row,
                      int n, int v) {
  const int vv = kV > 0 ? kV : v;
  bool changed = false;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r = tile / tiles_per_row;
    const int x = (tile - r * tiles_per_row) * kThreads + threadIdx.x;
    if (x >= n) continue;
    const long long base = static_cast<long long>(r) * n;
    const long long own = (base + x) * vv;
    const int4 head = cur[own];
    const long long at = (base + head.x) * vv;
    const int4 got = __ldg(cur + at);
    int4 out = add4(head, got);
    out.x = got.x;
    nxt[own] = out;
    changed |= got.x != head.x;
#pragma unroll
    for (int j = 1; j < (kV > 0 ? kV : 1); ++j) {
      nxt[own + j] = add4(cur[own + j], __ldg(cur + at + j));
    }
    if constexpr (kV == 0) {
      for (int j = 1; j < vv; ++j) {
        nxt[own + j] = add4(cur[own + j], __ldg(cur + at + j));
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

template <int kV>
cudaError_t launch(const void* cur, void* nxt, void* flag, int tiles,
                   int tiles_per_row, int n, int v, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, doubling_sweep_kernel<kV>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(resident < tiles ? resident : tiles);
  doubling_sweep_kernel<kV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const int4*>(cur), static_cast<int4*>(nxt),
      static_cast<int*>(flag), tiles, tiles_per_row, n, v);
  return cudaSuccess;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` without
// synchronising and returns the launch's error or cudaGetLastError().

// The card's figures for the shape rule (ops/cuda_doubling.py::
// shape_rule): out[0] SMs, out[1] opt-in shared memory bytes a block,
// out[2] the team kernel's blocks an SM holds, out[3] the largest cluster
// of the row kernel the card makes resident. Readies the kernels.
extern "C" int doubling_card(int* out) {
  return static_cast<int>(card_figures(out));
}

// Double `rows` rows of `rec` (int32 [rows, n, 4 g], records of g 16-byte
// groups, 16-byte aligned, in place) on chip, a cluster a row: up to
// `cap` sweeps a row, stopping after its first sweep that moves no
// successor unless `fixed` (exactly `cap`). Writes settled (int32 [rows])
// and live (uint8 [rows]). `plan` is the shape rule's cluster plan for
// (n, g) on this device (blocks, threads, nodes a block, shared bytes);
// returns cudaErrorInvalidValue for a plan that does not hold the row.
extern "C" int doubling_rows(void* rec, long long rows, int n, int g,
                             const int* plan, int cap, int fixed,
                             void* settled, void* live, void* stream) {
  if (rows > 0 && n > 0) {
    const RowPlan pl{plan[0], plan[1], plan[2], plan[3], 0};
    if (!plan_holds(pl, n, g) || pl.blocks > kMaxCluster ||
        rows * pl.blocks >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int npt = (pl.nl + pl.threads - 1) / pl.threads;
    const RowsKernel k = pl.blocks == 1 ? rows_kernel<false>(npt)
                                        : rows_kernel<true>(npt);
    int max_smem = 0;
    cudaError_t err = ready_kernel(reinterpret_cast<const void*>(k),
                                   pl.blocks, &max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int4* const r = static_cast<int4*>(rec);
    int* const so = static_cast<int*>(settled);
    uint8_t* const lo = static_cast<uint8_t*>(live);
    if (pl.blocks == 1) {
      k<<<static_cast<unsigned>(rows), pl.threads, pl.smem, st>>>(
          r, n, g, pl.nl, cap, fixed, so, lo);
    } else {
      cudaLaunchAttribute attr;
      cudaLaunchConfig_t cfg = rows_config(pl, rows, st, &attr);
      err = cudaLaunchKernelEx(&cfg, k, r, n, g, pl.nl, cap, fixed, so, lo);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The same doubling by teams of co-resident blocks, for rows no cluster
// holds: `plan` is the shape rule's team plan (blocks a team, threads,
// nodes a block, shared bytes, teams); min(teams, rows) teams launch
// together (a cooperative launch: the card refuses a grid it cannot hold
// at once). `scratch`: int32 [min(teams, rows), n, 4 g], the teams' row
// copies; `sync`: uint32 [teams, 4], zero.
extern "C" int doubling_team(void* rec, void* scratch, void* sync,
                             long long rows, int n, int g, const int* plan,
                             int cap, int fixed, void* settled, void* live,
                             void* stream) {
  if (rows > 0 && n > 0) {
    const RowPlan pl{plan[0], plan[1], plan[2], plan[3], plan[4]};
    const long long teams = rows < pl.teams ? rows : pl.teams;
    if (!plan_holds(pl, n, g) || pl.teams < 1 ||
        teams * pl.blocks >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int npt = (pl.nl + pl.threads - 1) / pl.threads;
    const TeamKernel k = team_kernel(npt);
    int max_smem = 0;
    cudaError_t err = ready_kernel(reinterpret_cast<const void*>(k), 0,
                                   &max_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int4* r = static_cast<int4*>(rec);
    int4* scr = static_cast<int4*>(scratch);
    unsigned* sy = static_cast<unsigned*>(sync);
    int nn = n, gg = g, nl = pl.nl, csize = pl.blocks, cp = cap, fx = fixed;
    long long rr = rows;
    int* so = static_cast<int*>(settled);
    uint8_t* lo = static_cast<uint8_t*>(live);
    void* args[] = {&r, &scr, &sy, &rr, &nn, &gg, &nl, &csize, &cp, &fx,
                    &so, &lo};
    err = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(k),
        dim3(static_cast<unsigned>(teams * pl.blocks), 1, 1),
        dim3(pl.threads, 1, 1), args, pl.smem,
        static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// One sweep over `rows` x `n` records of `v` 16-byte vectors, `cur` ->
// `nxt` (int32 [rows, n, 4 v], both 16-byte aligned, distinct buffers);
// sets flag[0] = 1 when a successor moved. `rows` x ceil(n / 256) must
// stay under 2^31.
extern "C" int doubling_sweep(const void* cur, void* nxt, void* flag,
                              long long rows, int n, int v, void* stream) {
  if (rows > 0 && n > 0 && v > 0) {
    const int tiles_per_row = (n + kThreads - 1) / kThreads;
    const long long tiles = rows * tiles_per_row;
    if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (v == 1) {
      err = launch<1>(cur, nxt, flag, static_cast<int>(tiles), tiles_per_row,
                      n, v, st);
    } else if (v == 2) {
      err = launch<2>(cur, nxt, flag, static_cast<int>(tiles), tiles_per_row,
                      n, v, st);
    } else {
      err = launch<0>(cur, nxt, flag, static_cast<int>(tiles), tiles_per_row,
                      n, v, st);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}
