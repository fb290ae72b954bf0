// Table-search walk: one CUDA thread per query lane.
//
// Replaces the TPU kernel ops/pallas_walk.py::_pallas_walk of the JAX
// package (body _make_kernel): per lane, slot = fm[row, x]; the lane stops
// on slot < 0, on the k_moves budget or at the step bound; otherwise
// cost += w[out_eid[x, slot]] and x = out_nbr[x, slot]. Returns
// (cost, plen, x == t) with pad lanes zeroed, bit-identical to the plain
// walk ops/table_search.py::table_search_batch.
//
// What bounds it: each step is two dependent random reads per lane — the
// fm byte of the lane's own row, then the packed (next, w) pair of the
// chosen out-slot — each a separate 32-byte sector, and the next step's
// fm address depends on the pair just read. So the kernel is latency- and
// sector-bound, not bandwidth-bound: at ~360 steps a lane and tens of
// thousands of lanes it moves a few tens of MB in sectors while the card
// spends most of its time waiting on dependent loads.
//
// This first version is simple on purpose: one lane per thread, a 1-D
// grid over Q, fm bytes read straight from device memory through the
// read-only path (a 264k-node row is 264 KB, past one SM's 227 KB of
// shared memory, so the TPU's VMEM row tile does not transfer), and a
// lane returns as soon as it halts. A faster design (warp per bucket,
// cp.async-staged pair rows, the pack4 nibble tile) is later work.
//
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

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
table_search_walk_kernel(const int8_t* __restrict__ fm, long long n,
                         const int* __restrict__ rows,
                         const int* __restrict__ s,
                         const int* __restrict__ t,
                         const uint8_t* __restrict__ valid,
                         const int2* __restrict__ pair, int k,
                         long long steps, int budget,
                         int* __restrict__ cost, int* __restrict__ plen,
                         uint8_t* __restrict__ fin, int q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const bool v = valid[i] != 0;
  const int tt = t[i];
  int x = v ? s[i] : tt;
  const int8_t* row = fm + static_cast<long long>(rows[i]) * n;
  unsigned int c = 0;
  int p = 0;
  int slot = static_cast<int>(__ldg(row + x));
  if (v && slot >= 0) {
    for (long long step = 0; step < steps; ++step) {
      if (budget >= 0 && p >= budget) break;
      const int2 nw = __ldg(pair + static_cast<long long>(x) * k + slot);
      c += static_cast<unsigned int>(nw.y);
      p += 1;
      x = nw.x;
      slot = static_cast<int>(__ldg(row + x));
      if (slot < 0) break;
    }
  }
  cost[i] = v ? static_cast<int>(c) : 0;
  plen[i] = v ? p : 0;
  fin[i] = (v && x == tt) ? 1 : 0;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` without
// synchronising; returns cudaGetLastError() so a refused launch is seen.
extern "C" int table_search_walk(const void* fm, long long n,
                                 const void* rows, const void* s,
                                 const void* t, const void* valid,
                                 const void* pair, int k, long long steps,
                                 int budget, void* cost, void* plen,
                                 void* fin, int q, void* stream) {
  if (q > 0) {
    const int blocks = (q + kThreads - 1) / kThreads;
    table_search_walk_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(fm), n, static_cast<const int*>(rows),
        static_cast<const int*>(s), static_cast<const int*>(t),
        static_cast<const uint8_t*>(valid), static_cast<const int2*>(pair),
        k, steps, budget, static_cast<int*>(cost), static_cast<int*>(plen),
        static_cast<uint8_t*>(fin), q);
  }
  return static_cast<int>(cudaGetLastError());
}
