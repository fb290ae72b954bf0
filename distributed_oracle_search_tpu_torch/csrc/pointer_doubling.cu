// Pointer-doubling sweep (K5): one squaring of a chunk's successor and
// cost tables, one CUDA thread an entry.
//
// Serves the JAX package's XLA stage ops/pointer_doubling.py
// (doubled_tables / doubled_tables_multi, the while_loop body; there is no
// Pallas kernel there). Each (row r, node x) entry is one int32 record
// (succ, plen, cost[0:d]) padded to v 16-byte vectors (4 v ints); one
// sweep writes, into the other buffer,
//   succ' = rec[r, succ].succ
//   plen' = plen + rec[r, succ].plen
//   cost' = cost + rec[r, succ].cost      (int32 adds, wrapping)
// reading only the previous sweep's records (double-buffered, as the JAX
// loop), and sets *flag = 1 when any entry's successor moved. The host
// reads the 4-byte flag after each sweep to stop, as K1's loop does.
// Bit-identical to ops/pointer_doubling.py::sweep_records.
//
// What bounds it on this card: bytes. A sweep reads each record once in
// order, gathers its successor's record once and writes the new record:
// 2-3 record-sized moves an entry, nothing to compute. The gather is the
// only scattered read; successors lie in the entry's own row (one target's
// paths), so a block of consecutive nodes gathers from one row of at most
// n records.
//
// What the design does about it:
// * the record is padded to 16 bytes, so the dependent gather of the
//   whole successor record is one 16-byte load (two at 5-8 cost sets)
//   where three separate int32 gathers would each cost a sector;
// * the block's threads take consecutive nodes of one row, so the own
//   reads and the writes are fully coalesced 16-byte accesses;
// * the changed flag is written once a block at most: the blocks are as
//   many as are resident and stride over tiles of 256 consecutive nodes
//   of a row, and a block ORs its threads' changes at the end: a store
//   a warp would put millions of stores on one address in every sweep
//   that still moves successors.
//
// Tried and not kept: two entries a thread, both own reads and both
// gathers issued before either is used (no faster at one cost set,
// slower at five). What is left is the gather itself: while successors
// are scattered over a row, each 16-byte record read costs a 32-byte
// sector from HBM; once paths converge on their targets the gathers hit
// the cache and a sweep is several times cheaper.
//
// Parity traps kept from the JAX loop: every read is of the previous
// buffer (an in-place jump reads some values one sweep early); the sums
// wrap like int32 adds (summed as unsigned); self-loops (target, stuck)
// carry plen 0 and cost 0 and are never special-cased.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned int>(a) +
                          static_cast<unsigned int>(b));
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(wrap_add(a.x, b.x), wrap_add(a.y, b.y),
                   wrap_add(a.z, b.z), wrap_add(a.w, b.w));
}

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

// Plain C entry point for ctypes: one sweep over `rows` x `n` records of
// `v` 16-byte vectors, `cur` -> `nxt` (int32 [rows, n, 4 v], both 16-byte
// aligned, distinct buffers); sets flag[0] = 1 when a successor moved.
// `rows` x ceil(n / 256) must stay under 2^31. Launches on `stream`
// without synchronising; returns the launch's error or
// cudaGetLastError().
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
