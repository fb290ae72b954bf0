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
// Design: one thread a column walks i = 0 .. C-1, so the threads of a warp
// read 32 adjacent bytes of one row (one sector a load) and no transposed
// copy is made; the row loop is unrolled so that each thread keeps several
// independent loads in flight (the column's state is a byte and a count).
// A column's runs land contiguously from its offset, so the encode's
// stores scatter across columns: a few times the count's time. Both
// launch on the caller's stream and allocate nothing.

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

__global__ void __launch_bounds__(kThreads)
    rle_encode_kernel(const int8_t* __restrict__ fm,
                      const long long* __restrict__ offsets,
                      uint16_t* __restrict__ lens, int8_t* __restrict__ vals,
                      long long c, long long n) {
  const long long j =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const int8_t* p = fm + j;
  long long at = offsets[j];
  int8_t prev = __ldg(p);
  long long start = 0;
#pragma unroll kUnroll
  for (long long i = 1; i < c; ++i) {
    const int8_t cur = __ldg(p + i * n);
    if (cur != prev) {
      lens[at] = static_cast<uint16_t>(i - start);
      vals[at] = prev;
      ++at;
      start = i;
      prev = cur;
    }
  }
  lens[at] = static_cast<uint16_t>(c - start);
  vals[at] = prev;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// fm int8 [c, n] (row-major, contiguous) -> counts int32 [n]. One launch.
extern "C" int fm_run_count(const void* fm, void* counts, long long c,
                            long long n, void* stream) {
  if (c < 1 || n < 0 || (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    run_count_kernel<<<blocks_for(n), kThreads, 0,
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
      (n + kThreads - 1) / kThreads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    rle_encode_kernel<<<blocks_for(n), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(fm), static_cast<const long long*>(offsets),
        static_cast<uint16_t*>(lens), static_cast<int8_t*>(vals), c, n);
  }
  return static_cast<int>(cudaGetLastError());
}
