// Batched A* (K6): the heuristic table and one Jacobi sweep of the pruned
// min-plus fixed point, over [N, Q] state (node-major, query fastest).
//
// Serves the JAX package's XLA stage ops/batched_astar.py::astar_batch
// (:64-170; the jitted while_loop, no Pallas kernel there):
//
//   astar_heuristic  h[v, q] of :101-107, bit for bit. XLA on the CPU
//       contracts dx*dx + dy*dy into fma(dx, dx, dy*dy) and the tail
//       h_raw*(1-4e-7) - 1 into fma(h_raw, 1-4e-7, -1); every operation
//       is spelled out here with a round-to-nearest intrinsic, so neither
//       nvcc's contraction (on by default) nor a flag can change a bit.
//   astar_sweep      one step of `body` (:125-159), from the previous
//       sweep's g, hops and changed into second buffers (never in place:
//       a Gauss-Seidel update would change the iterate, and with it plen
//       and the counters). Per (v, q):
//         ub   = g[t[q], q]                      the query's incumbent
//         thr  = ub, or min(floor((1 + fscale) * float(ub)), 1e9)
//         prop = g[u, q] > thr - h[u, q] ? INF : g[u, q]   per source u
//         via  = min(w_in[v, k] + prop[in_nbr[v, k], q], INF)
//         best, slot = the min over k, the first minimal slot (strict <)
//         improved = best < g[v, q]
//         hops' = improved ? hops[in_nbr[v, slot], q] + 1 : hops[v, q]
//       and the sweep's exact counts of live & changed, live & ~changed,
//       live (the host multiplies by the padded K), improved & g >= INF
//       and improved & g < INF, live being the node's own prop < INF on
//       a valid lane. int32 adds wrap as XLA's do.
//
// The loop (ops/cuda_astar.py::astar_loop) stops where JAX stops: while
// any node changed and fewer than `limit` sweeps ran. A sweep reads the
// flag the sweep before it set (flag_in) and returns at once when it is
// clear, so the host queues a group of sweeps between two reads of the
// flags; a sweep that improved any node sets flag_out. The counts of each
// sweep go to its own slot (atomics of the blocks' sums), and the host
// folds them into float32 in sweep order, as the JAX loop does.
//
// What bounds it on this card: bytes. A sweep must read g, h, hops and
// changed and write g, hops and improved (22 bytes a (v, q)), plus the
// in-edge ELL; at 65,536 nodes x 1,024 queries that is ~1.5 GB, 0.44 ms
// at 3.35 TB/s. The design, simple first:
// * one thread a (v, q), q the fastest index: a warp holds 32 queries of
//   one node, so each gather of a neighbour's row of g, h or hops is one
//   coalesced 128-byte read, and the node's ELL row (in_nbr, w_in) is one
//   broadcast address for the whole warp;
// * w_in = w_pad[in_eid] is built once a weight set, so a slot costs one
//   read for its weight; a slot of weight INF (the ELL's padding, the
//   node itself) gives via = INF without reading its source's g and h;
// * the counts stay in registers over a grid-stride loop and leave by one
//   warp reduction, one block sum and five atomics a block;
// * grid: the blocks the card holds resident, at most one a tile.
// Not yet: the neighbours' rows are gathered from device memory once a
// source (a node's row is read by each of its out-neighbours), and a
// pruned or settled node is swept like any other.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJinf = 1000000000;
// the JAX stage's float32 constants: 1.0 - 4e-7 (rounded from double, as
// a weakly typed Python float is) and the int32-range clamp
constexpr float kMargin = static_cast<float>(1.0 - 4e-7);
constexpr float kClamp = 2.0e9f;

__global__ void __launch_bounds__(kThreads)
heuristic_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const int* __restrict__ t, int n, int q, float cpu,
                 float hscale, int* __restrict__ h) {
  const long long total = static_cast<long long>(n) * q;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += stride) {
    const int ii = static_cast<int>(i);
    const int v = ii / q;
    const int tq = __ldg(t + (ii - v * q));
    const float dx = __fsub_rn(__ldg(xs + v), __ldg(xs + tq));
    const float dy = __fsub_rn(__ldg(ys + v), __ldg(ys + tq));
    const float s = __fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    const float raw = __fmul_rn(__fmul_rn(s, cpu), hscale);
    const float tail = floorf(__fmaf_rn(raw, kMargin, -1.0f));
    h[ii] = static_cast<int>(fmaxf(fminf(tail, kClamp), 0.0f));
  }
}

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const int* __restrict__ in_nbr, const int* __restrict__ w_in,
             int n, int k, const int* __restrict__ h,
             const int* __restrict__ t, const uint8_t* __restrict__ valid,
             int q, const int* __restrict__ g, const int* __restrict__ hops,
             const uint8_t* __restrict__ changed, int* __restrict__ g_out,
             int* __restrict__ hops_out, uint8_t* __restrict__ improved,
             float fscale, const int* __restrict__ flag_in,
             int* __restrict__ flag_out,
             unsigned long long* __restrict__ counts) {
  // the previous sweep changed nothing: the JAX loop has stopped
  if (*flag_in == 0) return;
  const bool scaled = fscale > 0.0f;
  const float one_plus = __fadd_rn(1.0f, fscale);
  unsigned c_exp = 0, c_sur = 0, c_live = 0, c_ins = 0, c_upd = 0;
  const long long total = static_cast<long long>(n) * q;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += stride) {
    const int ii = static_cast<int>(i);
    const int v = ii / q;
    const int qq = ii - v * q;
    const int ub = __ldg(g + __ldg(t + qq) * q + qq);
    const int thr =
        scaled ? static_cast<int>(fminf(
                     floorf(__fmul_rn(one_plus, static_cast<float>(ub))),
                     1e9f))
               : ub;
    const int gv = __ldg(g + ii);
    const bool live =
        !(gv > thr - __ldg(h + ii)) && gv < kJinf && __ldg(valid + qq);
    const int* nb = in_nbr + static_cast<long long>(v) * k;
    const int* wv = w_in + static_cast<long long>(v) * k;
    int best = INT_MAX;
    int slot = 0;
    for (int j = 0; j < k; ++j) {
      const int w = __ldg(wv + j);
      int via = kJinf;
      if (w != kJinf) {
        const int at = __ldg(nb + j) * q + qq;
        const int gu = __ldg(g + at);
        const int prop = gu > thr - __ldg(h + at) ? kJinf : gu;
        via = static_cast<int>(static_cast<unsigned>(w) +
                               static_cast<unsigned>(prop));
        via = via < kJinf ? via : kJinf;
      }
      if (via < best) {
        best = via;
        slot = j;
      }
    }
    const bool imp = best < gv;
    g_out[ii] = imp ? best : gv;
    hops_out[ii] = imp ? __ldg(hops + __ldg(nb + slot) * q + qq) + 1
                       : __ldg(hops + ii);
    improved[ii] = imp;
    const bool ch = __ldg(changed + ii) != 0;
    c_exp += live && ch;
    c_sur += live && !ch;
    c_live += live;
    c_ins += imp && gv >= kJinf;
    c_upd += imp && gv < kJinf;
  }
  unsigned c[5] = {c_exp, c_sur, c_live, c_ins, c_upd};
  __shared__ unsigned part[kWarps][5];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    c[j] = __reduce_add_sync(0xffffffffu, c[j]);
    if (lane == 0) part[warp][j] = c[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned sum[5] = {0, 0, 0, 0, 0};
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < 5; ++j) sum[j] += part[w][j];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (sum[j]) atomicAdd(counts + j, static_cast<unsigned long long>(sum[j]));
    }
    if (sum[3] + sum[4]) *flag_out = 1;
  }
}

// the blocks the card holds resident for `kernel`, at most one a tile
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long total, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const long long tiles = (total + kThreads - 1) / kThreads;
  const long long resident = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(resident < tiles ? resident : tiles);
  return cudaSuccess;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` without
// synchronising and returns the launch's error or cudaGetLastError().
// n * q must stay under 2^31 (the wrappers check).

// h (int32 [n, q]) from float32 coordinates xs, ys [n] and int32 targets
// t [q]; cpu and hscale are float32.
extern "C" int astar_heuristic(const void* xs, const void* ys, const void* t,
                               int n, int q, float cpu, float hscale,
                               void* h, void* stream) {
  if (n > 0 && q > 0) {
    int blocks = 0;
    const cudaError_t err =
        grid_for(heuristic_kernel, static_cast<long long>(n) * q, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    heuristic_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xs), static_cast<const float*>(ys),
        static_cast<const int*>(t), n, q, cpu, hscale, static_cast<int*>(h));
  }
  return static_cast<int>(cudaGetLastError());
}

// One sweep: in_nbr, w_in int32 [n, k]; h, g, hops int32 [n, q]; t int32
// [q]; valid uint8 [q]; changed uint8 [n, q] -> g_out, hops_out int32 and
// improved uint8 [n, q] (distinct buffers). Runs only if flag_in[0] != 0;
// then sets flag_out[0] = 1 when a node improved and adds the sweep's five
// counts into counts[0:5] (uint64, zeroed by the caller).
extern "C" int astar_sweep(const void* in_nbr, const void* w_in, int n, int k,
                           const void* h, const void* t, const void* valid,
                           int q, const void* g, const void* hops,
                           const void* changed, void* g_out, void* hops_out,
                           void* improved, float fscale, const void* flag_in,
                           void* flag_out, void* counts, void* stream) {
  if (n > 0 && q > 0 && k > 0) {
    int blocks = 0;
    const cudaError_t err =
        grid_for(sweep_kernel, static_cast<long long>(n) * q, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    sweep_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(in_nbr), static_cast<const int*>(w_in), n, k,
        static_cast<const int*>(h), static_cast<const int*>(t),
        static_cast<const uint8_t*>(valid), q, static_cast<const int*>(g),
        static_cast<const int*>(hops), static_cast<const uint8_t*>(changed),
        static_cast<int*>(g_out), static_cast<int*>(hops_out),
        static_cast<uint8_t*>(improved), fscale,
        static_cast<const int*>(flag_in), static_cast<int*>(flag_out),
        static_cast<unsigned long long*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
