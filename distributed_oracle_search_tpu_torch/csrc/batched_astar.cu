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
//       a valid lane. int32 adds and subtractions wrap as XLA's do.
//
// The loop (ops/cuda_astar.py::astar_loop) stops where JAX stops: while
// any node changed and fewer than `limit` sweeps ran. A sweep reads the
// flag the sweep before it set (flag_in) and returns at once when it is
// clear, so the host queues a group of sweeps between two reads of the
// flags; a sweep that improved any node sets flag_out. The counts of each
// sweep go to its own slot (atomics of the blocks' sums), and the host
// folds them into float32 in sweep order, as the JAX loop does.
//
// The skip: which gathers cannot change a cell. Let changed[u, q] say
// that (u, q) improved in the sweep before this one. If no in-neighbour
// u of v on a slot of weight w in [0, 2^31 - 1 - JINF] has changed[u, q],
// those slots cannot improve (v, q) in this sweep, nor move its first
// minimal slot:
// * an unchanged u keeps its g (a sweep writes g' = min(g, best));
// * g never rises, so ub = g[t[q], q] never rises, and neither does thr
//   (floor((1 + f) * float(ub)), the clamp and the saturating cast are
//   all monotone); while thr >= INT_MIN + 2e9, thr - h cannot wrap for
//   any h in [0, 2e9], so `pruned` = g > thr - h can only turn on, and
//   u's prop can only go from g to INF: prop_now >= prop_prev;
// * for w in that range w + prop cannot wrap (prop <= JINF), so
//   via = min(w + prop, INF) is monotone in prop: via_now >= via_prev;
// * the sweep before set g[v] = min(g_prev[v], best_prev) <= best_prev
//   <= via_prev; so via_now >= g[v], and no such slot gives best < g[v];
// * if another slot gives best < g[v], every skipped slot's via is above
//   best, so the first minimal slot (and with it hops') is the same.
// The first sweep starts from init_state: an unchanged u has g = INF,
// so prop = INF and via = INF >= g[v] for w in range. Hence a sweep may
// skip slot k of (v, q) when (a) its weight is in range, (b) the query's
// thr >= INT_MIN + 2e9 and (c) no lane of u's query group changed. Slots
// outside the range, and every slot of a query past (b), are gathered,
// so the sweep stays exact for any int32 weights the JAX stage takes.
// Only the ELL padding past the node's in-degree is never visited: it
// trails each row and reads w_pad[M] = INF on the node itself, whose
// via = INF + prop >= g[v] never improves it.
//
// What bounds it on this card: bytes. A sweep's function must read g, h,
// hops and changed and write g, hops and improved (22 bytes a (v, q)),
// plus the in-edge ELL, the targets and the valid lanes; at 65,536 nodes
// x 1,024 queries that is ~1.49 GB, 0.4438 ms at 3.35 TB/s. This design
// adds the dirty groups (a byte a node and group each way) and the
// in-degrees, ~0.3% more, which the bound leaves out. The skip leaves
// the function's bytes as they are: it removes gathers of sources' g and
// h rows (8 bytes a cell a gathered slot, rows the graph's shuffled ids
// scatter past the L2), which the bound does not count either but which
// made up most of the simple kernel's traffic. The design:
// * dirty groups: a node's queries in groups of 32 (a warp's lanes); a
//   sweep writes groups_out[v, g] = any(improved[v, q] of group g) by one
//   warp ballot, and the next reads groups_in[u, g] (uint8 [N, ceil(Q /
//   32)], ~2 MB at the campaign's shape: it stays in L2) before it
//   gathers u's rows;
// * a block's 8 warps cover 8 consecutive groups of one node (below 8
//   groups, consecutive nodes), so a block reads and writes 1 KB runs of
//   each row, as a streaming kernel does: one warp a (node, group) with
//   warps of a block on 8 different nodes made each access a lone 128
//   bytes 4 KB from the next and ran slower than the simple kernel;
//   blockIdx.y walks the blocks of groups and blockIdx.x the nodes with a
//   grid stride, so a thread's query (its t[q], ub and thr) is fixed and
//   held in registers; below 32 queries a warp holds 32 / Q nodes and the
//   group is the whole chunk;
// * a node's lanes load up to 32 of its slots at once, one a lane, up to
//   its in-degree (deg [N], made once a graph), with their groups: one
//   round trip each for the ELL words and the groups, then a ballot; each
//   lane then gathers its dirty slots in slot order (shuffles bring u and
//   w), and reads h[u] only where w + g[u] < min(best, g[v]) could win
//   (a slot in range at or above it can neither improve the cell nor be
//   its first minimal slot);
// * 8 blocks of 256 an SM (32 registers), to hide the dependent loads;
// * the counts stay in registers and leave by one warp reduction, one
//   block sum and five atomics a block; grid: the blocks the card holds
//   resident, at most one a step of nodes.
// skip = 0 gathers every real slot; it is there to time and check the
// skip against, and nothing selects it. Where most groups are dirty (the
// middle of a loop) the groups' round trip costs more than the skip
// saves; elsewhere the skip leaves little but the cell's own bytes.
//
// The heuristic writes 4 bytes a cell and reads nothing a cell: each
// thread owns 4 consecutive queries, holds their targets' coordinates in
// registers and stores one int4 a node (scalars where Q % 4 != 0), over a
// grid stride that keeps a thread's queries fixed.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// sweep blocks an SM: holds the sweep to 32 registers, 64 warps an SM to
// hide the latency of its dependent loads
constexpr int kSweepBlocks = 8;
constexpr int kJinf = 1000000000;
// the JAX stage's float32 constants: 1.0 - 4e-7 (rounded from double, as
// a weakly typed Python float is) and the int32-range clamp
constexpr float kMargin = static_cast<float>(1.0 - 4e-7);
constexpr float kClamp = 2.0e9f;
// the largest weight whose w + prop cannot wrap for any prop <= JINF
constexpr unsigned kSkipMax = static_cast<unsigned>(INT_MAX - kJinf);
// from this thr up, thr - h cannot wrap for any h in [0, 2e9]
constexpr int kThrSafe = INT_MIN + 2000000000;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) -
                          static_cast<unsigned>(b));
}

__device__ __forceinline__ int heuristic(float vx, float vy, float tx,
                                         float ty, float cpu, float hscale) {
  const float dx = __fsub_rn(vx, tx);
  const float dy = __fsub_rn(vy, ty);
  const float s = __fsqrt_rn(__fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
  const float raw = __fmul_rn(__fmul_rn(s, cpu), hscale);
  const float tail = floorf(__fmaf_rn(raw, kMargin, -1.0f));
  return static_cast<int>(fmaxf(fminf(tail, kClamp), 0.0f));
}

// Vec: q % 4 == 0, so a thread's 4 queries are one aligned int4
template <bool Vec>
__global__ void __launch_bounds__(kThreads)
heuristic_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                 const int* __restrict__ t, int n, int q, float cpu,
                 float hscale, int* __restrict__ h) {
  const int quads = (q + 3) >> 2;
  const long long total = static_cast<long long>(n) * quads;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  int held = -1;
  float tx[4], ty[4];
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < total; i += stride) {
    const int ii = static_cast<int>(i);
    const int v = ii / quads;
    const int c = ii - v * quads;
    const int q0 = 4 * c;
    if (c != held) {  // once a thread when the stride is a multiple of quads
      held = c;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tq = __ldg(t + min(q0 + j, q - 1));
        tx[j] = __ldg(xs + tq);
        ty[j] = __ldg(ys + tq);
      }
    }
    const float vx = __ldg(xs + v);
    const float vy = __ldg(ys + v);
    int r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = heuristic(vx, vy, tx[j], ty[j], cpu,
                                                 hscale);
    int* out = h + static_cast<long long>(v) * q + q0;
    if (Vec) {
      *reinterpret_cast<int4*>(out) = make_int4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q0 + j < q) out[j] = r[j];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kSweepBlocks)
sweep_kernel(const int* __restrict__ in_nbr, const int* __restrict__ w_in,
             const int* __restrict__ deg, int n, int k,
             const int* __restrict__ h, const int* __restrict__ t,
             const uint8_t* __restrict__ valid, int q,
             const int* __restrict__ g, const int* __restrict__ hops,
             const uint8_t* __restrict__ changed,
             const uint8_t* __restrict__ groups_in, int* __restrict__ g_out,
             int* __restrict__ hops_out, uint8_t* __restrict__ improved,
             uint8_t* __restrict__ groups_out, float fscale, int skip,
             const int* __restrict__ flag_in, int* __restrict__ flag_out,
             unsigned long long* __restrict__ counts) {
  // the previous sweep changed nothing: the JAX loop has stopped
  if (*flag_in == 0) return;
  const bool scaled = fscale > 0.0f;
  const float one_plus = __fadd_rn(1.0f, fscale);
  const int ng = (q + 31) >> 5;                // query groups a node
  const int width = q < 32 ? q : 32;           // lanes a node
  const int per_warp = 32 / width;             // nodes a warp
  const int gpb = ng < kWarps ? ng : kWarps;   // groups a block row
  const int npb = kWarps / gpb;                // warps a group
  const int span = npb * per_warp;             // nodes a block's step
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wg = warp % gpb;
  const int wn = warp / gpb;
  const int sub = lane / width;
  const int ql = lane - sub * width;
  const bool lane_on = wn < npb && sub < per_warp;
  const unsigned seg =
      width == 32 ? 0xffffffffu : ((1u << width) - 1u) << (sub * width);
  const long long tiles = (static_cast<long long>(n) + span - 1) / span;
  const int row_tiles = (ng + gpb - 1) / gpb;
  unsigned c_exp = 0, c_sur = 0, c_live = 0, c_ins = 0, c_upd = 0;
  bool any_imp = false;
  for (int rt = blockIdx.y; rt < row_tiles; rt += gridDim.y) {
    const int grp = rt * gpb + wg;
    const int qq = grp * 32 + ql;
    const bool q_on = lane_on && grp < ng && qq < q;
    int thr = 0;
    bool vq = false, skip_q = false;
    if (q_on) {
      const int ub = __ldg(g + static_cast<long long>(__ldg(t + qq)) * q +
                           qq);
      thr = scaled ? static_cast<int>(fminf(
                         floorf(__fmul_rn(one_plus, static_cast<float>(ub))),
                         1e9f))
                   : ub;
      vq = __ldg(valid + qq) != 0;
      skip_q = skip != 0 && thr >= kThrSafe;
    }
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int v = static_cast<int>(tile * span) + wn * per_warp + sub;
      const bool node_on = lane_on && grp < ng && v < n;
      const bool on = q_on && v < n;
      const int ii = on ? v * q + qq : 0;
      const int gv = on ? __ldg(g + ii) : kJinf;
      const int hv = on ? __ldg(h + ii) : 0;
      const int d = node_on ? __ldg(deg + v) : 0;
      const int* nb = in_nbr + static_cast<long long>(v) * k;
      const int* wv = w_in + static_cast<long long>(v) * k;
      int best = INT_MAX;
      int src = v;
      // the node's lanes load `width` slots at once (their ELL words and
      // groups); each lane then gathers its dirty slots in slot order
      for (int base = 0; __any_sync(kFull, base < d); base += width) {
        const int j = base + ql;
        const bool real = j < d;
        int u_l = 0, w_l = 0;
        bool dirty_l = false;
        if (real) {
          u_l = __ldg(nb + j);
          w_l = __ldg(wv + j);
          dirty_l = !skip || static_cast<unsigned>(w_l) > kSkipMax ||
                    __ldg(groups_in + static_cast<long long>(u_l) * ng +
                          grp) != 0;
        }
        const unsigned all = (__ballot_sync(kFull, real) & seg) >> (sub * width);
        const unsigned dirty =
            (__ballot_sync(kFull, dirty_l) & seg) >> (sub * width);
        unsigned mine = on ? (skip_q ? dirty : all) : 0u;
        while (__any_sync(kFull, mine != 0)) {
          const int b = mine ? __ffs(mine) - 1 : 0;
          const int u = __shfl_sync(kFull, u_l, sub * width + b);
          const int w = __shfl_sync(kFull, w_l, sub * width + b);
          if (mine) {
            mine &= mine - 1;
            const int at = u * q + qq;
            const int gu = __ldg(g + at);
            // in range, w + g[u] >= min(best, g[v]): the slot neither
            // improves the cell nor is its first minimal slot, h unread
            if (static_cast<unsigned>(w) > kSkipMax ||
                w + gu < min(best, gv)) {
              const int prop =
                  gu > wrap_sub(thr, __ldg(h + at)) ? kJinf : gu;
              int via = wrap_add(w, prop);
              via = via < kJinf ? via : kJinf;
              if (via < best) {
                best = via;
                src = u;
              }
            }
          }
        }
      }
      bool imp = false;
      if (on) {
        const bool live = !(gv > wrap_sub(thr, hv)) && gv < kJinf && vq;
        imp = best < gv;
        g_out[ii] = imp ? best : gv;
        hops_out[ii] = imp ? __ldg(hops + src * q + qq) + 1 : __ldg(hops + ii);
        improved[ii] = imp;
        const bool ch = __ldg(changed + ii) != 0;
        c_exp += live && ch;
        c_sur += live && !ch;
        c_live += live;
        c_ins += imp && gv >= kJinf;
        c_upd += imp && gv < kJinf;
        any_imp |= imp;
      }
      const unsigned b = __ballot_sync(kFull, imp);
      if (q_on && ql == 0 && v < n) {
        groups_out[static_cast<long long>(v) * ng + grp] = (b & seg) != 0;
      }
    }
  }
  unsigned c[5] = {c_exp, c_sur, c_live, c_ins, c_upd};
  __shared__ unsigned part[kWarps][5];
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
  }
  // the counts wrap past 2^32 a block, any_imp does not
  if (__any_sync(0xffffffffu, any_imp) && lane == 0) *flag_out = 1;
}

// the blocks of `kernel` the card holds resident
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  *blocks = static_cast<long long>(sms) * per_sm;
  return err;
}

long long min_ll(long long a, long long b) { return a < b ? a : b; }

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` without
// synchronising and returns the launch's error or cudaGetLastError().
// n * q must stay under 2^31 (the wrappers check).

// h (int32 [n, q]) from float32 coordinates xs, ys [n] and int32 targets
// t [q]; cpu and hscale are float32. h must be 16-byte aligned.
extern "C" int astar_heuristic(const void* xs, const void* ys, const void* t,
                               int n, int q, float cpu, float hscale,
                               void* h, void* stream) {
  if (n > 0 && q > 0) {
    const bool vec = q % 4 == 0;
    long long resident = 0;
    const cudaError_t err =
        vec ? resident_blocks(heuristic_kernel<true>, &resident)
            : resident_blocks(heuristic_kernel<false>, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items = static_cast<long long>(n) * ((q + 3) / 4);
    const int blocks = static_cast<int>(
        min_ll(resident, (items + kThreads - 1) / kThreads));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* x = static_cast<const float*>(xs);
    const float* y = static_cast<const float*>(ys);
    const int* tt = static_cast<const int*>(t);
    int* hh = static_cast<int*>(h);
    if (vec) {
      heuristic_kernel<true><<<blocks, kThreads, 0, s>>>(x, y, tt, n, q, cpu,
                                                         hscale, hh);
    } else {
      heuristic_kernel<false><<<blocks, kThreads, 0, s>>>(x, y, tt, n, q,
                                                          cpu, hscale, hh);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// One sweep: in_nbr, w_in int32 [n, k]; deg int32 [n] (the slots before
// a row's trailing padding); h, g, hops int32 [n, q]; t int32 [q]; valid
// uint8 [q]; changed uint8 [n, q]; groups_in uint8 [n, ceil(q / 32)] (the
// any of changed over each group of 32 queries) -> g_out, hops_out int32,
// improved uint8 [n, q] and groups_out uint8 [n, ceil(q / 32)] (distinct
// buffers). skip != 0 skips the gathers that cannot improve a cell (see
// the note). Runs only if flag_in[0] != 0; then sets flag_out[0] = 1 when
// a node improved and adds the sweep's five counts into counts[0:5]
// (uint64, zeroed by the caller).
extern "C" int astar_sweep(const void* in_nbr, const void* w_in,
                           const void* deg, int n, int k, const void* h,
                           const void* t, const void* valid, int q,
                           const void* g, const void* hops,
                           const void* changed, const void* groups_in,
                           void* g_out, void* hops_out, void* improved,
                           void* groups_out, float fscale, int skip,
                           const void* flag_in, void* flag_out, void* counts,
                           void* stream) {
  if (n > 0 && q > 0 && k > 0) {
    long long resident = 0;
    const cudaError_t err = resident_blocks(sweep_kernel, &resident);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long ng = (q + 31) / 32;
    const long long per_warp = q < 32 ? 32 / q : 1;
    const long long gpb = ng < kWarps ? ng : kWarps;
    const long long span = (kWarps / gpb) * per_warp;
    const long long tiles = (n + span - 1) / span;
    const int gy = static_cast<int>(min_ll((ng + gpb - 1) / gpb, 65535));
    long long gx = min_ll((resident + gy - 1) / gy, tiles);
    if (gx < 1) gx = 1;
    sweep_kernel<<<dim3(static_cast<unsigned>(gx), gy), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(in_nbr), static_cast<const int*>(w_in),
        static_cast<const int*>(deg), n, k, static_cast<const int*>(h),
        static_cast<const int*>(t), static_cast<const uint8_t*>(valid), q,
        static_cast<const int*>(g), static_cast<const int*>(hops),
        static_cast<const uint8_t*>(changed),
        static_cast<const uint8_t*>(groups_in), static_cast<int*>(g_out),
        static_cast<int*>(hops_out), static_cast<uint8_t*>(improved),
        static_cast<uint8_t*>(groups_out), fscale, skip,
        static_cast<const int*>(flag_in), static_cast<int*>(flag_out),
        static_cast<unsigned long long*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
