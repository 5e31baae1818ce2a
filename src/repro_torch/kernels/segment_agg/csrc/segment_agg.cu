// segment_agg.cu — sorted segment sum (GNN message passing) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel segment_sum_pallas (_segment_kernel) of
// src/repro/kernels/segment_agg/segment_agg.py.  It computes
// out[n] = sum of the message rows whose sorted segment id is n, in f32,
// for n < n_out = T*TN, from:
//   seg [E] int32 ascending (ids clipped by ops.segment_sum), tile_starts
//   [T + 1] int32 (the searchsorted edge offsets of the node tiles: only
//   the edges [tile_starts[0], tile_starts[T]) are summed; ops.segment_sum
//   cuts the last boundary at num_segments, so the dropped ids, clipped to
//   num_segments and sorted last, are never read);
//   msg [E, D] f32, where sorted edge e reads row order[e] when an order
//   (the stable argsort of the ids) is given, else row e (messages already
//   sorted: the JAX kernel's staged operands).
// The output is [n_out, D] f32; every row is written, zeros for a node
// without edges.
//
// The TPU kernel turns the scatter into a one-hot [TN, KB] x [KB, D] matmul
// because the TPU has a matrix unit and no scatter, over node tiles whose
// edge ranges it DMAs in KB-row windows (hence the staged copy, padded to a
// whole spare window).  Here the ids are sorted, so each node owns a
// contiguous run of edges, and the work is cut by edges, not by nodes:
//
//   launch 1: one warp per chunk of kChunk = 64 consecutive sorted edges,
//     so every warp moves the same bytes whatever the degrees.  ring_kernel (D % 4 == 0, 16-byte aligned rows): lane 0
//     keeps up to 32 rows in flight with cp.async.bulk copies into a ring
//     of stages in shared memory (one row, or 512-float slice of a row,
//     per stage, about 24 KB per warp), each completing on its own
//     mbarrier; the warp adds each arrived row, lanes across D in float4,
//     into f32 registers and refills the stage.  rows_kernel (any other D
//     or alignment): the same walk with scalar ld.global.nc loads, 16 in
//     flight per lane.  A run that starts and ends in the chunk is written
//     to out once; the piece of a run that crosses the chunk's start or
//     end goes to a scratch row partial[chunk][0 or 1].  The zero rows of
//     the nodes without edges between two runs are written by the warp
//     that sees the id step.
//   launch 2 (carry_kernel): the warp of the chunk where a crossing run
//     starts finds (by ballot over the next chunks' ids) the chunk where
//     it ends, and adds the pieces in chunk order into out.
//
// Each piece is summed from 0.0 in edge order and the pieces are added in
// chunk order: no atomics, so the result is deterministic; no matrix unit,
// so no TF32.  segment_sum_plain follows the same order and matches bit for
// bit.
//
// What bounds it on the H100.  Each owned message row is read once, each
// id once and each output row written once: E*(4D + 4) + 4*N*D bytes,
// about 0.756 GB (0.226 ms at 3.35 TB/s) for GraphCast's processor graph
// (E = 327,660, D = 512, N = 40,962); the adds, one per message float, are
// far below the card's rate.  What this design does about the three causes
// of the node-tiled version's 3.2x gap there:
//   - bytes in flight: 5,120 warps of 64 edges (from 321 CTAs of 128 node
//     rows), each with 24 KB of copies in flight that cost no registers,
//     and no binary-search prologue before the first message byte moves;
//     at this shape 16-byte register loads (16 in flight per lane) were
//     tried first and were slower at every chunk size tried; at GAT-Cora's
//     D = 64 they were faster, but that forward is host-bound (PERF.md);
//   - hubs: a hub's run is cut at chunk boundaries like any other, so its
//     edges are summed by as many warps as it spans chunks; launch 2 adds
//     one row per chunk crossed (the partial traffic is a few % of E*D);
//   - the staging: the rows are read through `order` in place, so
//     ops.segment_sum makes no sorted or padded [E, D] copy.
// Row offsets are 64-bit (e * D overflows int32 at 2^31 floats).
// Everything runs on the caller's stream; the caller allocates the output
// and the [chunks, 2, D] scratch.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../analysis.cuh"

namespace {

using repro_analysis::kBounds;
using repro_analysis::kSync;

// The checked build: an index into seg / order / the message rows within
// the edges the call was told of (P_check_extent; 0: unknown).
__device__ __forceinline__ bool in_edges(long long e) {
#ifdef REPRO_KERNEL_CHECKS
  const long long n = repro_analysis::g_extent;
  return e >= 0 && (n <= 0 || e < n);
#else
  (void)e;
  return true;
#endif
}

constexpr int kWarps = 4;                 // warps (chunks) per CTA
constexpr int kChunk = 64;                // sorted edges per warp: must
                                          // equal segment_agg.py's CHUNK
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int W>
struct Lane;

template <>
struct Lane<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    *reinterpret_cast<float4*>(p) = v;
  }
  static __device__ __forceinline__ void add(T& a, const T& b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
};

template <>
struct Lane<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T load(const float* p) { return __ldg(p); }
  static __device__ __forceinline__ void store(float* p, const T& v) {
    *p = v;
  }
  static __device__ __forceinline__ void add(T& a, const T& b) { a += b; }
};

// The edge range of chunk c: [a, b) = [c*kChunk, (c+1)*kChunk) cut to the
// owned edges [lo, hi).
struct Range {
  int lo, hi, a, b;
  __device__ Range(const int* tile_starts, int num_tiles, int c) {
    lo = tile_starts[0];
    hi = tile_starts[num_tiles];
    KCHECK(lo >= 0 && lo <= hi && (hi == 0 || in_edges(hi - 1)), kBounds);
    const long long c0 = static_cast<long long>(c) * kChunk;
    a = static_cast<int>(c0 > lo ? c0 : lo);
    b = static_cast<int>(c0 + kChunk < hi ? c0 + kChunk : hi);
  }
};

// Lane `lane`'s V columns of one row, starting at column col0.
template <int W, int V>
__device__ __forceinline__ void store_row(float* row, int col0, int d,
                                          int lane,
                                          const typename Lane<W>::T* v) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int col = col0 + (j * 32 + lane) * W;
    if (col < d) Lane<W>::store(row + col, v[j]);
  }
}

// Zero the rows of the nodes strictly between p and q (clipped to n_out).
template <int W, int V>
__device__ __forceinline__ void zero_rows(float* out, int p, int q, int n_out,
                                          int col0, int d, int lane) {
  typename Lane<W>::T z[V];
#pragma unroll
  for (int j = 0; j < V; ++j) z[j] = Lane<W>::zero();
  const int end = q < n_out ? q : n_out;
  for (int n = (p < -1 ? -1 : p) + 1; n < end; ++n)
    store_row<W, V>(out + static_cast<long long>(n) * d, col0, d, lane, z);
}

// A chunk with no owned edge writes nothing, unless no edge is owned at all:
// then the chunk that holds position lo zeroes every row (for E = 0 that is
// the only chunk).
template <int W, int V>
__device__ __forceinline__ void zero_if_no_edges(const Range& r, float* out,
                                                 int c, int num_chunks,
                                                 int n_out,
                                                 int d, int lane) {
  const int owner =
      r.lo / kChunk < num_chunks - 1 ? r.lo / kChunk : num_chunks - 1;
  if (r.lo == r.hi && c == owner)
    for (int col0 = 0; col0 < d; col0 += 32 * V * W)
      zero_rows<W, V>(out, -1, n_out, n_out, col0, d, lane);
}

// Where a run's sum goes: the head scratch row if it is the chunk's first
// run and began before the chunk, the tail scratch row if it is the last
// and goes on past the chunk, else its output row.
__device__ __forceinline__ float* run_dst(float* out, float* head, float* tail,
                                          int node, bool first_run,
                                          bool head_cont, bool last_run,
                                          bool tail_cont, int n_out, int d) {
  if (first_run && head_cont) return head;
  if (last_run && tail_cont) return tail;
  return node >= 0 && node < n_out ? out + static_cast<long long>(node) * d
                                   : nullptr;
}

// The chunk's run boundaries, read once per chunk.
struct Runs {
  int first, prev;
  bool head_cont, tail_cont;
  __device__ Runs(const int* seg, const Range& r) {
    first = __ldg(seg + r.a);
    const int last = __ldg(seg + r.b - 1);
    prev = r.a > r.lo ? __ldg(seg + r.a - 1) : -1;
    head_cont = r.a > r.lo && prev == first;
    tail_cont = r.b < r.hi && __ldg(seg + r.b) == last;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  KCHECK(bytes % 16 == 0 && (smem_u32(dst) & 15) == 0 &&
             (reinterpret_cast<uintptr_t>(src) & 15) == 0,
         kSync);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef REPRO_KERNEL_CHECKS
  // bounded: a phase that never completes is counted, not waited on
  uint32_t done = 0;
  for (long long spin = 0; !done && spin < repro_analysis::kSpinLimit;
       ++spin) {
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
  KCHECK(done, kSync);
  return;
#endif
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

constexpr int kSlice = 512;          // floats of a row per stage
constexpr int kMaxStages = 32;       // a refill stays within two id windows
constexpr int kRingBytes = 24 << 10; // ring per warp

// Launch 1 for D % 4 == 0 and 16-byte aligned rows.  V float4 per lane
// cover a slice of up to 512 floats; wider rows take several passes.
template <int V>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const float* __restrict__ msg, const int* __restrict__ order,
            const int* __restrict__ seg, const int* __restrict__ tile_starts,
            float* __restrict__ out, float* __restrict__ partial,
            int num_tiles, int n_out, int d, int num_chunks, int stages) {
  using L = Lane<4>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x / 32;
  const int c = blockIdx.x * kWarps + w;
  if (c >= num_chunks) return;
  const Range r(tile_starts, num_tiles, c);
  if (r.a >= r.b) {
    zero_if_no_edges<4, V>(r, out, c, num_chunks, n_out, d, lane);
    return;
  }
  const int width = d < kSlice ? d : kSlice;
  CHECKED_ONLY(uint32_t dyn; asm("mov.u32 %0, %%dynamic_smem_size;"
                                 : "=r"(dyn));
               KCHECK(stages >= 1 && stages <= kMaxStages &&
                          8ull * kMaxStages * kWarps +
                                  4ull * kWarps * stages * width <=
                              dyn,
                      kBounds);
               long long started = 0;)
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem) + w * kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + 8 * kMaxStages * kWarps) +
                static_cast<long long>(w) * stages * width;
  if (lane == 0) {
    for (int st = 0; st < stages; ++st)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                       smem_u32(bar + st))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();
  const Runs runs(seg, r);
  float* head = partial + (2LL * c) * d;
  float* tail = head + d;
  const int ne = r.b - r.a;
  int q0 = 0;                    // copies consumed in earlier passes
  for (int col0 = 0; col0 < d; col0 += kSlice) {
    const int cols = d - col0 < kSlice ? d - col0 : kSlice;
    const uint32_t bytes = static_cast<uint32_t>(cols) * 4;
    // ids and rows of two windows of 32 edges: lane l holds edge
    // a + base + l (cur) and a + base + 32 + l (nxt)
    int cur_id = 0, cur_row = 0, nxt_id = 0, nxt_row = 0;
    if (lane < ne) {
      cur_id = __ldg(seg + r.a + lane);
      cur_row = order ? __ldg(order + r.a + lane) : r.a + lane;
    }
    if (32 + lane < ne) {
      nxt_id = __ldg(seg + r.a + 32 + lane);
      nxt_row = order ? __ldg(order + r.a + 32 + lane) : r.a + 32 + lane;
    }
    KCHECK(__activemask() == kFull, kSync);
    for (int i = 0; i < stages && i < ne; ++i) {
      const int row = __shfl_sync(kFull, cur_row, i);
      const int st = (q0 + i) % stages;
      if (lane == 0) {
        KCHECK(in_edges(row), kBounds);
        bulk_load(ring + st * width, msg + static_cast<long long>(row) * d +
                                         col0,
                  bytes, bar + st);
        CHECKED_ONLY(++started;)
      }
    }
    zero_rows<4, V>(out, runs.prev, runs.first, n_out, col0, d, lane);
    typename L::T acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = L::zero();
    int cur = runs.first;
    bool first_run = true;
    for (int i = 0; i < ne; ++i) {
      if (i > 0 && (i & 31) == 0) {
        cur_id = nxt_id;
        cur_row = nxt_row;
        const int e = r.a + i + 32 + lane;
        if (i + 32 + lane < ne) {
          nxt_id = __ldg(seg + e);
          nxt_row = order ? __ldg(order + e) : e;
        }
      }
      const int q = q0 + i;
      const int st = q % stages;
      mbar_wait(bar + st, (q / stages) & 1);
      typename L::T v[V];
      const float* srow = ring + st * width;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int col = (j * 32 + lane) * 4;
        v[j] = col < cols ? *reinterpret_cast<const float4*>(srow + col)
                          : L::zero();
      }
      __syncwarp();              // every lane has read the stage: refill it
      const int next = i + stages;
      const int row = __shfl_sync(
          kFull, (next >> 5) == (i >> 5) ? cur_row : nxt_row, next & 31);
      if (lane == 0 && next < ne) {
        KCHECK(in_edges(row), kBounds);
        bulk_load(ring + st * width, msg + static_cast<long long>(row) * d +
                                         col0,
                  bytes, bar + st);
        CHECKED_ONLY(++started;)
      }
      const int id = __shfl_sync(kFull, cur_id, i & 31);
      if (id != cur) {           // a run ends inside the chunk
        float* dst = run_dst(out, head, tail, cur, first_run,
                             runs.head_cont, false, false, n_out, d);
        if (dst) store_row<4, V>(dst, col0, d, lane, acc);
        zero_rows<4, V>(out, cur, id, n_out, col0, d, lane);
        cur = id;
        first_run = false;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = L::zero();
      }
#pragma unroll
      for (int j = 0; j < V; ++j) L::add(acc[j], v[j]);
    }
    float* dst = run_dst(out, head, tail, cur, first_run, runs.head_cont,
                         true, runs.tail_cont, n_out, d);
    if (dst) store_row<4, V>(dst, col0, d, lane, acc);
    if (r.b == r.hi) zero_rows<4, V>(out, cur, n_out, n_out, col0, d, lane);
    q0 += ne;
  }
  // every copy started was waited: none is in flight when the CTA exits
  if (lane == 0) KCHECK(started == q0, kSync);
}

// Launch 1 for any other D or alignment: scalar ld.global.nc loads, V
// columns per lane per pass, U edges per step (16 loads in flight a lane).
template <int V>
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ msg, const int* __restrict__ order,
            const int* __restrict__ seg, const int* __restrict__ tile_starts,
            float* __restrict__ out, float* __restrict__ partial,
            int num_tiles, int n_out, int d, int num_chunks) {
  constexpr int U = 16 / V;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= num_chunks) return;
  const Range r(tile_starts, num_tiles, c);
  if (r.a >= r.b) {
    zero_if_no_edges<1, V>(r, out, c, num_chunks, n_out, d, lane);
    return;
  }
  const Runs runs(seg, r);
  float* head = partial + (2LL * c) * d;
  float* tail = head + d;
  for (int col0 = 0; col0 < d; col0 += 32 * V) {
    zero_rows<1, V>(out, runs.prev, runs.first, n_out, col0, d, lane);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    int cur = runs.first;
    bool first_run = true;
    for (int e0 = r.a; e0 < r.b; e0 += 32) {
      const int n = r.b - e0 < 32 ? r.b - e0 : 32;
      int my_id = 0, my_row = 0;
      if (lane < n) {
        my_id = __ldg(seg + e0 + lane);
        my_row = order ? __ldg(order + e0 + lane) : e0 + lane;
      }
      for (int u0 = 0; u0 < n; u0 += U) {
        float buf[U][V];
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int row = __shfl_sync(kFull, my_row, u0 + k);
          if (u0 + k < n) KCHECK(in_edges(row), kBounds);
          const float* src = msg + static_cast<long long>(row) * d + col0;
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const int col = j * 32 + lane;
            buf[k][j] =
                (u0 + k < n && col0 + col < d) ? __ldg(src + col) : 0.0f;
          }
        }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          const int id = __shfl_sync(kFull, my_id, u0 + k);
          if (u0 + k < n) {
            if (id != cur) {     // a run ends inside the chunk
              float* dst = run_dst(out, head, tail, cur, first_run,
                                   runs.head_cont, false, false, n_out, d);
              if (dst) store_row<1, V>(dst, col0, d, lane, acc);
              zero_rows<1, V>(out, cur, id, n_out, col0, d, lane);
              cur = id;
              first_run = false;
#pragma unroll
              for (int j = 0; j < V; ++j) acc[j] = 0.0f;
            }
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] += buf[k][j];
          }
        }
      }
    }
    float* dst = run_dst(out, head, tail, cur, first_run, runs.head_cont,
                         true, runs.tail_cont, n_out, d);
    if (dst) store_row<1, V>(dst, col0, d, lane, acc);
    if (r.b == r.hi) zero_rows<1, V>(out, cur, n_out, n_out, col0, d, lane);
  }
}

template <int W, int V>
__global__ void __launch_bounds__(kThreads)
carry_kernel(const int* __restrict__ seg, const int* __restrict__ tile_starts,
             const float* __restrict__ partial, float* __restrict__ out,
             int num_tiles, int n_out, int d, int num_chunks) {
  using L = Lane<W>;
  using T = typename L::T;
  constexpr int U = 16 / V;
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + threadIdx.x / 32;
  if (c >= num_chunks) return;
  const Range r(tile_starts, num_tiles, c);
  if (r.a >= r.b || r.b >= r.hi) return;
  const int node = __ldg(seg + r.b - 1);
  // the chunk's last run goes past b and began in this chunk: this warp
  // owns it
  if (__ldg(seg + r.b) != node) return;
  if (r.a > r.lo && __ldg(seg + r.a - 1) == node) return;
  if (node < 0 || node >= n_out) return;
  // the chunk where the run ends: the first c' > c whose end is hi or
  // holds another id
  int c_end = c + 1;
  for (int base = c + 1;; base += 32) {
    const long long end = static_cast<long long>(base + lane + 1) * kChunk;
    const bool ends = end >= r.hi || __ldg(seg + end) != node;
    const unsigned m = __ballot_sync(kFull, ends);
    if (m) {
      c_end = base + __ffs(m) - 1;
      break;
    }
  }
  KCHECK(c_end > c && c_end < num_chunks, kBounds);
  float* orow = out + static_cast<long long>(node) * d;
  for (int col0 = 0; col0 < d; col0 += 32 * V * W) {
    T acc[V];
    const float* own = partial + (2LL * c + 1) * d + col0;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int col = (j * 32 + lane) * W;
      acc[j] = col0 + col < d ? L::load(own + col) : L::zero();
    }
    for (int c2 = c + 1; c2 <= c_end; c2 += U) {
      T buf[U][V];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const float* src = partial + 2LL * (c2 + k) * d + col0;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int col = (j * 32 + lane) * W;
          buf[k][j] = (c2 + k <= c_end && col0 + col < d) ? L::load(src + col)
                                                          : L::zero();
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (c2 + k <= c_end) {
#pragma unroll
          for (int j = 0; j < V; ++j) L::add(acc[j], buf[k][j]);
        }
    }
    store_row<W, V>(orow, col0, d, lane, acc);
  }
}

#define SA_K(...) {reinterpret_cast<const void*>(&__VA_ARGS__), #__VA_ARGS__}
const repro_analysis::KernelEntry kKernels[] = {
    SA_K(ring_kernel<1>),     SA_K(ring_kernel<2>),
    SA_K(ring_kernel<4>),     SA_K(rows_kernel<1>),
    SA_K(rows_kernel<2>),     SA_K(rows_kernel<4>),
    SA_K(carry_kernel<4, 1>), SA_K(carry_kernel<4, 2>),
    SA_K(carry_kernel<4, 4>), SA_K(carry_kernel<1, 1>),
    SA_K(carry_kernel<1, 2>), SA_K(carry_kernel<1, 4>),
};
#undef SA_K

using repro_analysis::LaunchLog;

struct Args {
  const float* msg;
  const int* order;
  const int* seg;
  const int* ts;
  float* out;
  float* partial;
  int num_tiles, n_out, d, num_chunks;
};

template <int V>
cudaError_t launch_ring(const Args& a, cudaStream_t s, LaunchLog* log) {
  const int blocks = (a.num_chunks + kWarps - 1) / kWarps;
  const int width = a.d < kSlice ? a.d : kSlice;
  int stages = kRingBytes / (4 * width);
  stages = stages < 2 ? 2 : stages > kMaxStages ? kMaxStages : stages;
  const size_t smem = 8 * kMaxStages * kWarps +
                      static_cast<size_t>(kWarps) * stages * width * 4;
  if (repro_analysis::dry_run(
          log, kKernels, reinterpret_cast<const void*>(&ring_kernel<V>),
          blocks, kThreads, smem)) {
    repro_analysis::dry_run(
        log, kKernels, reinterpret_cast<const void*>(&carry_kernel<4, V>),
        blocks, kThreads, 0);
    return cudaSuccess;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ring_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ring_kernel<V><<<blocks, kThreads, smem, s>>>(
      a.msg, a.order, a.seg, a.ts, a.out, a.partial, a.num_tiles, a.n_out,
      a.d, a.num_chunks, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<4, V><<<blocks, kThreads, 0, s>>>(
      a.seg, a.ts, a.partial, a.out, a.num_tiles, a.n_out, a.d, a.num_chunks);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_rows(const Args& a, cudaStream_t s, LaunchLog* log) {
  const int blocks = (a.num_chunks + kWarps - 1) / kWarps;
  if (repro_analysis::dry_run(
          log, kKernels, reinterpret_cast<const void*>(&rows_kernel<V>),
          blocks, kThreads, 0)) {
    repro_analysis::dry_run(
        log, kKernels, reinterpret_cast<const void*>(&carry_kernel<1, V>),
        blocks, kThreads, 0);
    return cudaSuccess;
  }
  rows_kernel<V><<<blocks, kThreads, 0, s>>>(
      a.msg, a.order, a.seg, a.ts, a.out, a.partial, a.num_tiles, a.n_out,
      a.d, a.num_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  carry_kernel<1, V><<<blocks, kThreads, 0, s>>>(
      a.seg, a.ts, a.partial, a.out, a.num_tiles, a.n_out, a.d, a.num_chunks);
  return cudaGetLastError();
}

// The shared host routine of sa_segment_sum; with a log it launches
// nothing and records the launches it would make (sa_launch_config).
int run_segment(const Args& a, int tn, int vec, cudaStream_t s,
                LaunchLog* log) {
  if (a.num_tiles < 0 || tn <= 0 || a.d < 0 || a.num_chunks <= 0 ||
      (vec && a.d % 4 != 0))
    return cudaErrorInvalidValue;
  if (a.n_out == 0 || a.d == 0) return cudaSuccess;
  if (!log) {  // the checked build's poison and extent (no-ops otherwise)
    cudaError_t e = repro_analysis::poison(
        a.out, static_cast<size_t>(a.n_out) * a.d * sizeof(float), s);
    if (e == cudaSuccess)
      e = repro_analysis::poison(
          a.partial, static_cast<size_t>(a.num_chunks) * 2 * a.d *
                         sizeof(float), s);
    if (e == cudaSuccess) e = repro_analysis::push_extent(s);
    if (e != cudaSuccess) return e;
  }
  // V: float4 (ring) or floats (scalar) per lane per pass, 1, 2 or 4
  const int per = vec ? 128 : 32;
  const int v = a.d <= per ? 1 : a.d <= 2 * per ? 2 : 4;
  cudaError_t err;
  if (vec)
    err = v == 1 ? launch_ring<1>(a, s, log)
                 : v == 2 ? launch_ring<2>(a, s, log)
                          : launch_ring<4>(a, s, log);
  else
    err = v == 1 ? launch_rows<1>(a, s, log)
                 : v == 2 ? launch_rows<2>(a, s, log)
                          : launch_rows<4>(a, s, log);
  return static_cast<int>(err);
}

}  // namespace

REPRO_ANALYSIS_EXPORTS(sa, kKernels)

extern "C" {

// The launches one call makes for rows of d floats over num_chunks chunks
// (num_tiles * tn output rows), without launching (see hm_launch_config):
// 4 ints a launch in rows, at most cap; returns the count or minus a
// cudaError_t.
int sa_launch_config(int num_tiles, int tn, int d, int num_chunks, int vec,
                     int* rows, int cap) {
  const long long n_out = static_cast<long long>(num_tiles) * tn;
  if (n_out > 0x7fffffffLL) return -cudaErrorInvalidValue;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               num_tiles, static_cast<int>(n_out), d, num_chunks};
  LaunchLog log{rows, cap, 0};
  const int e = run_segment(a, tn, vec, nullptr, &log);
  return e != 0 ? -e : log.n;
}

const char* sa_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// msg [E, d] f32; order [E] int32 rows of msg, or null (row e); seg [E]
// int32 ascending; tile_starts [num_tiles + 1] int32; out [num_tiles * tn,
// d] f32; partial [num_chunks, 2, d] f32 scratch; all contiguous.
// num_chunks = max(1, ceil(E / kChunk)).  vec = 1 when d % 4 == 0 and msg,
// out and partial are 16-byte aligned (the ring kernel), else 0 (the
// scalar kernel).  Two launches; returns a cudaError_t (0 on success).
int sa_segment_sum(void* msg, void* order, void* seg, void* tile_starts,
                   void* out, void* partial, int num_tiles, int tn, int d,
                   int num_chunks, int vec, void* stream) {
  if (num_tiles < 0 || tn <= 0) return cudaErrorInvalidValue;
  const long long n_out = static_cast<long long>(num_tiles) * tn;
  if (n_out > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(msg), static_cast<const int*>(order),
               static_cast<const int*>(seg),
               static_cast<const int*>(tile_starts), static_cast<float*>(out),
               static_cast<float*>(partial), num_tiles,
               static_cast<int>(n_out), d, num_chunks};
  return run_segment(a, tn, vec, static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
