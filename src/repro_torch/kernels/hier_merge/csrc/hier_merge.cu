// hier_merge.cu — canonical-segment merge kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/hier_merge/hier_merge.py:
//   merge_multi_pallas (_merge_multi_kernel) -> hm_merge_multi: one unsorted
//       block plus k canonical runs (the fused spill cascade);
//   merge_pallas (_merge_kernel)             -> hm_merge: two canonical
//       segments (the layered cascade).
// Both produce what the TPU kernels produce, at the summed input length N
// (any N, no power-of-two rule): the canonical segment (live prefix sorted by
// signed lexicographic (hi, lo), duplicates combined under the semiring, a
// (SENTINEL, SENTINEL, zero) tail) and nnz.  Keys stay signed int32 pairs
// and are compared as pairs, never packed.
//
// What bounds it on the H100.  A merge must read and write 12 bytes per entry
// (0.47 MB at the main path's N = 19456: 0.14 us at 3.35 TB/s), and a merge
// of sorted runs needs only a linear pass.  At these sizes neither is close:
// what a call costs is its launches and the latency of the dependent steps
// inside them (global loads of a search, barriers, the look-back across
// tiles), and the sort of the unsorted block if it runs on one SM.  The TPU
// kernels ran one VMEM-sized bitonic network over the whole padded sequence;
// this design does the least dependent work in the fewest launches instead:
//
//   launch 1  prepare_kernel.  The unsorted block is cut into chunks of
//             kRankCap = 4096 entries (the main path's 3072 is one) and
//             rank-sorted: each CTA takes 32 entries of a chunk, stages the
//             chunk's keys in shared memory as order-preserving 64-bit words,
//             and its 32 warps each count, over one slice of the chunk, the
//             keys before each entry in (key, index) order; the sum is the
//             entry's stable rank, and the entry is written there.  That is
//             n^2 compares, but spread over n / 32 CTAs (96 at 3072) with no
//             barrier chain: a bitonic network in one CTA's shared memory,
//             the first version of this design, was most of the call's
//             device time (78 dependent stages on one SM).  The launch's
//             other CTAs fill the output with the sentinel tail and zero the
//             look-back state, so the merge never has to find where the tail
//             starts.
//   launch 2+ merge_kernel, merge-path partitioned.  Each CTA owns kTile =
//             256 output positions (76 CTAs at N = 19456, 128 at 32768).  Two
//             warps find the CTA's start and end diagonals by a 32-way search
//             (three rounds of global loads at these sizes); the CTA loads its
//             slices of both operands and every thread merges its own
//             position in shared memory.  With more than two sorted operands
//             (chunks of a large block, k > 1 runs) they are folded left
//             through this kernel into scratch; only the last pass combines:
//             it flags run heads (one key read before and after the tile),
//             scans (head seen, value) and counts kept entries (run-last, not
//             SENTINEL) per tile, and gets the carry of a run entering the
//             tile and its output offset from a single-pass decoupled
//             look-back over one 64-bit status word per tile (status 2 bits,
//             head seen 1 bit, keep count 29 bits, value 32 bits), with tile
//             ids from an atomic ticket so a tile waits only on tiles that
//             have started.  Kept entries go straight to their compacted
//             slots; the last tile writes nnz.
//
// So merge_multi at k = 1 is 2 launches and the pairwise merge 2 (launch 1
// without rank CTAs), against 13 and 10 for the bitonic design this
// replaces.  Everything runs on the caller's stream with no host
// synchronisation; the caller allocates one buffer for the outputs and nnz
// (2N + 1 words of keys and nnz, then N values) and one for the scratch
// (hm_scratch_words), which it may free once the call is enqueued, and makes
// one call.
//
// Values.  float32, int32, float16 or bfloat16, as the reference's kernel
// route takes any dtype.  Every pass moves a value as its storage word (32
// or 16 bits); only the combine reads it as a number.  A 16-bit add widens
// both operands to float32 and rounds the sum back once, as PyTorch adds
// two 16-bit tensors, so each add rounds to 16 bits like the reference's
// combine in the value dtype; max and min compare the widened values.
//
// Limits.  N < 2^29 (keep counts fill 29 bits of a status word), and at
// most kMaxOperands = 256 sorted operands: the block's 4,096-entry chunks
// plus the non-empty runs.  Past that the call returns cudaErrorInvalidValue
// (the wrapper refuses such operands first).  Each operand past the second
// adds a merge pass over the growing prefix, so the cost of a block rises
// with the square of its chunks: the route rule keeps the main path at one
// chunk and one run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../../analysis.cuh"

namespace {

using repro_analysis::kBounds;
using repro_analysis::kSync;

constexpr int kTile = 256;           // output positions per merge CTA
constexpr int kPrepThreads = 1024;
constexpr int kRankCap = 4096;       // entries of one rank-sorted chunk
constexpr int kGroupsPerChunk = kRankCap / 32;  // rank CTAs of a full chunk
constexpr int kInitPerCta = 8192;    // output entries one init CTA fills
constexpr int kSentinel = INT_MAX;
constexpr int kMaxTotal = 1 << 29;   // keep counts fit 29 bits of a status word
constexpr int kMaxOperands = 256;    // sorted operands of one call (the wrapper's
                                     // MAX_SORTED_OPERANDS)
constexpr unsigned kFull = 0xffffffffu;

#define HM_CHECK()                                   \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return e_;                \
  } while (0)

__device__ __forceinline__ bool lex_gt(int ha, int la, int hb, int lb) {
  return ha > hb || (ha == hb && la > lb);
}

// A value type's storage word S and its bit casts; the status words, the
// shuffles and the zero carry a value as its bits, zero-extended to 32.
template <typename V> struct Val;
template <> struct Val<float> {
  using S = uint32_t;
  __device__ static float of(uint32_t b) { return __uint_as_float(b); }
  __device__ static uint32_t bits(float v) { return __float_as_uint(v); }
};
template <> struct Val<int> {
  using S = uint32_t;
  __device__ static int of(uint32_t b) { return static_cast<int>(b); }
  __device__ static uint32_t bits(int v) { return static_cast<uint32_t>(v); }
};
template <> struct Val<__half> {
  using S = uint16_t;
  __device__ static __half of(uint32_t b) {
    return __ushort_as_half(static_cast<unsigned short>(b));
  }
  __device__ static uint32_t bits(__half v) { return __half_as_ushort(v); }
  __device__ static float wide(__half v) { return __half2float(v); }
  __device__ static __half narrow(float f) { return __float2half_rn(f); }
};
template <> struct Val<__nv_bfloat16> {
  using S = uint16_t;
  __device__ static __nv_bfloat16 of(uint32_t b) {
    return __ushort_as_bfloat16(static_cast<unsigned short>(b));
  }
  __device__ static uint32_t bits(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
  __device__ static float wide(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 narrow(float f) {
    return __float2bfloat16_rn(f);
  }
};

// ------------------------------------------------------------ launch 1 ----

// The order of signed lexicographic (hi, lo) as one unsigned 64-bit key.
__device__ __forceinline__ unsigned long long order_key(int h, int l) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(h) ^
                                          0x80000000u) << 32) |
         (static_cast<uint32_t>(l) ^ 0x80000000u);
}

// One CTA of a chunk's rank sort: the rank of each of its 32 entries is the
// count of the chunk's entries before it in (key, index) order (so the sort
// is stable and SENTINEL keys go last); each warp counts over one slice of
// the chunk's keys, staged in shared memory, and warp 0 sums the slices and
// writes each entry to its rank.
template <typename S>
__device__ void rank_group(const int* __restrict__ bh,
                           const int* __restrict__ bl,
                           const S* __restrict__ bv, int len, int group,
                           int* __restrict__ sh, int* __restrict__ sl,
                           S* __restrict__ sv) {
  __shared__ unsigned long long s_key[kRankCap];
  __shared__ int s_cnt[kPrepThreads / 32][32];
  static_assert(sizeof(s_key) + sizeof(s_cnt) <= 48 * 1024,
                "a chunk's rank tiles exceed static shared memory");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  KCHECK(len >= 0 && len <= kRankCap, kBounds);
  for (int j = t; j < len; j += blockDim.x) s_key[j] = order_key(bh[j], bl[j]);
  __syncthreads();
  const int i = group * 32 + lane;
  const unsigned long long ki = i < len ? s_key[i] : ~0ull;
  const int per = (len + kPrepThreads / 32 - 1) / (kPrepThreads / 32);
  const int j0 = warp * per, j1 = min(j0 + per, len);
  int cnt = 0;
#pragma unroll 4
  for (int j = j0; j < j1; ++j) {
    const unsigned long long kj = s_key[j];
    cnt += (kj < ki) | ((kj == ki) & (j < i));
  }
  s_cnt[warp][lane] = cnt;
  __syncthreads();
  if (warp == 0 && i < len) {
    int rank = 0;
#pragma unroll
    for (int w = 0; w < kPrepThreads / 32; ++w) rank += s_cnt[w][lane];
    KCHECK(rank >= 0 && rank < len, kBounds);
    sh[rank] = bh[i];
    sl[rank] = bl[i];
    sv[rank] = bv[i];
  }
}

// CTAs [0, n_rank) rank-sort the block's chunks into (sh, sl, sv), 32
// entries each; the others fill out[0, n_out) with SENTINEL / zero and zero
// the look-back state.
template <typename S>
__global__ void __launch_bounds__(kPrepThreads)
prepare_kernel(const int* __restrict__ bh, const int* __restrict__ bl,
               const S* __restrict__ bv, int n_block, int n_rank,
               int* __restrict__ sh, int* __restrict__ sl,
               S* __restrict__ sv, int* __restrict__ oh,
               int* __restrict__ ol, S* __restrict__ ov, int n_out,
               S zero_bits, unsigned long long* __restrict__ state,
               int n_state) {
  const int b = blockIdx.x;
  if (b < n_rank) {
    const int off = b / kGroupsPerChunk * kRankCap;
    rank_group(bh + off, bl + off, bv + off, min(kRankCap, n_block - off),
               b % kGroupsPerChunk, sh + off, sl + off, sv + off);
    return;
  }
  const int stride = (gridDim.x - n_rank) * blockDim.x;
  const int first = (b - n_rank) * blockDim.x + threadIdx.x;
  for (int i = first; i < n_out; i += stride) {
    oh[i] = kSentinel;
    ol[i] = kSentinel;
    ov[i] = zero_bits;
  }
  for (int i = first; i < n_state; i += stride) state[i] = 0ull;
}

// ------------------------------------------------------------ launch 2+ ---

// The semiring's add; its zero is the identity, which the scans rely on.
// 16-bit values (the primary templates) go through float32: one rounding
// per add, and max / min of the widened values.
template <typename V, int Kind> struct Combine {
  __device__ static V f(V a, V b) {
    const float x = Val<V>::wide(a), y = Val<V>::wide(b);
    if (Kind == 0) return Val<V>::narrow(x + y);
    return (Kind == 1 ? x > y : x < y) ? a : b;
  }
};
template <> struct Combine<float, 0> {
  __device__ static float f(float a, float b) { return a + b; }
};
template <> struct Combine<int, 0> {  // wraps like the reference's int32 add
  __device__ static int f(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
};
template <> struct Combine<float, 1> {
  __device__ static float f(float a, float b) { return a > b ? a : b; }
};
template <> struct Combine<int, 1> {
  __device__ static int f(int a, int b) { return a > b ? a : b; }
};
template <> struct Combine<float, 2> {
  __device__ static float f(float a, float b) { return a < b ? a : b; }
};
template <> struct Combine<int, 2> {
  __device__ static int f(int a, int b) { return a < b ? a : b; }
};

// A tile's status word: [63:62] status (0 none, 1 aggregate, 2 inclusive
// prefix), [61] head seen, [60:32] keep count, [31:0] value bits.
__device__ __forceinline__ unsigned long long pack(unsigned status, int f,
                                                   int c, uint32_t v) {
  const unsigned long long top = (static_cast<unsigned long long>(status)
                                  << 30) |
                                 (static_cast<unsigned long long>(f) << 29) |
                                 static_cast<unsigned>(c);
  return (top << 32) | v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Merge-path diagonal d of A ++ B (A first on equal keys), by one warp: the
// count of A's entries among the first d outputs.  A 32-way search: each
// round every lane tests one candidate, so ~log32 of the range in rounds.
__device__ int diagonal(const int* __restrict__ ah, const int* __restrict__ al,
                        int na, const int* __restrict__ bh,
                        const int* __restrict__ bl, int nb, int d, int lane) {
  KCHECK(__activemask() == kFull, kSync);
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int x = lo + lane * step;
    bool after = false;  // A[x] comes after B[d - 1 - x]
    if (x < hi) {
      const int y = d - 1 - x;
      after = lex_gt(ah[x], al[x], bh[y], bl[y]);
    }
    const unsigned ball = __ballot_sync(kFull, after);
    if (ball == 0) {
      lo += step * ((hi - 1 - lo) / step) + 1;
    } else {
      const int f = __ffs(ball) - 1;
      if (f == 0) {
        hi = lo;
      } else {
        hi = lo + f * step;
        lo += (f - 1) * step + 1;
      }
    }
  }
  return lo;
}

// One merge pass of sorted A and B into positions [0, na + nb).  Without
// kCombine it writes the merged sequence; with it, the canonical segment.
template <bool kCombine, typename V, int Kind>
__global__ void __launch_bounds__(kTile)
merge_kernel(const int* __restrict__ ah, const int* __restrict__ al,
             const typename Val<V>::S* __restrict__ av, int na,
             const int* __restrict__ bh, const int* __restrict__ bl,
             const typename Val<V>::S* __restrict__ bv, int nb,
             int* __restrict__ oh, int* __restrict__ ol,
             typename Val<V>::S* __restrict__ ov,
             unsigned long long* __restrict__ state, int* __restrict__ nnz,
             uint32_t zero_bits) {
  using S = typename Val<V>::S;
  __shared__ int s_h[kTile], s_l[kTile];
  __shared__ S s_v[kTile];
  __shared__ int m_h[kTile + 2], m_l[kTile + 2];
  __shared__ int s_diag[2], s_tile, s_keep[kTile / 32], s_wf[kTile / 32];
  __shared__ uint32_t s_wv[kTile / 32];  // value bits
  __shared__ int s_pc, s_agg_f;
  __shared__ uint32_t s_pv, s_agg_v;
  static_assert(sizeof(s_h) + sizeof(s_l) + sizeof(s_v) + sizeof(m_h) +
                        sizeof(m_l) + sizeof(s_keep) + sizeof(s_wf) +
                        sizeof(s_wv) + 64 <= 48 * 1024,
                "a merge tile exceeds static shared memory");

  const int n = na + nb;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (kCombine) {
    if (t == 0) s_tile = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned*>(state), 1u));
    __syncthreads();
  }
  const int tile = kCombine ? s_tile : blockIdx.x;
  KCHECK(tile >= 0 && tile < static_cast<int>(gridDim.x), kBounds);
  const int s = tile * kTile;
  const int e = min(s + kTile, n);
  if (warp < 2) {
    const int x = diagonal(ah, al, na, bh, bl, nb, warp ? e : s, lane);
    if (lane == 0) s_diag[warp] = x;
  }
  __syncthreads();
  const int a0 = s_diag[0], a1 = s_diag[1];
  const int b0 = s - a0, b1 = e - a1;
  const int ca = a1 - a0, cnt = e - s, cb = cnt - ca;
  if (t == 0)
    KCHECK(a0 >= 0 && a0 <= a1 && a1 <= na && b0 >= 0 && b0 <= b1 &&
               b1 <= nb && cnt >= 0 && cnt <= kTile,
           kBounds);
  if (t < ca) {
    s_h[t] = ah[a0 + t]; s_l[t] = al[a0 + t]; s_v[t] = av[a0 + t];
  } else if (t < cnt) {
    const int y = b0 + t - ca;
    s_h[t] = bh[y]; s_l[t] = bl[y]; s_v[t] = bv[y];
  }
  if (kCombine && t == 0 && s > 0) {  // the key at position s - 1
    int h = INT_MIN, l = INT_MIN;
    if (a0 > 0) { h = ah[a0 - 1]; l = al[a0 - 1]; }
    if (b0 > 0 && lex_gt(bh[b0 - 1], bl[b0 - 1], h, l)) {
      h = bh[b0 - 1]; l = bl[b0 - 1];
    }
    m_h[0] = h; m_l[0] = l;
  }
  if (kCombine && t == 1 && e < n) {  // the key at position e
    int h = kSentinel, l = kSentinel;
    bool any = false;
    if (a1 < na) { h = ah[a1]; l = al[a1]; any = true; }
    if (b1 < nb && (!any || lex_gt(h, l, bh[b1], bl[b1]))) {
      h = bh[b1]; l = bl[b1];
    }
    m_h[cnt + 1] = h; m_l[cnt + 1] = l;
  }
  __syncthreads();

  // This thread's output position s + t: diagonal t of the two slices.
  int h = kSentinel, l = kSentinel;
  S vb = static_cast<S>(zero_bits);
  if (t < cnt) {
    int lo = max(0, t - cb), hi = min(t, ca);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int y = ca + t - 1 - mid;
      if (lex_gt(s_h[mid], s_l[mid], s_h[y], s_l[y])) hi = mid;
      else lo = mid + 1;
    }
    const int y = t - lo;
    const bool take_a =
        lo < ca && (y >= cb || !lex_gt(s_h[lo], s_l[lo], s_h[ca + y],
                                       s_l[ca + y]));
    const int src = take_a ? lo : ca + y;
    KCHECK(src >= 0 && src < cnt, kBounds);
    h = s_h[src]; l = s_l[src]; vb = s_v[src];
  }
  if (!kCombine) {
    if (t < cnt) { oh[s + t] = h; ol[s + t] = l; ov[s + t] = vb; }
    return;
  }

  if (t < cnt) { m_h[t + 1] = h; m_l[t + 1] = l; }
  __syncthreads();
  const int pos = s + t;
  const bool live = t < cnt;
  const bool head = live && (pos == 0 || m_h[t] != h || m_l[t] != l);
  const bool last = live && (pos == n - 1 || m_h[t + 2] != h ||
                             m_l[t + 2] != l);
  const bool keep = last && h != kSentinel;
  const V zero = Val<V>::of(zero_bits);

  // Tile-local segmented inclusive scan of (head seen, value).
  KCHECK(__activemask() == kFull, kSync);
  int f = head;
  V v = live ? Val<V>::of(vb) : zero;
  for (int d = 1; d < 32; d <<= 1) {
    const int pf = __shfl_up_sync(kFull, f, d);
    const V pv = Val<V>::of(__shfl_up_sync(kFull, Val<V>::bits(v), d));
    if (lane >= d) {
      if (!f) v = Combine<V, Kind>::f(pv, v);
      f |= pf;
    }
  }
  const unsigned kb = __ballot_sync(kFull, keep);
  if (lane == 31) {
    s_wf[warp] = f;
    s_wv[warp] = Val<V>::bits(v);
    s_keep[warp] = __popc(kb);
  }
  __syncthreads();
  int cf = 0, ck = 0, total_keep = 0;
  V cv = zero;
  for (int w = 0; w < kTile / 32; ++w) {
    if (w < warp) {
      const V wv = Val<V>::of(s_wv[w]);
      cv = s_wf[w] ? wv : Combine<V, Kind>::f(cv, wv);
      cf |= s_wf[w];
      ck += s_keep[w];
    }
    total_keep += s_keep[w];
  }
  if (!f) v = Combine<V, Kind>::f(cv, v);
  f |= cf;
  const int dest_in_tile = ck + __popc(kb & ((1u << lane) - 1u));

  // The last warp holds the tile's aggregate; warp 0 publishes and looks back.
  if (t == kTile - 1) { s_agg_f = f; s_agg_v = Val<V>::bits(v); }
  __syncthreads();
  if (warp == 0) {
    KCHECK(__activemask() == kFull, kSync);
    if (lane == 0) KCHECK(tile < (n + kTile - 1) / kTile, kBounds);
    const int agg_f = s_agg_f;
    const V agg_v = Val<V>::of(s_agg_v);
    unsigned long long* status = state + 1;
    int pf = 0, pc = 0;
    V pv = zero;
    if (tile == 0) {
      if (lane == 0) store_status(status, pack(2, agg_f, total_keep,
                                               Val<V>::bits(agg_v)));
    } else {
      if (lane == 0) store_status(status + tile, pack(1, agg_f, total_keep,
                                                      Val<V>::bits(agg_v)));
      // running (pf, pv, pc): tiles (base, tile) folded, earliest first
      for (int base = tile - 1;; base -= 32) {
        const int j = base - lane;
        // before tile 0: an inclusive prefix of nothing
        unsigned long long w = pack(2, 0, 0, Val<V>::bits(zero));
        if (j >= 0) {
#ifdef REPRO_KERNEL_CHECKS
          // bounded: a tile that never publishes is counted, not waited on
          long long spins = 0;
          do {
            w = load_status(status + j);
          } while ((w >> 62) == 0 && ++spins < repro_analysis::kSpinLimit);
          KCHECK((w >> 62) != 0, kSync);
          if ((w >> 62) == 0) w = pack(2, 0, 0, Val<V>::bits(zero));
#else
          do {
            w = load_status(status + j);
          } while ((w >> 62) == 0);
#endif
        }
        const unsigned incl = __ballot_sync(kFull, (w >> 62) == 2);
        const int g = incl ? __ffs(incl) - 1 : 31;
        int wf = 0, wc = 0;
        V wv = zero;
        for (int q = g; q >= 0; --q) {
          const unsigned long long x = __shfl_sync(kFull, w, q);
          const int xf = static_cast<int>((x >> 61) & 1);
          const V xv = Val<V>::of(static_cast<uint32_t>(x));
          wv = xf ? xv : Combine<V, Kind>::f(wv, xv);
          wf |= xf;
          wc += static_cast<int>((x >> 32) & (kMaxTotal - 1));
        }
        pv = pf ? pv : Combine<V, Kind>::f(wv, pv);
        pf |= wf;
        pc += wc;
        if (incl) break;
      }
      if (lane == 0) {
        const V inc_v = agg_f ? agg_v : Combine<V, Kind>::f(pv, agg_v);
        store_status(status + tile, pack(2, pf | agg_f, pc + total_keep,
                                         Val<V>::bits(inc_v)));
      }
    }
    if (lane == 0) {
      s_pc = pc;
      s_pv = Val<V>::bits(pv);
      if (tile == (n - 1) / kTile) *nnz = pc + total_keep;
    }
  }
  __syncthreads();
  if (keep) {
    const int dest = s_pc + dest_in_tile;
    KCHECK(dest >= 0 && dest < n, kBounds);
    oh[dest] = h;
    ol[dest] = l;
    ov[dest] = static_cast<S>(
        Val<V>::bits(f ? v : Combine<V, Kind>::f(Val<V>::of(s_pv), v)));
  }
}

// ---------------------------------------------------------------- host ----

#define HM_K(...) {reinterpret_cast<const void*>(&__VA_ARGS__), #__VA_ARGS__}
// Every kernel instantiation (palkit's hm_kernel_attrs and the kernel index
// of hm_launch_config).
const repro_analysis::KernelEntry kKernels[] = {
    HM_K(prepare_kernel<uint32_t>),
    HM_K(prepare_kernel<uint16_t>),
    HM_K(merge_kernel<false, float, 0>),
    HM_K(merge_kernel<false, int, 0>),
    HM_K(merge_kernel<false, __half, 0>),
    HM_K(merge_kernel<false, __nv_bfloat16, 0>),
    HM_K(merge_kernel<true, float, 0>),
    HM_K(merge_kernel<true, float, 1>),
    HM_K(merge_kernel<true, float, 2>),
    HM_K(merge_kernel<true, int, 0>),
    HM_K(merge_kernel<true, int, 1>),
    HM_K(merge_kernel<true, int, 2>),
    HM_K(merge_kernel<true, __half, 0>),
    HM_K(merge_kernel<true, __half, 1>),
    HM_K(merge_kernel<true, __half, 2>),
    HM_K(merge_kernel<true, __nv_bfloat16, 0>),
    HM_K(merge_kernel<true, __nv_bfloat16, 1>),
    HM_K(merge_kernel<true, __nv_bfloat16, 2>),
};
#undef HM_K

using repro_analysis::LaunchLog;

template <typename S> struct Operand {
  const int* h;
  const int* l;
  const S* v;
  int n;
};

int num_tiles(int n) { return (n + kTile - 1) / kTile; }
int num_chunks(int n) { return (n + kRankCap - 1) / kRankCap; }

// The outputs are hi and lo at [0, N) and [N, 2N) of one buffer of int32
// words, nnz at 2N, and the N values from word 2N + 1 on, each in its own
// width (4 or 2 bytes).  The scratch, a second buffer (8-byte aligned), is
// [state: ticket + a status word per tile][the sorted block][two ping-pong
// buffers of N entries when the fold has 2+ passes], 3 words an entry
// whatever the value's width.
int num_passes(int block_len, int n_sorted) {
  const int ops = num_chunks(block_len) + n_sorted;
  return ops > 2 ? ops - 1 : 1;
}

size_t state_words(int total) {
  return 2 * (1 + static_cast<size_t>(num_tiles(total)));
}

size_t scratch_words(int block_len, int total, int n_sorted) {
  size_t words = state_words(total) + 3 * static_cast<size_t>(block_len);
  if (num_passes(block_len, n_sorted) > 1) {
    words += 6 * static_cast<size_t>(total);
  }
  return words;
}

template <bool kCombine, typename V, int Kind, typename S>
cudaError_t launch_merge(const Operand<S>& a, const Operand<S>& b, int* oh,
                         int* ol, S* ov, unsigned long long* state, int* nnz,
                         uint32_t zero_bits, cudaStream_t s, LaunchLog* log) {
  if (repro_analysis::dry_run(
          log, kKernels,
          reinterpret_cast<const void*>(&merge_kernel<kCombine, V, Kind>),
          num_tiles(a.n + b.n), kTile, 0))
    return cudaSuccess;
  merge_kernel<kCombine, V, Kind><<<num_tiles(a.n + b.n), kTile, 0, s>>>(
      a.h, a.l, a.v, a.n, b.h, b.l, b.v, b.n, oh, ol, ov, state, nnz,
      zero_bits);
  HM_CHECK();
  return cudaSuccess;
}

template <typename V, typename S>
cudaError_t launch_combine(int kind, const Operand<S>& a, const Operand<S>& b,
                           int* oh, int* ol, S* ov, unsigned long long* state,
                           int* nnz, uint32_t zero_bits, cudaStream_t s,
                           LaunchLog* log) {
  switch (kind) {
    case 0:
      return launch_merge<true, V, 0>(a, b, oh, ol, ov, state, nnz, zero_bits,
                                      s, log);
    case 1:
      return launch_merge<true, V, 1>(a, b, oh, ol, ov, state, nnz, zero_bits,
                                      s, log);
    case 2:
      return launch_merge<true, V, 2>(a, b, oh, ol, ov, state, nnz, zero_bits,
                                      s, log);
  }
  return cudaErrorInvalidValue;
}

// The shared host routine for values of type V: src holds (hi, lo, val)
// pointers per source; source 0 is the block (unsorted unless
// first_sorted), sources 1.. are canonical runs.  With a log it launches
// nothing and records the launches it would make (hm_launch_config).
template <typename V>
int merge_values(const void* const* src, const int* src_len, int n_src,
                 int first_sorted, void* out, void* scratch, int sr_kind,
                 uint32_t zero_bits, cudaStream_t s, LaunchLog* log) {
  using S = typename Val<V>::S;
  long long sum = 0;
  for (int r = 0; r < n_src; ++r) {
    if (src_len[r] < 0) return cudaErrorInvalidValue;
    sum += src_len[r];
  }
  if (sum >= kMaxTotal) return cudaErrorInvalidValue;
  const int total = static_cast<int>(sum);
  int* oh = static_cast<int*>(out);
  int* ol = oh + total;
  int* cnt = oh + 2 * total;
  S* ov = reinterpret_cast<S*>(cnt + 1);
  if (total == 0) return log ? cudaSuccess : cudaMemsetAsync(cnt, 0, sizeof(int), s);
  if (!log) {  // the checked build's poison (a no-op in production)
    const int n_sorted = first_sorted ? n_src : n_src - 1;
    const int blen = first_sorted ? 0 : src_len[0];
    cudaError_t e = repro_analysis::poison(
        out, (2 * static_cast<size_t>(total) + 1) * 4 + total * sizeof(S), s);
    if (e == cudaSuccess)
      e = repro_analysis::poison(scratch,
                                 scratch_words(blen, total, n_sorted) * 4, s);
    if (e != cudaSuccess) return e;
  }
  unsigned long long* state = static_cast<unsigned long long*>(scratch);
  const int n_state = 1 + num_tiles(total);
  int* sorted = reinterpret_cast<int*>(state) + state_words(total);
  auto ptr = [src](int r, int j) { return src[3 * r + j]; };

  const int block_len = first_sorted ? 0 : src_len[0];
  const int chunks = num_chunks(block_len);
  const int n_rank = chunks ? (chunks - 1) * kGroupsPerChunk +
                                  (block_len - (chunks - 1) * kRankCap + 31) /
                                      32
                            : 0;
  const int inits = (total + kInitPerCta - 1) / kInitPerCta;
  int* sh = sorted;
  int* sl = sorted + block_len;
  S* sv = reinterpret_cast<S*>(sorted + 2 * block_len);

  // The sorted operands, left to right; empty ones drop out of the fold.
  Operand<S> ops[kMaxOperands];
  int n_ops = 0;
  for (int c = 0; c < chunks && n_ops < kMaxOperands; ++c) {
    const int off = c * kRankCap;
    ops[n_ops++] = {sh + off, sl + off, sv + off,
                    block_len - off < kRankCap ? block_len - off : kRankCap};
  }
  for (int r = first_sorted ? 0 : 1; r < n_src; ++r) {
    if (src_len[r] == 0) continue;
    if (n_ops == kMaxOperands) return cudaErrorInvalidValue;
    ops[n_ops++] = {static_cast<const int*>(ptr(r, 0)),
                    static_cast<const int*>(ptr(r, 1)),
                    static_cast<const S*>(ptr(r, 2)), src_len[r]};
  }
  if (chunks > kMaxOperands) return cudaErrorInvalidValue;
  if (n_ops == 1) ops[n_ops++] = {nullptr, nullptr, nullptr, 0};

  if (!repro_analysis::dry_run(
          log, kKernels, reinterpret_cast<const void*>(&prepare_kernel<S>),
          n_rank + inits, kPrepThreads, 0)) {
    prepare_kernel<S><<<n_rank + inits, kPrepThreads, 0, s>>>(
        static_cast<const int*>(ptr(0, 0)), static_cast<const int*>(ptr(0, 1)),
        static_cast<const S*>(ptr(0, 2)), block_len, n_rank, sh, sl, sv, oh,
        ol, ov, total, static_cast<S>(zero_bits), state, n_state);
    HM_CHECK();
  }

  int* tmp = sorted + 3 * block_len;
  Operand<S> acc = ops[0];
  for (int i = 1; i < n_ops; ++i) {
    const Operand<S>& b = ops[i];
    if (i == n_ops - 1) {
      return launch_combine<V>(sr_kind, acc, b, oh, ol, ov, state, cnt,
                               zero_bits, s, log);
    }
    int* th = tmp + ((i - 1) & 1) * 3 * total;
    const int n = acc.n + b.n;
    S* tv = reinterpret_cast<S*>(th + 2 * n);
    cudaError_t e = launch_merge<false, V, 0>(acc, b, th, th + n, tv, state,
                                              cnt, zero_bits, s, log);
    if (e != cudaSuccess) return e;
    acc = {th, th + n, tv, n};
  }
  return cudaErrorInvalidValue;  // unreachable: the fold ends in a combine
}

// vtype: 0 float32, 1 int32, 2 float16, 3 bfloat16 (the wrapper's _VTYPE).
int run_merge(const void* const* src, const int* src_len, int n_src,
              int first_sorted, void* out, void* scratch, int sr_kind,
              int vtype, int zero_bits, void* stream,
              LaunchLog* log = nullptr) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_src < 1 || sr_kind < 0 || sr_kind > 2) return cudaErrorInvalidValue;
  const uint32_t z = static_cast<uint32_t>(zero_bits);
  switch (vtype) {
    case 0:
      return merge_values<float>(src, src_len, n_src, first_sorted, out,
                                 scratch, sr_kind, z, s, log);
    case 1:
      return merge_values<int>(src, src_len, n_src, first_sorted, out,
                               scratch, sr_kind, z, s, log);
    case 2:
      return merge_values<__half>(src, src_len, n_src, first_sorted, out,
                                  scratch, sr_kind, z, s, log);
    case 3:
      return merge_values<__nv_bfloat16>(src, src_len, n_src, first_sorted,
                                         out, scratch, sr_kind, z, s, log);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

REPRO_ANALYSIS_EXPORTS(hm, kKernels)

extern "C" {

// The launches of one merge of n_src operands of lengths src_len
// (first_sorted: 1 for the pairwise merge, 0 when source 0 is the unsorted
// block), without launching: 4 ints a launch in rows (kernel index in
// hm_kernel_attrs, grid, block, dynamic shared bytes), at most cap.
// Returns the number of launches, or minus a cudaError_t.
int hm_launch_config(const int* src_len, int n_src, int first_sorted,
                     int sr_kind, int vtype, int* rows, int cap) {
  if (n_src < 1 || n_src > kMaxOperands + 1) return -cudaErrorInvalidValue;
  static const void* const kNull[3 * (kMaxOperands + 1)] = {};
  LaunchLog log{rows, cap, 0};
  const int e = run_merge(kNull, src_len, n_src, first_sorted, nullptr,
                          nullptr, sr_kind, vtype, 0, nullptr, &log);
  return e != 0 ? -e : log.n;
}

// int32 words of a merge's scratch buffer: an unsorted block of block_len
// entries (0 for the pairwise merge), n_sorted canonical operands, total
// entries in all.  The outputs take another 2 * total + 1 words and the
// values' bytes.
long long hm_scratch_words(int block_len, int total, int n_sorted) {
  return static_cast<long long>(scratch_words(block_len, total, n_sorted));
}

const char* hm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Multi-way merge: src holds (hi, lo, val) per source; source 0 is the
// unsorted block, sources 1..k the canonical runs.
int hm_merge_multi(const void* const* src, const int* src_len, int n_src,
                   void* out, void* scratch, int sr_kind, int vtype,
                   int zero_bits, void* stream) {
  return run_merge(src, src_len, n_src, 0, out, scratch, sr_kind, vtype,
                   zero_bits, stream);
}

// Pairwise merge of two canonical segments of any lengths.
int hm_merge(void* hi_a, void* lo_a, void* val_a, int n_a, void* hi_b,
             void* lo_b, void* val_b, int n_b, void* out, void* scratch,
             int sr_kind, int vtype, int zero_bits, void* stream) {
  const void* src[6] = {hi_a, lo_a, val_a, hi_b, lo_b, val_b};
  const int lens[2] = {n_a, n_b};
  return run_merge(src, lens, 2, 1, out, scratch, sr_kind, vtype, zero_bits,
                   stream);
}

}  // extern "C"
