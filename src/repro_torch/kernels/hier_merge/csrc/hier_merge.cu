// hier_merge.cu — canonical-segment merge kernels for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/hier_merge/hier_merge.py:
//   merge_multi_pallas (_merge_multi_kernel) -> hm_merge_multi: one unsorted
//       power-of-two block plus k canonical runs (the fused spill cascade);
//   merge_pallas (_merge_kernel)             -> hm_merge: two canonical
//       segments (the layered cascade).
// Both produce what the TPU kernels produce: the canonical segment of the
// padded size N (live prefix sorted by signed lexicographic (hi, lo),
// duplicates combined under the semiring, a (SENTINEL, SENTINEL, zero) tail)
// and nnz.  Keys are compared as signed int32 pairs, never packed.
//
// What bounds it on the H100.  A merge of N entries must move 12 bytes per
// entry in and out (0.8 MB at the main path's N = 32768, about 0.25 us at
// 3.35 TB/s) and its sorting network does O(N log^2 N) compare-exchanges of a
// few integer operations each, far below the card's rate.  Neither bound is
// reached at these sizes: the work is a chain of dependent stages, and the
// time goes to launches and to the stages whose partners lie across tiles.
// 32768 entries are 384 KiB, more than one CTA's 227 KB of shared memory, so
// there is no single-CTA form at the main-path size.
//
// What the design does about it (simple and correct first):
//   phase A  bitonic network.  Strides of a tile (2048 entries, 24 KB) or
//            more run as one global-memory stage per launch; every smaller
//            stride of a step finishes inside shared memory in one launch.
//            The multi-way merge sorts the block, then folds in each run by
//            a bitonic merge of acc ++ reversed run on the cumulative size.
//   phase B  segmented inclusive scan over head flags: per CTA in shared
//            memory, one pass over the CTA carries, and a fix-up, so each
//            run's last element holds the run's total.
//   phase C  keep the run-last element of each run whose key is not
//            SENTINEL.
//   phase D  an exclusive prefix sum of the keep flags gives each kept
//            entry its destination; a stable scatter writes it there and
//            [nnz, N) is filled with SENTINEL / zero.  The input is sorted,
//            so this equals the TPU kernel's second full bitonic sort at a
//            fraction of the work.
// Everything runs on the caller's stream with no host synchronisation; the
// caller allocates outputs and scratch.  Merge-path partitioning, larger
// tiles, CTA clusters and batching many merges into one launch are the ways
// to make it faster.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kTile = 2048;                      // entries per CTA tile
constexpr int kScanThreads = 256;
constexpr int kScanItems = kTile / kScanThreads;  // consecutive entries per thread
constexpr int kCopyThreads = 256;
constexpr int kSentinel = INT_MAX;

#define HM_CHECK()                                   \
  do {                                               \
    cudaError_t e_ = cudaGetLastError();             \
    if (e_ != cudaSuccess) return e_;                \
  } while (0)

__device__ __forceinline__ bool lex_gt(int ha, int la, int hb, int lb) {
  return ha > hb || (ha == hb && la > lb);
}

// True when (a, b) must swap to be ascending (asc) or descending (!asc).
__device__ __forceinline__ bool out_of_order(int ha, int la, int hb, int lb,
                                             bool asc) {
  return asc ? lex_gt(ha, la, hb, lb) : lex_gt(hb, lb, ha, la);
}

// ------------------------------------------------------------ phase A ----

// Copy one operand into the work buffer, reversed for a run so that
// acc ++ run is a bitonic sequence.
__global__ void place_kernel(int* __restrict__ dh, int* __restrict__ dl,
                             uint32_t* __restrict__ dv,
                             const int* __restrict__ sh,
                             const int* __restrict__ sl,
                             const uint32_t* __restrict__ sv, int n,
                             int reverse) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = reverse ? n - 1 - i : i;
  dh[i] = sh[s];
  dl[i] = sl[s];
  dv[i] = sv[s];
}

// One bitonic stage whose pairs (i, i + j) lie in different tiles (j >= tile).
// A pair orders ascending iff bit k of i is 0.
__global__ void bitonic_global(int* __restrict__ hi, int* __restrict__ lo,
                               uint32_t* __restrict__ val, int pairs, int j,
                               int k) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  const int p = i + j;
  const int ha = hi[i], la = lo[i], hb = hi[p], lb = lo[p];
  if (out_of_order(ha, la, hb, lb, (i & k) == 0)) {
    const uint32_t va = val[i], vb = val[p];
    hi[i] = hb; lo[i] = lb; val[i] = vb;
    hi[p] = ha; lo[p] = la; val[p] = va;
  }
}

// Every stage of steps k_begin .. k_end whose stride is below the tile, on
// one shared-memory tile per CTA; one thread per compare-exchange.
__global__ void bitonic_shared(int* __restrict__ hi, int* __restrict__ lo,
                               uint32_t* __restrict__ val, int tile,
                               int k_begin, int k_end) {
  __shared__ int s_hi[kTile];
  __shared__ int s_lo[kTile];
  __shared__ uint32_t s_val[kTile];
  const int half = tile >> 1;
  const int t = threadIdx.x;
  const int base = blockIdx.x * tile;
  s_hi[t] = hi[base + t];
  s_lo[t] = lo[base + t];
  s_val[t] = val[base + t];
  s_hi[t + half] = hi[base + t + half];
  s_lo[t + half] = lo[base + t + half];
  s_val[t + half] = val[base + t + half];
  __syncthreads();
  for (int k = k_begin; k <= k_end; k <<= 1) {
    for (int j = min(k >> 1, half); j >= 1; j >>= 1) {
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const int p = i + j;
      const int ha = s_hi[i], la = s_lo[i], hb = s_hi[p], lb = s_lo[p];
      if (out_of_order(ha, la, hb, lb, ((base + i) & k) == 0)) {
        const uint32_t va = s_val[i], vb = s_val[p];
        s_hi[i] = hb; s_lo[i] = lb; s_val[i] = vb;
        s_hi[p] = ha; s_lo[p] = la; s_val[p] = va;
      }
      __syncthreads();
    }
  }
  hi[base + t] = s_hi[t];
  lo[base + t] = s_lo[t];
  val[base + t] = s_val[t];
  hi[base + t + half] = s_hi[t + half];
  lo[base + t + half] = s_lo[t + half];
  val[base + t + half] = s_val[t + half];
}

cudaError_t launch_global(int* hi, int* lo, uint32_t* val, int n, int j, int k,
                          cudaStream_t s) {
  const int pairs = n >> 1;
  bitonic_global<<<(pairs + kCopyThreads - 1) / kCopyThreads, kCopyThreads, 0,
                   s>>>(hi, lo, val, pairs, j, k);
  HM_CHECK();
  return cudaSuccess;
}

// Full bitonic sort of n (a power of two) entries.
cudaError_t bitonic_sort(int* hi, int* lo, uint32_t* val, int n,
                         cudaStream_t s) {
  if (n < 2) return cudaSuccess;
  const int tile = n < kTile ? n : kTile;
  bitonic_shared<<<n / tile, tile / 2, 0, s>>>(hi, lo, val, tile, 2, tile);
  HM_CHECK();
  for (int k = tile << 1; k <= n; k <<= 1) {
    for (int j = k >> 1; j >= tile; j >>= 1) {
      cudaError_t e = launch_global(hi, lo, val, n, j, k, s);
      if (e != cudaSuccess) return e;
    }
    bitonic_shared<<<n / tile, tile / 2, 0, s>>>(hi, lo, val, tile, k, k);
    HM_CHECK();
  }
  return cudaSuccess;
}

// Sort a bitonic sequence of n (a power of two) entries ascending.
cudaError_t bitonic_merge(int* hi, int* lo, uint32_t* val, int n,
                          cudaStream_t s) {
  if (n < 2) return cudaSuccess;
  const int tile = n < kTile ? n : kTile;
  for (int j = n >> 1; j >= tile; j >>= 1) {
    cudaError_t e = launch_global(hi, lo, val, n, j, n, s);
    if (e != cudaSuccess) return e;
  }
  bitonic_shared<<<n / tile, tile / 2, 0, s>>>(hi, lo, val, tile, n, n);
  HM_CHECK();
  return cudaSuccess;
}

// --------------------------------------------------------- phases B-D ----

// The semiring's add; its zero is the identity, which the scans rely on.
template <typename V, int Kind> struct Combine;
template <> struct Combine<float, 0> {
  __device__ static float f(float a, float b) { return a + b; }
};
template <> struct Combine<int, 0> {  // wraps like the reference's int32 add
  __device__ static int f(int a, int b) {
    return static_cast<int>(static_cast<unsigned>(a) +
                            static_cast<unsigned>(b));
  }
};
template <typename V> struct Combine<V, 1> {
  __device__ static V f(V a, V b) { return a > b ? a : b; }
};
template <typename V> struct Combine<V, 2> {
  __device__ static V f(V a, V b) { return a < b ? a : b; }
};

// Scratch words per merge: six int32 (or V) slots per CTA tile.
//   [0, nb) head seen   [nb, 2nb) tile total   [2nb, 3nb) first head index
//   [3nb, 4nb) keeps    [4nb, 5nb) carry in    [5nb, 6nb) output offset
int num_tiles(int n) { return (n + kTile - 1) / kTile; }

__device__ __forceinline__ bool run_head(const int* hi, const int* lo, int i,
                                         int h, int l) {
  return i == 0 || hi[i - 1] != h || lo[i - 1] != l;
}

__device__ __forceinline__ bool kept(const int* hi, const int* lo, int i,
                                     int n, int h, int l) {
  const bool last = i == n - 1 || hi[i + 1] != h || lo[i + 1] != l;
  return last && h != kSentinel;
}

// Block-wide inclusive scan of (head seen, value) pairs under the segmented
// operator (a, b) -> (fa | fb, fb ? vb : a + b), one pair per thread.
template <typename V, int Kind>
__device__ void block_segmented_scan(int& f, V& v, int* s_f, V* s_v) {
  const int t = threadIdx.x;
  s_f[t] = f;
  s_v[t] = v;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    int pf = 0;
    V pv = v;
    if (t >= d) {
      pf = s_f[t - d];
      pv = s_v[t - d];
    }
    __syncthreads();
    if (t >= d) {
      if (!f) v = Combine<V, Kind>::f(pv, v);
      f |= pf;
      s_f[t] = f;
      s_v[t] = v;
    }
    __syncthreads();
  }
}

// Block-wide exclusive sum, one int per thread.
__device__ int block_exclusive_sum(int x, int* s) {
  const int t = threadIdx.x;
  int acc = x;
  s[t] = acc;
  __syncthreads();
  for (int d = 1; d < kScanThreads; d <<= 1) {
    const int p = t >= d ? s[t - d] : 0;
    __syncthreads();
    if (t >= d) {
      acc += p;
      s[t] = acc;
    }
    __syncthreads();
  }
  return acc - x;
}

// Phase B, per tile: the tile-local segmented inclusive scan written in
// place, plus the tile's carry, first head and count of kept entries.
template <typename V, int Kind>
__global__ void scan_tiles(const int* __restrict__ hi,
                           const int* __restrict__ lo, V* __restrict__ val,
                           int n, int* __restrict__ scratch, V zero) {
  __shared__ int s_f[kScanThreads];
  __shared__ V s_v[kScanThreads];
  __shared__ int s_first_head;
  __shared__ int s_keep;
  const int nb = gridDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  if (t == 0) {
    s_first_head = INT_MAX;
    s_keep = 0;
  }
  __syncthreads();
  const int base = b * kTile + t * kScanItems;
  int f = 0, keep = 0, first = INT_MAX;
  V v = zero;
  for (int m = 0; m < kScanItems; ++m) {
    const int i = base + m;
    if (i >= n) break;
    const int h = hi[i], l = lo[i];
    const V x = val[i];
    if (run_head(hi, lo, i, h, l)) {
      v = x;
      f = 1;
      first = min(first, i);
    } else {
      v = Combine<V, Kind>::f(v, x);
    }
    keep += kept(hi, lo, i, n, h, l);
  }
  if (first != INT_MAX) atomicMin(&s_first_head, first);
  if (keep) atomicAdd(&s_keep, keep);
  block_segmented_scan<V, Kind>(f, v, s_f, s_v);
  V run = t > 0 ? s_v[t - 1] : zero;
  for (int m = 0; m < kScanItems; ++m) {
    const int i = base + m;
    if (i >= n) break;
    const int h = hi[i], l = lo[i];
    const V x = val[i];
    run = run_head(hi, lo, i, h, l) ? x : Combine<V, Kind>::f(run, x);
    val[i] = run;
  }
  if (t == kScanThreads - 1) {
    scratch[b] = f;
    reinterpret_cast<V*>(scratch + nb)[b] = v;
  }
  if (t == 0) {
    scratch[2 * nb + b] = s_first_head;
    scratch[3 * nb + b] = s_keep;
  }
}

// Phase B across tiles (one thread, nb <= 32 on the kernel's sizes): each
// tile's carry in, each tile's output offset, and nnz.
template <typename V, int Kind>
__global__ void scan_carries(int* __restrict__ scratch, int nb,
                             int* __restrict__ nnz, V zero) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const V* tile_val = reinterpret_cast<const V*>(scratch + nb);
  V* carry_in = reinterpret_cast<V*>(scratch + 4 * nb);
  V carry = zero;
  int total = 0;
  for (int b = 0; b < nb; ++b) {
    carry_in[b] = carry;
    scratch[5 * nb + b] = total;
    total += scratch[3 * nb + b];
    carry = scratch[b] ? tile_val[b] : Combine<V, Kind>::f(carry, tile_val[b]);
  }
  *nnz = total;
}

// Phase B fix-up and phases C-D: entries before a tile's first head continue
// the previous tile's run and take its carry; each kept (run-last, live)
// entry goes to its compacted slot; slots [nnz, n) get SENTINEL / zero.
template <typename V, int Kind>
__global__ void fixup_compact(const int* __restrict__ hi,
                              const int* __restrict__ lo,
                              const V* __restrict__ val, int n,
                              const int* __restrict__ scratch,
                              const int* __restrict__ nnz,
                              int* __restrict__ out_hi,
                              int* __restrict__ out_lo,
                              V* __restrict__ out_val, V zero) {
  __shared__ int s_count[kScanThreads];
  const int nb = gridDim.x;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int first_head = scratch[2 * nb + b];
  const V carry_in = reinterpret_cast<const V*>(scratch + 4 * nb)[b];
  const int total = *nnz;
  const int base = b * kTile + t * kScanItems;
  int keep = 0;
  for (int m = 0; m < kScanItems; ++m) {
    const int i = base + m;
    if (i >= n) break;
    keep += kept(hi, lo, i, n, hi[i], lo[i]);
  }
  int dest = scratch[5 * nb + b] + block_exclusive_sum(keep, s_count);
  for (int m = 0; m < kScanItems; ++m) {
    const int i = base + m;
    if (i >= n) break;
    const int h = hi[i], l = lo[i];
    if (kept(hi, lo, i, n, h, l)) {
      V x = val[i];
      if (i < first_head) x = Combine<V, Kind>::f(carry_in, x);
      out_hi[dest] = h;
      out_lo[dest] = l;
      out_val[dest] = x;
      ++dest;
    }
    if (i >= total) {
      out_hi[i] = kSentinel;
      out_lo[i] = kSentinel;
      out_val[i] = zero;
    }
  }
}

template <typename V, int Kind>
cudaError_t combine_compact(int* wh, int* wl, void* wv, int n, int* oh,
                            int* ol, void* ov, int* nnz, int* scratch,
                            V zero, cudaStream_t s) {
  const int nb = num_tiles(n);
  V* wval = static_cast<V*>(wv);
  scan_tiles<V, Kind><<<nb, kScanThreads, 0, s>>>(wh, wl, wval, n, scratch,
                                                   zero);
  HM_CHECK();
  scan_carries<V, Kind><<<1, 1, 0, s>>>(scratch, nb, nnz, zero);
  HM_CHECK();
  fixup_compact<V, Kind><<<nb, kScanThreads, 0, s>>>(
      wh, wl, wval, n, scratch, nnz, oh, ol, static_cast<V*>(ov), zero);
  HM_CHECK();
  return cudaSuccess;
}

template <typename V>
cudaError_t combine_compact_kind(int kind, int* wh, int* wl, void* wv, int n,
                                 int* oh, int* ol, void* ov, int* nnz,
                                 int* scratch, V zero, cudaStream_t s) {
  switch (kind) {
    case 0:
      return combine_compact<V, 0>(wh, wl, wv, n, oh, ol, ov, nnz, scratch,
                                   zero, s);
    case 1:
      return combine_compact<V, 1>(wh, wl, wv, n, oh, ol, ov, nnz, scratch,
                                   zero, s);
    case 2:
      return combine_compact<V, 2>(wh, wl, wv, n, oh, ol, ov, nnz, scratch,
                                   zero, s);
  }
  return cudaErrorInvalidValue;
}

bool is_pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// The shared host routine: operand 0 is the block (sorted already when
// first_sorted), operands 1.. are canonical runs; every cumulative size from
// operand 1 on (and operand 0's own, unless first_sorted) is a power of two.
int run_merge(void* const* src_hi, void* const* src_lo,
              void* const* src_val, const int* src_len, int n_src,
              int first_sorted, void* work_hi, void* work_lo, void* work_val,
              void* out_hi, void* out_lo, void* out_val, void* nnz,
              void* scratch, int sr_kind, int is_int, int zero_bits,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* wh = static_cast<int*>(work_hi);
  int* wl = static_cast<int*>(work_lo);
  uint32_t* wv = static_cast<uint32_t*>(work_val);
  if (n_src < 1 || sr_kind < 0 || sr_kind > 2) return cudaErrorInvalidValue;
  int cum = 0;
  for (int r = 0; r < n_src; ++r) {
    const int len = src_len[r];
    if (len < 0) return cudaErrorInvalidValue;
    cum += len;
    if ((r > 0 || !first_sorted) && !is_pow2(cum)) return cudaErrorInvalidValue;
  }
  const int n = cum;
  int off = 0;
  for (int r = 0; r < n_src; ++r) {
    const int len = src_len[r];
    if (len > 0) {
      place_kernel<<<(len + kCopyThreads - 1) / kCopyThreads, kCopyThreads, 0,
                     s>>>(wh + off, wl + off, wv + off,
                          static_cast<const int*>(src_hi[r]),
                          static_cast<const int*>(src_lo[r]),
                          static_cast<const uint32_t*>(src_val[r]), len,
                          r > 0);
      HM_CHECK();
    }
    off += len;
  }
  cudaError_t e = cudaSuccess;
  cum = src_len[0];
  if (!first_sorted) e = bitonic_sort(wh, wl, wv, cum, s);
  for (int r = 1; r < n_src && e == cudaSuccess; ++r) {
    cum += src_len[r];
    e = bitonic_merge(wh, wl, wv, cum, s);
  }
  if (e != cudaSuccess) return e;
  int* oh = static_cast<int*>(out_hi);
  int* ol = static_cast<int*>(out_lo);
  int* cnt = static_cast<int*>(nnz);
  int* scr = static_cast<int*>(scratch);
  if (is_int) {
    e = combine_compact_kind<int>(sr_kind, wh, wl, wv, n, oh, ol, out_val,
                                  cnt, scr, zero_bits, s);
  } else {
    float zero;
    static_assert(sizeof(float) == sizeof(int), "32-bit values");
    std::memcpy(&zero, &zero_bits, sizeof zero);
    e = combine_compact_kind<float>(sr_kind, wh, wl, wv, n, oh, ol, out_val,
                                    cnt, scr, zero, s);
  }
  return e;
}

}  // namespace

extern "C" {

// int32 words of scratch a merge of n entries needs.
int hm_scratch_words(int n) { return 6 * num_tiles(n); }

const char* hm_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// Multi-way merge: src 0 is the unsorted block, src 1..k the canonical runs.
int hm_merge_multi(void* const* src_hi, void* const* src_lo,
                   void* const* src_val, const int* src_len, int n_src,
                   void* work_hi, void* work_lo, void* work_val, void* out_hi,
                   void* out_lo, void* out_val, void* nnz, void* scratch,
                   int sr_kind, int is_int, int zero_bits, void* stream) {
  return run_merge(src_hi, src_lo, src_val, src_len, n_src, 0, work_hi,
                   work_lo, work_val, out_hi, out_lo, out_val, nnz, scratch,
                   sr_kind, is_int, zero_bits, stream);
}

// Pairwise merge of two canonical segments (n_a + n_b a power of two).
int hm_merge(void* hi_a, void* lo_a, void* val_a, int n_a, void* hi_b,
             void* lo_b, void* val_b, int n_b, void* work_hi, void* work_lo,
             void* work_val, void* out_hi, void* out_lo, void* out_val,
             void* nnz, void* scratch, int sr_kind, int is_int,
             int zero_bits, void* stream) {
  void* hs[2] = {hi_a, hi_b};
  void* ls[2] = {lo_a, lo_b};
  void* vs[2] = {val_a, val_b};
  const int lens[2] = {n_a, n_b};
  return run_merge(hs, ls, vs, lens, 2, 1, work_hi, work_lo, work_val,
                   out_hi, out_lo, out_val, nnz, scratch, sr_kind, is_int,
                   zero_bits, stream);
}

}  // extern "C"
