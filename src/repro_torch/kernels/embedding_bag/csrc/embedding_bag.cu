// embedding_bag.cu — weighted embedding-bag gather-reduce for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel embedding_bag_pallas (_bag_kernel) of
// src/repro/kernels/embedding_bag/embedding_bag.py:
//
//     out[b, :] = sum_{l = 0 .. L-1}  w[b, l] * table[idx[b, l], :]
//
// accumulated in float32 from 0.0f in the order l = 0 .. L-1, as the TPU
// kernel's grid walks it.  Multiply and add are rounded separately
// (__fmul_rn / __fadd_rn, never contracted into an FMA), so the result is
// bit-equal to the plain PyTorch version beside the wrapper, which loops the
// same way.  Indices arrive clamped to [0, V) by ops.embedding_bag: the
// kernel neither clamps again nor skips a zero weight (0 * inf stays NaN).
//
// What bounds it on the H100.  Each (bag, item) reads one D-float row at a
// data-dependent address plus its 8 bytes of index and weight; each bag
// writes one D-float row.  Nothing is reused, so the kernel is bound by
// device-memory bytes: B*L*(4D + 8) + 4*B*D, about 0.93 GB (0.28 ms at
// 3.35 TB/s) for DCN-v2's serve_bulk batch (B = 262,144 * 26 bags, L = 1,
// D = 16) on its 94,306,304-row table.
//
// What the design does about it.  One thread per (bag, 16-byte piece of the
// row): with D = 16 four neighbouring threads read one 64-byte row as four
// float4 loads, and a warp keeps eight independent rows in flight; the
// index and weight of a bag are read once per item by each of its threads
// (the same address, served by L1).  Row offsets are 64-bit: idx * D is
// 1.51e9 at DCN-v2 and passes 2^31 at D = 128.  The scalar variant (one
// float per thread) covers D % 4 != 0 or a table not 16-byte aligned.
// Everything runs on the caller's stream; the caller allocates the output.

#include <cuda_runtime.h>

#include <cstdint>

#include "../../analysis.cuh"

namespace {

using repro_analysis::kBounds;

constexpr int kThreads = 256;

template <int W>
__global__ void __launch_bounds__(kThreads)
bag_kernel(const float* __restrict__ table, const int* __restrict__ idx,
           const float* __restrict__ w, float* __restrict__ out,
           long long n_bags, int bag, int d) {
  const int lanes = d / W;                     // threads per bag
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_bags * lanes) return;
  const long long b = t / lanes;
  const int col = static_cast<int>(t - b * lanes) * W;
  const int* ib = idx + b * bag;
  const float* wb = w + b * bag;
  float acc[W];
#pragma unroll
  for (int k = 0; k < W; ++k) acc[k] = 0.0f;
  KCHECK(col >= 0 && col + W <= d, kBounds);
  for (int l = 0; l < bag; ++l) {
    CHECKED_ONLY(const long long rows = repro_analysis::g_extent;
                 const int ix = __ldg(ib + l);
                 KCHECK(ix >= 0 && (rows <= 0 || ix < rows), kBounds);)
    const long long row = static_cast<long long>(__ldg(ib + l)) * d;
    const float wl = __ldg(wb + l);
    if constexpr (W == 4) {
      KCHECK((reinterpret_cast<uintptr_t>(table + row + col) & 15) == 0,
             kBounds);
      const float4 v = __ldg(reinterpret_cast<const float4*>(table + row + col));
      acc[0] = __fadd_rn(acc[0], __fmul_rn(wl, v.x));
      acc[1] = __fadd_rn(acc[1], __fmul_rn(wl, v.y));
      acc[2] = __fadd_rn(acc[2], __fmul_rn(wl, v.z));
      acc[3] = __fadd_rn(acc[3], __fmul_rn(wl, v.w));
    } else {
      acc[0] = __fadd_rn(acc[0], __fmul_rn(wl, __ldg(table + row + col)));
    }
  }
  float* o = out + b * d + col;
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *o = acc[0];
  }
}

#define EB_K(...) {reinterpret_cast<const void*>(&__VA_ARGS__), #__VA_ARGS__}
const repro_analysis::KernelEntry kKernels[] = {
    EB_K(bag_kernel<1>),
    EB_K(bag_kernel<4>),
};
#undef EB_K

// The launch of one call (or, with a log, its record only).
int run_bag(const float* tb, const int* ix, const float* wt, float* o,
            long long n_bags, int bag, int d, int vec, cudaStream_t s,
            repro_analysis::LaunchLog* log) {
  if (n_bags < 0 || bag < 0 || d < 0 || (vec && d % 4 != 0))
    return cudaErrorInvalidValue;
  const int width = vec ? 4 : 1;
  const long long threads = n_bags * (d / width);
  if (threads == 0) return cudaSuccess;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const void* fn = vec ? reinterpret_cast<const void*>(&bag_kernel<4>)
                       : reinterpret_cast<const void*>(&bag_kernel<1>);
  if (repro_analysis::dry_run(log, kKernels, fn, blocks, kThreads, 0))
    return cudaSuccess;
  cudaError_t e = repro_analysis::poison(
      o, static_cast<size_t>(n_bags) * d * sizeof(float), s);
  if (e == cudaSuccess) e = repro_analysis::push_extent(s);
  if (e != cudaSuccess) return e;
  if (vec) {
    bag_kernel<4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tb, ix, wt, o, n_bags, bag, d);
  } else {
    bag_kernel<1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        tb, ix, wt, o, n_bags, bag, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

REPRO_ANALYSIS_EXPORTS(eb, kKernels)

extern "C" {

// The launch one call makes, without launching (see hm_launch_config):
// 4 ints a launch in rows, at most cap; returns the count or minus a
// cudaError_t.
int eb_launch_config(long long n_bags, int bag, int d, int vec, int* rows,
                     int cap) {
  repro_analysis::LaunchLog log{rows, cap, 0};
  const int e = run_bag(nullptr, nullptr, nullptr, nullptr, n_bags, bag, d,
                        vec, nullptr, &log);
  return e != 0 ? -e : log.n;
}

const char* eb_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// table [V, d] f32, idx / w [n_bags, bag] int32 / f32, out [n_bags, d] f32,
// all contiguous; vec = 1 when d % 4 == 0 and table and out are 16-byte
// aligned.  Returns a cudaError_t (0 on success).
int eb_embedding_bag(void* table, void* idx, void* w, void* out,
                     long long n_bags, int bag, int d, int vec, void* stream) {
  return run_bag(static_cast<const float*>(table),
                 static_cast<const int*>(idx), static_cast<const float*>(w),
                 static_cast<float*>(out), n_bags, bag, d, vec,
                 static_cast<cudaStream_t>(stream), nullptr);
}

}  // extern "C"
