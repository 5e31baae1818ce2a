// segment_agg.cu — sorted segment sum (GNN message passing) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel segment_sum_pallas (_segment_kernel) of
// src/repro/kernels/segment_agg/segment_agg.py, with the same operand
// contract (staged by ops.segment_sum): messages [E_pad, D] f32 sorted by
// segment id, seg [E_pad] int32 ascending, tile_starts [T + 1] int32 with
// tile t owning the edge range [tile_starts[t], tile_starts[t + 1]) of the
// node ids [t*TN, (t+1)*TN).  Padding rows carry ids >= T*TN and lie past
// tile_starts[T], so they contribute nothing.  The output is [T*TN, D] f32;
// every row is written, zeros for a node without edges.
//
// The TPU kernel turns the scatter into a one-hot [TN, KB] x [KB, D] matmul
// because the TPU has a matrix unit and no scatter.  Here the ids are sorted,
// so each node owns a contiguous run of rows: one CTA per node tile finds
// its TN + 1 node boundaries by binary search in its edge range, then each
// warp sums whole nodes, lanes across D (float4 when D % 4 == 0), adding the
// node's rows in edge order into float32 registers.  No atomics, so the
// result is deterministic, and no matrix unit, so no TF32 anywhere; the
// order of the additions is the plain version's, which it matches bit for
// bit.
//
// What bounds it on the H100.  Each message row is read once and each output
// row written once: E_pad*(4D + 4) + 4*T*TN*D bytes, about 0.77 GB (0.23 ms
// at 3.35 TB/s) for GraphCast's processor graph (E = 327,660, D = 512,
// N = 40,962).  The adds are one per message float, far below the card's
// rate.  A hub node's run is summed by one warp, so tiles with hubs finish
// late; splitting long runs across warps is left for a later change.
// Everything runs on the caller's stream; the caller allocates the output.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int W>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ msg, const int* __restrict__ seg,
                   const int* __restrict__ tile_starts,
                   float* __restrict__ out, int tn, int d) {
  extern __shared__ int node_start[];          // tn + 1 edge offsets
  const int t = blockIdx.x;
  const int start = tile_starts[t];
  const int end = tile_starts[t + 1];
  const long long base = static_cast<long long>(t) * tn;
  // node_start[n] = first edge of [start, end) whose id is >= base + n
  for (int n = threadIdx.x; n <= tn; n += blockDim.x) {
    const long long key = base + n;
    int lo = start, hi = end;
    while (lo < hi) {
      const int mid = lo + (hi - lo) / 2;
      if (__ldg(seg + mid) < key) lo = mid + 1; else hi = mid;
    }
    node_start[n] = lo;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int n = warp; n < tn; n += kWarps) {
    const int e0 = node_start[n];
    const int e1 = node_start[n + 1];
    float* orow = out + (base + n) * d;
    for (int c = lane * W; c < d; c += 32 * W) {
      if constexpr (W == 4) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int e = e0; e < e1; ++e) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              msg + static_cast<long long>(e) * d + c));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        *reinterpret_cast<float4*>(orow + c) = acc;
      } else {
        float acc = 0.0f;
        for (int e = e0; e < e1; ++e)
          acc += __ldg(msg + static_cast<long long>(e) * d + c);
        orow[c] = acc;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* sa_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

// msg [E_pad, d] f32, seg [E_pad] int32 ascending, tile_starts [num_tiles+1]
// int32, out [num_tiles * tn, d] f32, all contiguous; vec = 1 when d % 4 == 0
// and msg and out are 16-byte aligned.  Returns a cudaError_t (0 on success).
int sa_segment_sum(void* msg, void* seg, void* tile_starts, void* out,
                   int num_tiles, int tn, int d, int vec, void* stream) {
  if (num_tiles < 0 || tn <= 0 || d < 0 || (vec && d % 4 != 0))
    return cudaErrorInvalidValue;
  if (num_tiles == 0 || d == 0) return cudaSuccess;
  const size_t smem = sizeof(int) * (static_cast<size_t>(tn) + 1);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(msg);
  const int* sg = static_cast<const int*>(seg);
  const int* ts = static_cast<const int*>(tile_starts);
  float* o = static_cast<float*>(out);
  if (vec) {
    segment_sum_kernel<4><<<num_tiles, kThreads, smem, s>>>(m, sg, ts, o, tn, d);
  } else {
    segment_sum_kernel<1><<<num_tiles, kThreads, smem, s>>>(m, sg, ts, o, tn, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
