// analysis.cuh — what palkit (src/repro_torch/analysis/palkit.py) reads
// from a kernel library, shared by the three kernel sources.  Nothing here
// changes a kernel's arithmetic.
//
// Every library exports, with its own prefix P (hm, eb, sa):
//   P_kernel_count(), P_kernel_attrs(i, &name, &mangled, vals): for every
//       kernel instantiation of the source, cudaFuncGetAttributes' numRegs,
//       sharedSizeBytes, localSizeBytes, maxThreadsPerBlock and
//       maxDynamicSharedSizeBytes, its name as written in the source's
//       table and its mangled name (the key of the ptxas log);
//   P_launch_config(...): the launches the host routine would make for
//       given shapes (kernel index, grid, block, dynamic shared bytes),
//       decided by the same code that launches — a dry run of it;
//   P_checked(), P_check_counts(out[3]), P_check_poison(byte),
//       P_check_extent(n): the checked build's interface (below).
//
// The checked build (nvcc -DREPRO_KERNEL_CHECKS, lib<name>_checked.so) is
// palkit's stand-in for compute-sanitizer where the sanitizer cannot run.
// KCHECK(cond, cls) counts a failed device-side check in g_check[cls]:
//   kBounds (0)  an index outside the operand or shared array it reads or
//                writes (K003, memcheck's class);
//   kInit   (1)  reserved for device-side read-before-write checks; the
//                host side of K004 fills outputs and scratch with a poison
//                byte before the launches (P_check_poison), and palkit
//                runs each job under two poisons: outputs that differ read
//                memory the kernels never wrote (initcheck's class);
//   kSync   (2)  a warp collective with lanes missing, a barrier or
//                look-back wait that never completes (bounded spins), a
//                bulk copy not 16-byte aligned, or a copy started and
//                never waited (K006, synccheck's class).  Nothing here
//                detects racecheck's class, a shared-memory race that a
//                barrier misses.
// P_check_extent(n) tells the next launches the one operand extent their
// arguments do not carry (the table's rows, the edges).  In the production
// build the checks compile to nothing and the check exports report 0.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace repro_analysis {

constexpr int kBounds = 0;
constexpr int kInit = 1;
constexpr int kSync = 2;
constexpr long long kSpinLimit = 1LL << 22;  // polls before a wait counts
                                             // as never completing

#ifdef REPRO_KERNEL_CHECKS
__device__ unsigned int g_check[3];
__device__ long long g_extent;                // 0: unknown
#define KCHECK(cond, cls)                                        \
  do {                                                           \
    if (!(cond)) atomicAdd(&::repro_analysis::g_check[cls], 1u); \
  } while (0)
#define CHECKED_ONLY(...) __VA_ARGS__
constexpr bool kChecked = true;
#else
#define KCHECK(cond, cls) \
  do {                    \
  } while (0)
#define CHECKED_ONLY(...)
constexpr bool kChecked = false;
#endif

inline int g_poison = -1;           // byte the host fills buffers with
inline long long g_extent_host = 0;

// Fill [p, p + bytes) with the poison byte before a checked launch.
inline cudaError_t poison(void* p, size_t bytes, cudaStream_t s) {
  if (!kChecked || g_poison < 0 || p == nullptr || bytes == 0)
    return cudaSuccess;
  return cudaMemsetAsync(p, g_poison, bytes, s);
}

// Hand the extent to the device before a checked launch.
inline cudaError_t push_extent(cudaStream_t s) {
#ifdef REPRO_KERNEL_CHECKS
  return cudaMemcpyToSymbolAsync(g_extent, &g_extent_host, sizeof(long long),
                                 0, cudaMemcpyHostToDevice, s);
#else
  (void)s;
  return cudaSuccess;
#endif
}

struct KernelEntry {
  const void* fn;
  const char* name;
};

// The launches a dry run records: 4 ints each (kernel index in the
// source's table, grid, block, dynamic shared bytes), at most cap written.
struct LaunchLog {
  int* rows;
  int cap;
  int n;
};

template <size_t N>
int kernel_index(const KernelEntry (&table)[N], const void* fn) {
  for (size_t i = 0; i < N; ++i)
    if (table[i].fn == fn) return static_cast<int>(i);
  return -1;
}

// Record one launch when dry-running; true means "do not launch".
template <size_t N>
bool dry_run(LaunchLog* log, const KernelEntry (&table)[N], const void* fn,
             long long grid, int block, size_t smem) {
  if (log == nullptr) return false;
  if (log->n < log->cap) {
    int* r = log->rows + 4 * log->n;
    r[0] = kernel_index(table, fn);
    r[1] = static_cast<int>(grid);
    r[2] = block;
    r[3] = static_cast<int>(smem);
  }
  ++log->n;
  return true;
}

template <size_t N>
int kernel_attrs(const KernelEntry (&table)[N], int i, const char** name,
                 const char** mangled, int* vals) {
  if (i < 0 || i >= static_cast<int>(N)) return cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, table[i].fn);
  if (e != cudaSuccess) return e;
  *name = table[i].name;
  *mangled = nullptr;
#if CUDART_VERSION >= 12030
  if (cudaFuncGetName(mangled, table[i].fn) != cudaSuccess) *mangled = nullptr;
#endif
  vals[0] = a.numRegs;
  vals[1] = static_cast<int>(a.sharedSizeBytes);
  vals[2] = static_cast<int>(a.localSizeBytes);
  vals[3] = a.maxThreadsPerBlock;
  vals[4] = a.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

inline int check_counts(unsigned int* out) {
#ifdef REPRO_KERNEL_CHECKS
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return e;
  e = cudaMemcpyFromSymbol(out, g_check, sizeof(g_check));
  if (e != cudaSuccess) return e;
  static const unsigned int zero[3] = {0u, 0u, 0u};
  return cudaMemcpyToSymbol(g_check, zero, sizeof(zero));
#else
  out[0] = out[1] = out[2] = 0u;
  return cudaSuccess;
#endif
}

}  // namespace repro_analysis

// The exports of one library, P its prefix, TABLE its KernelEntry table.
#define REPRO_ANALYSIS_EXPORTS(P, TABLE)                                    \
  extern "C" int P##_kernel_count() {                                       \
    return static_cast<int>(sizeof(TABLE) / sizeof(TABLE[0]));              \
  }                                                                         \
  extern "C" int P##_kernel_attrs(int i, const char** name,                 \
                                  const char** mangled, int* vals) {        \
    return repro_analysis::kernel_attrs(TABLE, i, name, mangled, vals);     \
  }                                                                         \
  extern "C" int P##_checked() { return repro_analysis::kChecked ? 1 : 0; } \
  extern "C" int P##_check_counts(unsigned int* out) {                      \
    return repro_analysis::check_counts(out);                               \
  }                                                                         \
  extern "C" void P##_check_poison(int byte) {                              \
    repro_analysis::g_poison = byte;                                        \
  }                                                                         \
  extern "C" void P##_check_extent(long long n) {                           \
    repro_analysis::g_extent_host = n;                                      \
  }
