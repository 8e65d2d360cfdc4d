// Kernel K3: one fold of a KLL compactor level, for Hopper (sm_90a).
//
// Replaces the TPU kernel metrics_tpu/ops/pallas_kernels.py::_make_fold_kernel
// -> _fold_kernel (pallas_call at :188), together with the jnp.sort that runs
// just before it in metrics_tpu/ops/compactor.py::fold_level.
//
// Inputs are two ascending runs, each +inf past its valid count: a (na) with
// a_count valid values and b (nb) with b_count, the counts read from device
// memory. Let merged be their merge (na + nb values) and c = a_count + b_count.
// With p_len = (na + nb) / 2 the outputs are:
//   c <= k: items[t] = merged[t] for t < k, count = c, promoted all +inf,
//           pcount = 0 (the level absorbs everything);
//   c >  k: promoted[j] = merged[2j + (j & 1)] for j < c / 2 and +inf after,
//           pcount = c / 2; the odd leftover merged[2 (c / 2)] stays at the
//           level as items[0] (count = c % 2), items +inf otherwise.
// When b_count is 0 and a_count <= k the level passes through (items = a,
// +inf past na) without any search: the cascade launches every level and
// the levels the promotion does not reach exit this way, with no host read.
//
// Design: both runs are sorted, so the sort is a merge. Each thread owns
// output slots (items first, then promoted) and finds the merged element it
// needs by a merge-path co-rank binary search over the two runs, ties taken
// from a first. Equal values are equal bits (the runs hold no NaN and no
// -0.0), so the tie order cannot change an output. One launch per fold, no
// shared memory, so no ceiling on na + nb; the grid covers k + p_len slots.
//
// Bound: bytes. It reads na + nb floats and writes k + p_len floats; each
// slot's search makes O(log(na + nb)) reads that hit L2. The work per byte is
// a few compares, far below the card's compute roofline.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Number of a's values among the first `diag` values of the merge (a first
// on ties).
__device__ __forceinline__ int merge_path(const float* __restrict__ a, int na,
                                          const float* __restrict__ b, int nb, int diag) {
  int lo = max(0, diag - nb);
  int hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (b[diag - 1 - mid] < a[mid]) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// merged[p]
__device__ __forceinline__ float merged_at(const float* __restrict__ a, int na,
                                           const float* __restrict__ b, int nb, int p) {
  const int i = merge_path(a, na, b, nb, p);
  const int j = p - i;
  if (i < na && (j >= nb || !(b[j] < a[i]))) return a[i];
  return b[j];
}

__global__ void __launch_bounds__(kThreads)
compactor_fold_kernel(const float* __restrict__ a, int na, const float* __restrict__ b, int nb,
                      const int* __restrict__ a_count, const int* __restrict__ b_count, int k,
                      float* __restrict__ items, int* __restrict__ count,
                      float* __restrict__ promoted, int* __restrict__ pcount) {
  const int ca = *a_count;
  const int cb = *b_count;
  const int c = ca + cb;
  const bool overflow = c > k;
  const int pairs = c / 2;
  const int leftover = c - 2 * pairs;
  const bool pass_through = cb == 0 && !overflow;
  const int p_len = (na + nb) / 2;
  const int n_out = k + p_len;
  const float inf = pos_inf();

  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_out; s += gridDim.x * blockDim.x) {
    if (s < k) {
      float v;
      if (pass_through) {
        v = s < na ? a[s] : inf;
      } else if (!overflow) {
        v = merged_at(a, na, b, nb, s);
      } else {
        v = (s == 0 && leftover) ? merged_at(a, na, b, nb, 2 * pairs) : inf;
      }
      items[s] = v;
    } else {
      const int j = s - k;
      promoted[j] = (overflow && j < pairs) ? merged_at(a, na, b, nb, 2 * j + (j & 1)) : inf;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count = overflow ? leftover : c;
    *pcount = overflow ? pairs : 0;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int compactor_fold_launch(const float* a, int na, const float* b, int nb,
                                     const int* a_count, const int* b_count, int k,
                                     float* items, int* count, float* promoted, int* pcount,
                                     void* stream) {
  const long long n_out = (long long)k + (na + (long long)nb) / 2;
  const int blocks = (int)((n_out + kThreads - 1) / kThreads);
  compactor_fold_kernel<<<blocks > 0 ? blocks : 1, kThreads, 0, (cudaStream_t)stream>>>(
      a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount);
  return (int)cudaGetLastError();
}
