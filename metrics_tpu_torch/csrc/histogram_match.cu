// The previous design of K2, the histogram of int32 bucket ids, for Hopper
// (sm_90a). Nothing in metrics_tpu_torch launches it: chip_smoke.py builds
// it beside csrc/histogram.cu and times both on the same inputs in one run,
// so the redesign's gain is measured, not recalled.
//
// For ids (N,) int32 it adds into an int32 (num_buckets,) buffer that the
// caller zeroed: out[b] += #{i : ids[i] == b}; ids outside [0, num_buckets)
// are not counted.
//
// Design: a privatized histogram. A grid of about two blocks of 512 threads
// per SM walks the ids in a grid-stride loop, four coalesced scalar loads
// in flight per thread. Each block keeps its bins in dynamic shared memory.
// Within a warp the 32 ids of a step are grouped with __match_any_sync, and
// one lane adds the group's size with a shared-memory atomic; at the end
// the block adds each nonzero bin to device memory with one global
// atomicAdd. Above the shared-memory opt-in (58,112 bins on an H100) the
// same loop adds straight into device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;          // ids per thread per step, loaded together
constexpr int kBlocksPerSm = 2;
constexpr int kDefaultSmem = 48 * 1024;

// Adds each distinct in-range id of the warp once, with the count of lanes
// that hold it. Every lane of the warp must call it (the loop below keeps
// the warp converged: out-of-range lanes hold -1).
__device__ __forceinline__ void warp_add(int* bins, int id, unsigned num_buckets) {
  const unsigned peers = __match_any_sync(0xffffffffu, id);
  const int leader = __ffs(peers) - 1;
  if ((threadIdx.x & 31) == leader && (unsigned)id < num_buckets) {
    atomicAdd(bins + id, __popc(peers));
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
histogram_match_kernel(const int* __restrict__ ids, long long n, int num_buckets, int* __restrict__ out) {
  extern __shared__ int s_bins[];
  int* bins = out;
  if (kShared) {
    for (int i = threadIdx.x; i < num_buckets; i += kThreads) s_bins[i] = 0;
    __syncthreads();
    bins = s_bins;
  }

  // every thread of the block runs the same number of steps, so the warp
  // stays converged for __match_any_sync
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long base = (long long)blockIdx.x * kThreads * kUnroll; base < n; base += step) {
    int v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + (long long)k * kThreads + threadIdx.x;
      v[k] = i < n ? __ldg(ids + i) : -1;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) warp_add(bins, v[k], (unsigned)num_buckets);
  }

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < num_buckets; i += kThreads) {
      const int c = s_bins[i];
      if (c) atomicAdd(out + i, c);
    }
  }
}

int launch(const int* ids, long long n, int num_buckets, int* out, void* stream) {
  if (n <= 0 || num_buckets <= 0) return (int)cudaSuccess;
  int device = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;

  const long long per_block = (long long)kThreads * kUnroll;
  long long blocks = (n + per_block - 1) / per_block;
  if (blocks > (long long)kBlocksPerSm * sms) blocks = (long long)kBlocksPerSm * sms;
  const size_t smem = (size_t)num_buckets * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;

  if (smem <= (size_t)smem_optin) {
    if (smem > (size_t)kDefaultSmem) {
      err = cudaFuncSetAttribute(histogram_match_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    histogram_match_kernel<true><<<(unsigned)blocks, kThreads, smem, s>>>(ids, n, num_buckets, out);
  } else {
    histogram_match_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(ids, n, num_buckets, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The previous design, as histogram.cu's histogram_launch was: launches on
// `stream` and returns the launch's cudaError_t. out must hold num_buckets
// zeroed int32 values. n = 0 launches nothing.
extern "C" int histogram_match_launch(const int* ids, long long n, int num_buckets, int* out, void* stream) {
  return launch(ids, n, num_buckets, out, stream);
}
