// Histogram of int32 bucket ids for Hopper (sm_90a).
//
// Replaces the TPU kernel metrics_tpu/ops/pallas_kernels.py::_histogram_kernel.
// For ids (N,) int32 it adds into an int32 (num_buckets,) buffer that the
// caller zeroed: out[b] += #{i : ids[i] == b}. Ids outside
// [0, num_buckets), negatives included, are not counted and write nothing.
// One call is one launch of one kernel.
//
// What bounds it on an H100: it reads 4N bytes of ids and writes
// 4 * num_buckets bytes of counts, some 0.020 ms at N = 2^24 and 3.35 TB/s;
// its one compare and one add per id are far below the card's integer rate.
// The TPU kernel compares every id against every bucket lane (num_buckets
// compares per id, capped at 8192 buckets for VMEM); that trade does not
// carry over, and this kernel does one add per id instead.
//
// Design, from three readings of the previous design (csrc/histogram_match.cu)
// on an H100 80GB HBM3 at 700 W, at 2^24 ids and 2051 bins (PERF.md):
//
// - No collision handling. The previous design grouped each warp's ids with
//   __match_any_sync before its shared atomics; without the match the same
//   loop took 0.029 ms on uniform ids instead of 0.145, and 0.028 instead
//   of 0.031 with every id in one bin. Both sit at the loads' own time
//   (0.0266 ms for the loads alone), so at this size the loop is bound by
//   its loads and the atomics of 32 lanes on one address stay hidden
//   behind them: each id is one plain shared atomicAdd. Sorted ids, runs
//   and skewed draws take the same path, and one copy of the bins per
//   block serves all of them, so no size threshold is added to the
//   previous design's.
// - Wide loads. With the match gone the loop runs at the load path's speed
//   (its scalar loads alone took 0.0266 ms, 75 % of the bound), so each
//   thread loads 16-byte int4 vectors, two per step, and holds the next
//   step's two in registers while it adds the current ones: 32 KB in flight
//   per SM, twice the previous design's. A data pointer that is not 16-byte
//   aligned gets a scalar head of up to 3 ids, and an N that is not a
//   multiple of 4 a scalar tail; block 0 adds both.
// - A smaller flush. One block of 1024 threads per SM keeps its bins in
//   dynamic shared memory and at the end adds each nonzero bin to device
//   memory with one global atomicAdd: 132 x 2051 atomics at most, half the
//   previous design's 264 blocks. Their 540,672 atomics had cost about
//   0.0024 ms, so a second pass over per-block partials would not pay for
//   its launch.
//
// Integer counts are exact and independent of the order of the adds, so
// the result is bit-equal to the plain version. A grid too large for a
// block's shared memory (more than the opt-in maximum, 227 KB on an H100,
// i.e. above 58,112 bins) runs the same loop adding straight into device
// memory. Above 48 KB of bins the launcher raises the kernel's dynamic
// shared-memory limit first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kVectors = 2;  // int4 loads per thread per step
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ void add(int* bins, int id, unsigned num_buckets) {
  if ((unsigned)id < num_buckets) atomicAdd(bins + id, 1);
}

__device__ __forceinline__ void add4(int* bins, int4 v, unsigned num_buckets) {
  add(bins, v.x, num_buckets);
  add(bins, v.y, num_buckets);
  add(bins, v.z, num_buckets);
  add(bins, v.w, num_buckets);
}

// ids[0, head) and ids[head + 4 * n4, n) are the scalar head and tail; the
// int4 vectors in between start at a 16-byte boundary.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
histogram_kernel(const int* __restrict__ ids, long long n, int head, int num_buckets, int* __restrict__ out) {
  extern __shared__ int s_bins[];
  const unsigned nb = (unsigned)num_buckets;
  int* bins = out;
  if (kShared) {
    for (int i = threadIdx.x; i < num_buckets; i += kThreads) s_bins[i] = 0;
    __syncthreads();
    bins = s_bins;
  }

  const int4* vec = reinterpret_cast<const int4*>(ids + head);
  const long long n4 = (n - head) >> 2;
  if (blockIdx.x == 0) {
    const long long tail = head + 4 * n4;
    if (threadIdx.x < head) add(bins, __ldg(ids + threadIdx.x), nb);
    else if (threadIdx.x < head + (n - tail)) add(bins, __ldg(ids + tail + (threadIdx.x - head)), nb);
  }

  const long long step = (long long)gridDim.x * kThreads * kVectors;
  long long base = (long long)blockIdx.x * kThreads * kVectors + threadIdx.x;
  const int4 none = make_int4(-1, -1, -1, -1);  // out of range: counted nowhere
  int4 cur[kVectors], next[kVectors];
#pragma unroll
  for (int k = 0; k < kVectors; ++k) {
    const long long i = base + k * kThreads;
    cur[k] = i < n4 ? __ldg(vec + i) : none;
  }
  for (; base < n4; base += step) {
#pragma unroll
    for (int k = 0; k < kVectors; ++k) {
      const long long i = base + step + k * kThreads;
      next[k] = i < n4 ? __ldg(vec + i) : none;
    }
#pragma unroll
    for (int k = 0; k < kVectors; ++k) add4(bins, cur[k], nb);
#pragma unroll
    for (int k = 0; k < kVectors; ++k) cur[k] = next[k];
  }

  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < num_buckets; i += kThreads) {
      const int c = s_bins[i];
      if (c) atomicAdd(out + i, c);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// out must hold num_buckets zeroed int32 values. n = 0 launches nothing.
extern "C" int histogram_launch(const int* ids, long long n, int num_buckets, int* out, void* stream) {
  if (n <= 0 || num_buckets <= 0) return (int)cudaSuccess;
  int device = 0, sms = 0, smem_optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;

  // ids up to the first 16-byte boundary (int32 data is 4-byte aligned)
  long long head = (long long)((16 - ((uintptr_t)ids & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  const long long per_block = (long long)kThreads * kVectors;
  long long blocks = (n4 + per_block - 1) / per_block;
  if (blocks > sms) blocks = sms;
  if (blocks < 1) blocks = 1;  // the head and tail alone
  const size_t smem = (size_t)num_buckets * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;

  if (smem <= (size_t)smem_optin) {
    if (smem > (size_t)kDefaultSmem) {
      err = cudaFuncSetAttribute(histogram_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    histogram_kernel<true><<<(unsigned)blocks, kThreads, smem, s>>>(ids, n, (int)head, num_buckets, out);
  } else {
    histogram_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(ids, n, (int)head, num_buckets, out);
  }
  return (int)cudaGetLastError();
}
