// Kernel K1 for Hopper (sm_90a): binned TP/FP/FN counts per (class,
// threshold), as a binary-search histogram.
//
// Replaces the TPU kernel metrics_tpu/ops/binned_counters.py::_counter_kernel.
// For preds p (N, C) float32, a 0/1 target y (N, C) uint8 and thresholds
// thr (T,) float32 it writes the float32 (3, C, T) result
//   tps[c, t] = sum_n y * ge,  fps[c, t] = sum_n (1 - y) * ge,
//   fns[c, t] = sum_n y * (1 - ge),  with ge = (p >= thr[t]),
// both operands compared with float32 denormals flushed to (signed) zero, as
// XLA compares on the CPU and the TPU. fn is counted from (1 - ge): a NaN
// score clears no threshold and counts as a false negative at every one, as
// in both JAX forms. The thresholds may be in any order, repeat, or be NaN.
//
// What bounds it on an H100: it reads N*C*(4 + 1) bytes of scores and labels
// and writes 3*C*T*4 bytes; at N = 1024, C = 1000, T = 100 that is about
// 6.3 MB, some 1.9 us at 3.35 TB/s. The first design compared every score
// with every threshold (N*C*T = 1e8 compares and three adds each) and was
// bound by issued instructions at 28x that. This design does log T work per
// score instead:
//
// - The wrapper sorts the thresholds once (torch.sort, stable, NaN last) and
//   passes the sorted values and their permutation. ge[t] is monotone in the
//   sorted order: p >= s[i] holds exactly for the first b(p) sorted
//   thresholds, with b(p) = #{i : s[i] <= p}. A NaN threshold sorts last and
//   is never <= p, a NaN score has b = 0, so the predicate stays monotone.
// - Each block takes a tile of ct = 4 classes (fewer where the histogram's
//   shared memory needs it) and a chunk of rows, about two blocks per SM.
//   Thread i owns class i % ct and every (256 / ct)-th row, so a warp's loads
//   of scores and labels are coalesced runs of rows' class tiles. It flushes
//   the score, finds b by a branch-free binary search over the flushed sorted
//   thresholds in shared memory (ceil(log2(T + 1)) = 7 compares at T = 100),
//   and adds 1 to bin b of its class's histogram of positives or of negatives
//   (T + 1 bins each) with a shared-memory atomic. Lanes that share a row hit
//   different classes, so the atomics of one instruction rarely meet on an
//   address. Tiles of 4 classes measured faster than 8, 16 or 32 at the main
//   path's shape: the fixed cost of a block (its histogram's zeroing, its
//   flush, the tail below) grows with the tile.
// - The block adds its nonzero bins into an int32 (2, C, T + 1) scratch in
//   device memory, one integer atomicAdd each. The last block of a class
//   tile to finish (a device counter per tile) takes the suffix sums: it
//   loads the tile's histogram into shared memory, every thread sums one
//   segment of one row of bins, and each then writes its segment's suffix
//   sums in place, so that bin b holds the count at sorted threshold b - 1:
//   tps[c, i] = sum_{b > i} pos[c, b], fps the same over negatives, and
//   fns = pos_total - tps. A warp per row writes them through the
//   permutation straight into the float32 (3, C, T) result. One launch per
//   call. What is left above the bound is latency: the thresholds' load, the
//   flush, the tile counter and the tail are round trips in series.
// - Integer counts are exact and do not depend on the order in which blocks
//   run; converted to float32 they equal the JAX package's float32 sums of
//   0/1 values while a call has fewer than 2^24 rows (the wrapper refuses
//   more). Where even one class's 2 (T + 1) bins do not fit in a block's
//   shared memory (T above about 29,000), the histogram lives in the device
//   scratch itself; where the T thresholds exceed 48 KB the search reads them
//   from device memory. No ceiling on T.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 2 * 132;            // two blocks per SM of an H100
constexpr long long kPreferredSmem = 96 * 1024;   // leaves room for two blocks per SM
constexpr long long kThresholdSmem = 48 * 1024;   // thresholds staged up to this size

__device__ __forceinline__ float flush(float x) { return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x; }

// b(p): the number of sorted thresholds s[0, t) that are <= p; p2 is the
// least power of two above t. kFlush: s is in device memory, unflushed.
template <bool kFlush>
__device__ __forceinline__ int bin_of(const float* s, int t, int p2, float p) {
  int b = 0;
  for (int step = p2 >> 1; step > 0; step >>= 1) {
    const int q = b + step - 1;
    if (q < t && (kFlush ? flush(__ldg(s + q)) : s[q]) <= p) b += step;
  }
  return b;
}

__global__ void __launch_bounds__(kThreads)
binned_counters_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                       const float* __restrict__ sorted_thr, const int* __restrict__ perm,
                       int* __restrict__ hist, unsigned int* __restrict__ tile_done, float* __restrict__ out,
                       int n, int c, int t, int p2, int ct, int rows_per_block, int thr_smem, int hist_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_thr = reinterpret_cast<float*>(smem_raw);
  int* s_hist = reinterpret_cast<int*>(smem_raw + (thr_smem ? 4 * t : 0));
  __shared__ int s_last;
  __shared__ int s_seg[kThreads];

  const int bins = t + 1;
  const size_t plane = (size_t)c * bins;  // positives' plane, then negatives'
  const int c0 = blockIdx.x * ct;
  const int classes = min(ct, c - c0);
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);

  if (thr_smem) {
    for (int i = threadIdx.x; i < t; i += kThreads) s_thr[i] = flush(sorted_thr[i]);
  }
  if (hist_smem) {
    for (int i = threadIdx.x; i < 2 * ct * bins; i += kThreads) s_hist[i] = 0;
  }
  __syncthreads();

  const int j = threadIdx.x % ct;
  const int step = kThreads / ct;
  if (j < classes) {
    int* h_pos = hist_smem ? s_hist + j * bins : hist + (size_t)(c0 + j) * bins;
    int* h_neg = hist_smem ? h_pos + ct * bins : h_pos + plane;
#pragma unroll 4
    for (int r = r0 + threadIdx.x / ct; r < r1; r += step) {
      const size_t g = (size_t)r * c + c0 + j;
      const float p = flush(__ldg(preds + g));
      const bool y = __ldg(target + g) != 0;
      const int b = thr_smem ? bin_of<false>(s_thr, t, p2, p) : bin_of<true>(sorted_thr, t, p2, p);
      atomicAdd((y ? h_pos : h_neg) + b, 1);
    }
  }

  if (hist_smem) {
    __syncthreads();
    // a warp per (side, class) row of bins
    for (int q = threadIdx.x >> 5; q < 2 * ct; q += kThreads / 32) {
      const int side = q >= ct;
      const int cls = q - side * ct;
      if (cls >= classes) continue;
      int* dst = hist + side * plane + (size_t)(c0 + cls) * bins;
      for (int b = threadIdx.x & 31; b < bins; b += 32) {
        const int v = s_hist[q * bins + b];
        if (v) atomicAdd(dst + b, v);
      }
    }
  }

  // the last block of this class tile to finish takes the suffix sums
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(tile_done + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the tile's finished histogram (and the permutation) into shared memory,
  // in coalesced independent loads, where they fit
  const int* col = perm;
  if (thr_smem) {
    int* s_perm = reinterpret_cast<int*>(s_thr);
    for (int i = threadIdx.x; i < t; i += kThreads) s_perm[i] = perm[i];
    col = s_perm;
  }
  int* h_tile = hist + (size_t)c0 * bins;
  if (hist_smem) {
    for (int i = threadIdx.x; i < classes * bins; i += kThreads) {
      s_hist[i] = __ldcg(h_tile + i);
      s_hist[ct * bins + i] = __ldcg(h_tile + plane + i);
    }
    h_tile = s_hist;
  }
  __syncthreads();
  const size_t neg = hist_smem ? (size_t)ct * bins : plane;  // from positives to negatives

  // Suffix sums, in place, of the 2 * classes rows of bins, each row cut
  // into `segs` segments of one thread: the segment's sum, the sums of the
  // segments above it, then its own bins from the top down.
  const int rows = 2 * classes;
  const int segs = max(1, kThreads / rows);
  const int seg_len = (bins + segs - 1) / segs;
  {
    const int q = threadIdx.x / segs;  // row: side * classes + class
    const int sg = threadIdx.x - q * segs;
    const bool active = q < rows;
    const int side = q >= classes;
    int* h = h_tile + side * neg + (size_t)(q - side * classes) * bins;
    const int lo = min(bins, sg * seg_len);
    const int hi = min(bins, lo + seg_len);
    int sum = 0;
    if (active) {
      for (int b = lo; b < hi; ++b) sum += hist_smem ? h[b] : __ldcg(h + b);
    }
    s_seg[threadIdx.x] = sum;
    __syncthreads();
    if (active) {
      int run = 0;
      for (int u = sg + 1; u < segs; ++u) run += s_seg[q * segs + u];
      for (int b = hi - 1; b >= lo; --b) {
        run += hist_smem ? h[b] : __ldcg(h + b);
        h[b] = run;  // the row's sum over bins >= b
      }
    }
    __syncthreads();
  }

  // bin b's suffix sum is the count at sorted threshold b - 1: written
  // through the permutation, a warp per row
  const size_t out_plane = (size_t)c * t;
  for (int q = threadIdx.x >> 5; q < rows; q += kThreads / 32) {
    const int side = q >= classes;
    const int cls = q - side * classes;
    const int* h = h_tile + side * neg + (size_t)cls * bins;
    float* o_row = out + (side ? out_plane : 0) + (size_t)(c0 + cls) * t;
    const int pos_total = hist_smem ? h[0] : __ldcg(h);  // all of the class's positives
    for (int b = 1 + (threadIdx.x & 31); b < bins; b += 32) {
      const int v = hist_smem ? h[b] : __ldcg(h + b);
      const int o = col[b - 1];
      o_row[o] = (float)v;
      if (side == 0) o_row[2 * out_plane + o] = (float)(pos_total - v);
    }
  }
}

// The shared memory one block may opt into (227 KB on an H100), and the
// kernel opted into it once per process.
int max_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    // the opt-in limit covers the kernel's static shared memory too
    int dev = 0, got = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&got, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, binned_counters_kernel) != cudaSuccess ||
        cudaFuncSetAttribute(binned_counters_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             got - (int)attr.sharedSizeBytes) != cudaSuccess) {
      cudaGetLastError();  // not left behind for the launch's own check
      return 0;
    }
    bytes = got - (int)attr.sharedSizeBytes;
  }
  return bytes;
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// sorted_thr (t,) are the thresholds ascending (NaN last) and perm (t,) int32
// their original columns; scratch holds 2*c*(t+1) + c zeroed int32 values;
// out (3, c, t) float32 is written whole.
extern "C" int binned_counters_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                      const int* perm, int* scratch, float* out, int n, int c, int t, void* stream) {
  if (c <= 0 || t <= 0) return (int)cudaSuccess;
  const long long bins = (long long)t + 1;
  const int thr_smem = 4LL * t <= kThresholdSmem;
  const long long thr_bytes = thr_smem ? 4LL * t : 0;
  const long long limit = max_shared_bytes();
  int ct = 4;
  while (ct > 1 && thr_bytes + 8LL * ct * bins > kPreferredSmem) ct >>= 1;
  const int hist_smem = thr_bytes + 8LL * ct * bins <= (ct > 1 ? kPreferredSmem : limit);
  if (!hist_smem) ct = 32;
  const long long smem = thr_bytes + (hist_smem ? 8LL * ct * bins : 0);
  int p2 = 1;
  while (p2 <= t) p2 <<= 1;
  const long long tiles = (c + ct - 1) / ct;
  const long long rows_per_pass = kThreads / ct;
  long long chunks = (kTargetBlocks + tiles - 1) / tiles;
  const long long max_chunks = (n + rows_per_pass - 1) / rows_per_pass;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const long long rows_per_block = n > 0 ? (n + chunks - 1) / chunks : 0;
  if (n > 0) chunks = (n + rows_per_block - 1) / rows_per_block;
  if (tiles > 0x7fffffffLL || chunks > 65535) return (int)cudaErrorInvalidConfiguration;
  int* hist = scratch;
  unsigned int* tile_done = reinterpret_cast<unsigned int*>(scratch + 2 * (size_t)c * bins);
  binned_counters_kernel<<<dim3((unsigned)tiles, (unsigned)chunks), kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      preds, target, sorted_thr, perm, hist, tile_done, out, n, c, t, p2, ct, (int)rows_per_block, thr_smem,
      hist_smem);
  return (int)cudaGetLastError();
}
