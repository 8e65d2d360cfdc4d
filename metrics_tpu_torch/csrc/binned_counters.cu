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
//
// The lane-batched form (binned_counters_lanes_launch) is what the TPU
// kernel becomes under pallas_call's batching rule, reached here from
// torch.func.vmap (ops/_build.py::lane_route): preds and target (B, N, C)
// with one shared threshold set give (B, 3, C, T), each lane counted on its
// own. It has two kernels:
//
// - Lanes of one row (a SlicedMetric's per-row deltas): the histogram, its
//   scratch, its zeroing and its suffix sums would be pure overhead, since
//   each (lane, class) pair has a single score. Each pair's bin b comes from
//   the binary search above, and sorted threshold i is cleared iff i < b, so
//   the pair's three rows of 0/1 counts are written straight out. Every
//   output float is written once and nothing else is written, so the form is
//   bound by its output: at the sliced shape (1024 lanes, C = 1000, T = 100)
//   1.23 GB, about 0.37 ms at 3.35 TB/s, against 5 MB of inputs. A pair's
//   row is short (T = 100 floats, 400 B), so a first design that gave each
//   pair a warp wrote partial, misaligned runs through the permutation and
//   took 2.7x the bound (PERF.md). binned_counters_row_tiles_kernel instead
//   has a block find the bins of a tile of 64 pairs, then write the tile's
//   planes in (pair, column) order across the pairs' rows, each column
//   cleared iff its rank among the sorted thresholds (the inverse
//   permutation, in shared memory) is below the pair's bin: every warp's
//   store is one coalesced 128-byte run. With more thresholds than shared
//   memory holds (long rows) a warp per pair remains
//   (binned_counters_rows_kernel).
// - Lanes of many rows (a bootstrap's replicas): the histogram kernel above
//   with the lane as the grid's third axis, each lane with its own
//   histogram, tile counters and output, and the row chunks cut so that the
//   grid keeps about two blocks per SM over all lanes. Bound as the
//   unbatched kernel, times B.
//
// Both give the counts of the unbatched kernel, lane by lane, bit for bit.

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

// kLanes: blockIdx.z is the lane, and each lane has its own rows, output,
// histogram and tile counters (hist and tile_done are lane 0's, and a lane's
// histogram is followed by its counters).
template <bool kLanes>
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
  if (kLanes) {
    const size_t lane = blockIdx.z;
    preds += lane * n * c;
    target += lane * n * c;
    out += lane * 3 * (size_t)c * t;
    hist += lane * (2 * plane + c);
    tile_done = reinterpret_cast<unsigned int*>(hist + 2 * plane);
  }
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

// The one-row form: every lane holds one row, so the (lane, class) pairs are
// rows of their own, each with one bin b, found by the same binary search;
// sorted threshold i is cleared iff i < b. No histogram, no scratch, no
// suffix sums: each output float is written once.
//
// With the thresholds staged in shared memory (8 T bytes within 48 KB), a
// block takes a tile of kTileRows consecutive pairs: one thread per pair
// finds its bin, then the block writes the tile's three planes in (pair,
// column) order, so that neighbouring threads write neighbouring floats
// across the pairs' short rows (T floats each) and every store is a full
// coalesced run. Column j is cleared iff its rank among the sorted
// thresholds (the inverse permutation, in shared memory) is below b.
constexpr int kTileRows = 64;

__global__ void __launch_bounds__(kThreads)
binned_counters_row_tiles_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                                 const float* __restrict__ sorted_thr, const int* __restrict__ perm,
                                 float* __restrict__ out, long long rows, int c, int t, int p2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_thr = reinterpret_cast<float*>(smem_raw);
  int* s_rank = reinterpret_cast<int*>(smem_raw + 4 * (size_t)t);
  __shared__ long long s_base[kTileRows];  // where the pair's row of the first plane starts
  __shared__ int s_bin[kTileRows];
  __shared__ int s_pos[kTileRows];
  for (int i = threadIdx.x; i < t; i += kThreads) {
    s_thr[i] = flush(sorted_thr[i]);
    s_rank[perm[i]] = i;
  }
  __syncthreads();
  const size_t plane = (size_t)c * t;
  const int step_rows = kThreads / t, step_cols = kThreads % t;  // the flat stride in (pair, column)
  const long long tiles = (rows + kTileRows - 1) / kTileRows;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * kTileRows;
    const int n_rows = (int)min((long long)kTileRows, rows - r0);
    if (threadIdx.x < n_rows) {
      const long long r = r0 + threadIdx.x;
      const long long lane = r / c;
      s_base[threadIdx.x] = lane * 3 * (long long)plane + (r - lane * c) * t;
      s_bin[threadIdx.x] = bin_of<false>(s_thr, t, p2, flush(__ldg(preds + r)));
      s_pos[threadIdx.x] = __ldg(target + r) != 0;
    }
    __syncthreads();
    int row = threadIdx.x / t;
    int col = threadIdx.x - row * t;
    while (row < n_rows) {
      float* o = out + s_base[row] + col;
      const bool ge = s_rank[col] < s_bin[row];
      const bool y = s_pos[row] != 0;
      o[0] = (y && ge) ? 1.0f : 0.0f;
      o[plane] = (!y && ge) ? 1.0f : 0.0f;
      o[2 * plane] = (y && !ge) ? 1.0f : 0.0f;
      row += step_rows;
      col += step_cols;
      if (col >= t) {
        col -= t;
        ++row;
      }
    }
    __syncthreads();
  }
}

// The one-row form with more thresholds than shared memory holds: a warp
// per pair, writing its (long) rows through the permutation.
__global__ void __launch_bounds__(kThreads)
binned_counters_rows_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                            const float* __restrict__ sorted_thr, const int* __restrict__ perm,
                            float* __restrict__ out, long long rows, int c, int t, int p2, int staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_thr = reinterpret_cast<float*>(smem_raw);
  int* s_perm = reinterpret_cast<int*>(smem_raw + 4 * (size_t)t);
  if (staged) {
    for (int i = threadIdx.x; i < t; i += kThreads) {
      s_thr[i] = flush(sorted_thr[i]);
      s_perm[i] = perm[i];
    }
    __syncthreads();
  }
  const size_t plane = (size_t)c * t;
  const int warps = kThreads / 32;
  const int lane_id = threadIdx.x & 31;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5); r < rows; r += (long long)gridDim.x * warps) {
    const long long lane = r / c;
    const int cls = (int)(r - lane * c);
    const float p = flush(__ldg(preds + r));
    const bool y = __ldg(target + r) != 0;
    const int b = staged ? bin_of<false>(s_thr, t, p2, p) : bin_of<true>(sorted_thr, t, p2, p);
    float* o = out + (size_t)lane * 3 * plane + (size_t)cls * t;
    for (int i = lane_id; i < t; i += 32) {
      const int col = staged ? s_perm[i] : __ldg(perm + i);
      const bool ge = i < b;
      o[col] = (y && ge) ? 1.0f : 0.0f;
      o[plane + col] = (!y && ge) ? 1.0f : 0.0f;
      o[2 * plane + col] = (y && !ge) ? 1.0f : 0.0f;
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
        cudaFuncGetAttributes(&attr, binned_counters_kernel<false>) != cudaSuccess ||
        cudaFuncSetAttribute(binned_counters_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             got - (int)attr.sharedSizeBytes) != cudaSuccess ||
        cudaFuncSetAttribute(binned_counters_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             got - (int)attr.sharedSizeBytes) != cudaSuccess) {
      cudaGetLastError();  // not left behind for the launch's own check
      return 0;
    }
    bytes = got - (int)attr.sharedSizeBytes;
  }
  return bytes;
}

int launch(const float* preds, const uint8_t* target, const float* sorted_thr, const int* perm, int* scratch,
           float* out, int lanes, int n, int c, int t, cudaStream_t stream) {
  if (c <= 0 || t <= 0 || lanes <= 0) return (int)cudaSuccess;
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
  long long chunks = (kTargetBlocks + tiles * lanes - 1) / (tiles * lanes);
  const long long max_chunks = (n + rows_per_pass - 1) / rows_per_pass;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const long long rows_per_block = n > 0 ? (n + chunks - 1) / chunks : 0;
  if (n > 0) chunks = (n + rows_per_block - 1) / rows_per_block;
  if (tiles > 0x7fffffffLL || chunks > 65535 || lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  int* hist = scratch;
  unsigned int* tile_done = reinterpret_cast<unsigned int*>(scratch + 2 * (size_t)c * bins);
  const dim3 grid((unsigned)tiles, (unsigned)chunks, (unsigned)lanes);
  if (lanes == 1) {
    binned_counters_kernel<false><<<grid, kThreads, (size_t)smem, stream>>>(
        preds, target, sorted_thr, perm, hist, tile_done, out, n, c, t, p2, ct, (int)rows_per_block, thr_smem, hist_smem);
  } else {
    binned_counters_kernel<true><<<grid, kThreads, (size_t)smem, stream>>>(
        preds, target, sorted_thr, perm, hist, tile_done, out, n, c, t, p2, ct, (int)rows_per_block, thr_smem, hist_smem);
  }
  return (int)cudaGetLastError();
}

// The one-row form: the tiled kernel where the thresholds fit in shared
// memory (unless warp_rows), else a warp per pair.
int rows_launch(const float* preds, const uint8_t* target, const float* sorted_thr, const int* perm, float* out,
                int lanes, int c, int t, int warp_rows, cudaStream_t stream) {
  if (c <= 0 || t <= 0 || lanes <= 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int staged = 8LL * t <= kThresholdSmem;
  int p2 = 1;
  while (p2 <= t) p2 <<= 1;
  const long long rows = (long long)lanes * c;
  if (staged && !warp_rows) {
    long long blocks = (rows + kTileRows - 1) / kTileRows;
    if (blocks > 8LL * sms) blocks = 8LL * sms;  // 2048 threads per SM, each block walking many tiles
    binned_counters_row_tiles_kernel<<<(unsigned)blocks, kThreads, 8 * (size_t)t, stream>>>(
        preds, target, sorted_thr, perm, out, rows, c, t, p2);
    return (int)cudaGetLastError();
  }
  const long long per_block = kThreads / 32;
  long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 8LL * sms) blocks = 8LL * sms;  // 2048 threads per SM, each warp walking many pairs
  binned_counters_rows_kernel<<<(unsigned)blocks, kThreads, staged ? 8 * (size_t)t : 0, stream>>>(
      preds, target, sorted_thr, perm, out, rows, c, t, p2, staged);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// sorted_thr (t,) are the thresholds ascending (NaN last) and perm (t,) int32
// their original columns; scratch holds 2*c*(t+1) + c zeroed int32 values;
// out (3, c, t) float32 is written whole.
extern "C" int binned_counters_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                      const int* perm, int* scratch, float* out, int n, int c, int t, void* stream) {
  return launch(preds, target, sorted_thr, perm, scratch, out, 1, n, c, t, (cudaStream_t)stream);
}

// Scratch int32 values the lane-batched form needs: none for lanes of one
// row, else 2*c*(t+1) + c per lane.
extern "C" long long binned_counters_lanes_scratch(int lanes, int n, int c, int t) {
  return n == 1 ? 0 : (long long)lanes * (2LL * c * (t + 1) + c);
}

// The lane-batched form: preds and target (lanes, n, c), one shared set of
// thresholds, out (lanes, 3, c, t) float32 written whole. Lanes of one row
// take the one-row kernel; others the histogram kernel with the lane on the
// grid (at most 65,535 lanes a launch; the wrapper splits), over a zeroed
// scratch of binned_counters_lanes_scratch(lanes, n, c, t) values.
extern "C" int binned_counters_lanes_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                            const int* perm, int* scratch, float* out, int lanes, int n, int c, int t,
                                            void* stream) {
  if (n != 1) return launch(preds, target, sorted_thr, perm, scratch, out, lanes, n, c, t, (cudaStream_t)stream);
  return rows_launch(preds, target, sorted_thr, perm, out, lanes, c, t, 0, (cudaStream_t)stream);
}

// The one-row form's warp-per-pair kernel at any T: the form's path for long
// rows, and at short rows its first design, which chip_smoke.py times beside
// the tiled kernel. Arguments as binned_counters_lanes_launch with n = 1.
extern "C" int binned_counters_rows_warp_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                                const int* perm, float* out, int lanes, int c, int t, void* stream) {
  return rows_launch(preds, target, sorted_thr, perm, out, lanes, c, t, 1, (cudaStream_t)stream);
}
