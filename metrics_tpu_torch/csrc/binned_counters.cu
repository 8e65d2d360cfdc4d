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
//   shared memory needs it, or where C is smaller) and a chunk of rows,
//   about two blocks per SM. Few classes and many rows go to the flat
//   design below instead (the plan there says where).
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
//   run. Each is converted to float32 once, rounded to nearest, as the plain
//   version rounds its int64 sums: bit-equal to it at every row count the
//   int32 counters hold (fewer than 2^31 rows a call, or a lane; the wrapper
//   refuses more), and to the JAX package's float32 sums of 0/1 values below
//   2^24 rows, past which those round at every tile (ROADMAP D71). Every
//   index that rows times classes (times lanes) reaches is 64-bit, and row
//   loops run in unsigned or 64-bit integers, so no index wraps below 2^31
//   rows. Where even one class's 2 (T + 1) bins do not fit in a block's
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
// - Lanes of many rows (a bootstrap's replicas): binned_counters_lanes_kernel,
//   one pass per (lane, class tile). Bound by bytes: at a bootstrap of 20
//   replicas of 1024 rows, C = 1000, T = 100 it reads 102 MB of scores and
//   labels and writes 24.6 MB, 0.0377 ms at 3.35 TB/s. Its first design (the
//   unbatched kernel above with the lane on the grid's third axis) gave
//   every block a whole (lane, tile), yet paid for the reduction across
//   blocks that it never needed: a zeroed device scratch of 2 C (T + 1) + C
//   int32 a lane, global atomics into it, a fence, a tile counter and a
//   reload; and its 4-class tiles used an eighth of each 32-byte sector that
//   a warp's label load fetched. This design:
//   * gives a block 32 classes (fewer where C is smaller or T too large for
//     shared memory), so a warp's loads take one row's 128 bytes of scores
//     and 32 bytes of labels, every fetched byte used;
//   * keeps the tile's histogram in shared memory as [bin][class], so the
//     32 threads of a warp, one row's 32 classes, always add into 32
//     different banks. Below 2^16 rows a lane the two sides share one 32-bit
//     counter, positives in its high half and negatives in its low half:
//     one atomic a score and half the memory (27 KB at T = 100 with the
//     transposed copy and the grid below); from 2^16 rows the sides take a
//     counter each;
//   * finds a score's bin by a lookup, not a binary search: a uniform grid
//     of 2T cells (at most 2048) over the finite thresholds' range holds,
//     for each cell, the run of sorted thresholds whose own cell it is, so a
//     score's bin is the run's start plus a search among the run's few
//     thresholds (none or one at evenly spread thresholds). The cell is the
//     same float arithmetic for scores and thresholds, monotone in its
//     argument, so the count is exact whatever the spread; thresholds bunched
//     in one cell fall back to a binary search among them. Staged up to
//     8,191 thresholds (40 KB with the grid), else searched in device memory;
//   * walks its rows with running pointers, loading the next four rows
//     before it bins the four it holds.
//   * takes the suffix sums in shared memory, through a transposed copy
//     ([class][bin], odd stride) that the writes read without conflicts, and
//     writes the (3, ct, T) output once, through the permutation. No scratch,
//     no fence, no counter.
//   Its builds at the bootstrap's shape, on the card (PERF.md): a binary
//   search in a loop 0.107 ms, bound by the search's issued instructions; a
//   breadth-first search tree unrolled to its depth 0.094; the grid 0.077;
//   the running pointers 0.061. The loads alone, with the tail, took 0.066
//   in the loop's build: what is left is the loads' rate at this access
//   pattern and the tail (suffix sums and writes, 0.016), which every block
//   of the one wave runs at the same time.
//   Where the lanes and tiles give fewer than two blocks an SM (few lanes
//   of more classes than the flat design takes), a (lane, tile)'s rows are
//   cut over the blocks of a thread block cluster (at most 8): each block
//   counts its part in its own shared memory, block r of the cluster sums
//   slice r of every block's histogram into block 0's through distributed
//   shared memory, and block 0 writes. Still no device scratch. Only where
//   one class's histogram and its transposed copy do not fit in a block's
//   shared memory (T above about 29,000, or 14,000 for lanes of 2^16 rows
//   or more) does the form run its first design, whose histogram lives in
//   device memory.
//
// Few classes and many rows (a pixel-level PR curve: 2^24 scores of one
// class), unbatched and lane-batched: binned_counters_flat_kernel. At C = 1
// the designs above have a class tile of one class, so the grid is 264
// blocks (unbatched) or 16 (two lanes, clusters of 8) for 2^24 rows: each
// thread's rows run in series behind scalar 4-byte loads, and all threads
// of a block add into the same 2 (T + 1) bins, which a background-heavy
// score map turns into one address. This design:
//   * reads each lane's (N, C) scores as one flat stream of N * C floats
//     (element i is class i mod C, tracked by a running counter, not a
//     division): float4 scores and the four labels' bytes in one 32-bit
//     load (a funnel shift of two aligned words where the labels start off
//     a 4-byte boundary), a scalar head up to the scores' first 16-byte
//     boundary and a scalar tail, the next two vectors loaded before the
//     two held are binned; 64-bit indices throughout;
//   * fills the card: 512-thread blocks, as many as fit on an SM (two at
//     the kernel's registers; held to four by __launch_bounds__ it ran
//     slower), each lane's stream cut into contiguous parts over
//     ceil(blocks / lanes) blocks, so that two lanes of 2^24 rows spread
//     over all 132 SMs;
//   * bins by the lane kernel's lookup grid (grid_cell, first_in_cell);
//   * keeps R copies of the block's [bin][class] histogram (R = 32 where
//     shared memory allows, at C = 1 and T = 100 12.9 KB), copy = lane % R,
//     interleaved so that word key * R + lane % R is in bank lane % R: the
//     32 adds of a warp never meet on an address or a bank, whatever the
//     scores' skew. Positives take the high 16 bits of a counter and
//     negatives the low 16 where no copy can count 2^16 elements, else a
//     counter a side;
//   * sums the copies of each (side, bin, class) and adds the sum into the
//     lane's int32 (2, C, T + 1) device scratch with one atomic; the last
//     block of a lane (a counter after the histogram) takes the suffix sums,
//     a warp a row with a shuffle scan, and writes the (3, C, T) result
//     through the permutation it staged at the start.
//   What is left above the bound is a fixed cost of about 11 us a launch
//   (the staging, the grid, the reduction across blocks and the last
//   block's tail, in series); past it the stream runs near the card's
//   memory rate (PERF.md).
//   The plan (flat_plan): C at most kFlatMaxClasses, lanes * N * C at least
//   kFlatMinElements, the thresholds staged (T up to 8,191) and the
//   histogram in kFlatSmem; else the designs above. The unbatched call and
//   the many-row lane form both ask it first; the main path's shapes (C =
//   1000) stay where they were. chip_smoke.py checks each side.
//
// All give the counts of the unbatched kernel, lane by lane, bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
  // unsigned: the rows stay below 2^31, so r0 + rows_per_block and r + step
  // cannot wrap
  const unsigned r0 = blockIdx.y * (unsigned)rows_per_block;
  const unsigned r1 = min((unsigned)n, r0 + (unsigned)rows_per_block);

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
    for (unsigned r = r0 + threadIdx.x / ct; r < r1; r += step) {
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

// The many-row lane form, one pass per (lane, class tile); see the note at
// the top. blockIdx.y is the lane; blockIdx.x / parts the class tile, whose
// rows are cut over the `parts` blocks of a cluster. kWide: a counter per
// side (lanes of 2^16 rows or more), else positives in the high half of one
// counter and negatives in its low half.
constexpr int kStageRows = 4;                    // rows a thread loads ahead of those it bins
constexpr int kMaxClusterParts = 8;              // the portable cluster size
constexpr int kStagedThresholds = 8191;         // thresholds staged in shared memory up to this many (32 KB)
constexpr int kMaxCells = 2048;                  // the lookup grid's cells at most

// The cell of p in a uniform grid of g cells over the finite thresholds'
// range [t0, t0 + g / inv]: monotone in p (each float step rounds
// monotonically), NaN in cell 0.
__device__ __forceinline__ int grid_cell(float p, float t0, float inv, int g) {
  const float x = __fmul_rn(__fsub_rn(p, t0), inv);
  return (int)fminf(fmaxf(x, 0.0f), (float)(g - 1));  // fmaxf takes 0 over a NaN
}

// The first of the sorted thresholds s[0, n) whose cell is >= cell
__device__ __forceinline__ int first_in_cell(const float* s, int n, float t0, float inv, int g, int cell) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (grid_cell(s[mid], t0, inv, g) < cell) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// kStaged: the thresholds and their lookup grid in shared memory, else the
// thresholds are searched in device memory
template <bool kWide, bool kStaged>
__global__ void __launch_bounds__(kThreads)
binned_counters_lanes_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                             const float* __restrict__ sorted_thr, const int* __restrict__ perm,
                             float* __restrict__ out, int n, int c, int t, int p2, int ct, int parts,
                             int rows_per_part, int thr_words, int stride, int cells) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned s_seg[kThreads];
  __shared__ int s_valid;       // thresholds that are not NaN (they sort last)
  __shared__ float s_lo, s_hi;  // the least and the greatest finite threshold
  constexpr int kSides = kWide ? 2 : 1;
  const int bins = t + 1;
  const int hist_words = kSides * bins * ct;
  // thr_words words of the sorted thresholds and the lookup grid (later the
  // permutation), the histogram [side][bin][class], its suffix sums
  // [side * ct + class][stride]
  float* s_thr = reinterpret_cast<float*>(smem_raw);
  unsigned* s_grid = reinterpret_cast<unsigned*>(smem_raw) + ((t + 3) & ~3);
  unsigned* s_hist = reinterpret_cast<unsigned*>(smem_raw) + thr_words;
  unsigned* s_tr = s_hist + hist_words;

  const int part = parts > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int c0 = (blockIdx.x / parts) * ct;
  const int classes = min(ct, c - c0);
  const size_t lane = blockIdx.y;
  preds += lane * n * c;
  target += lane * n * c;
  out += lane * 3 * (size_t)c * t;
  const long long r0 = min((long long)n, (long long)part * rows_per_part);
  const long long r1 = min((long long)n, r0 + rows_per_part);

  if (kStaged) {
    if (threadIdx.x == 0) {
      s_valid = t;
      s_lo = s_hi = 0.0f;
    }
    for (int i = threadIdx.x; i < t; i += kThreads) s_thr[i] = flush(sorted_thr[i]);
  }
  for (int i = threadIdx.x; i < hist_words; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  float t0 = 0.0f, inv = 0.0f;
  if (kStaged) {
    // sorted: -inf, finite values, +inf, NaN; each boundary found by the
    // one thread that sees it
    for (int i = threadIdx.x; i < t; i += kThreads) {
      const float v = s_thr[i];
      if (isnan(v) && (i == 0 || !isnan(s_thr[i - 1]))) s_valid = i;
      if (isfinite(v) && (i == 0 || !isfinite(s_thr[i - 1]))) s_lo = v;
      if (isfinite(v) && (i == t - 1 || !isfinite(s_thr[i + 1]))) s_hi = v;
    }
    __syncthreads();
    t0 = s_lo;
    inv = s_hi > s_lo ? (float)cells / (s_hi - s_lo) : 0.0f;
    // grid cell q holds the thresholds [first(q), first(q + 1)) of the sorted
    // order, first(q) the first whose cell is >= q (a NaN's cell is past the
    // grid): p in cell q clears every threshold before first(q), none from
    // first(q + 1) on
    for (int q = threadIdx.x; q < cells; q += kThreads) {
      const int lo = first_in_cell(s_thr, s_valid, t0, inv, cells, q);
      const int hi = q + 1 < cells ? first_in_cell(s_thr, s_valid, t0, inv, cells, q + 1) : s_valid;
      s_grid[q] = (unsigned)lo | ((unsigned)hi << 16);
    }
    __syncthreads();
  }

  // thread i counts class i % ct of every (256 / ct)-th row: a warp takes one
  // row's 32 classes, whose counters sit in 32 banks
  const int j = threadIdx.x % ct;
  const int step = kThreads / ct;
  if (j < classes) {
    unsigned* h = s_hist + j;
    auto add = [&](float p, uint8_t y) {
      p = flush(p);
      int b;
      if (kStaged) {
        // the thresholds before the score's cell, then a search among its own
        const unsigned w = s_grid[grid_cell(p, t0, inv, cells)];
        int lo = w & 0xffffu, hi = w >> 16;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (s_thr[mid] <= p) {
            lo = mid + 1;
          } else {
            hi = mid;
          }
        }
        b = lo;
      } else {
        b = bin_of<true>(sorted_thr, t, p2, p);
      }
      if (kWide) {
        atomicAdd(h + (y ? 0 : bins * ct) + b * ct, 1u);
      } else {
        atomicAdd(h + b * ct, y ? 0x10000u : 1u);
      }
    };
    // this thread's rows, in groups of kStageRows: the next group's loads
    // are issued before this group is searched
    const long long r = r0 + threadIdx.x / ct;
    int left = r < r1 ? (int)((r1 - 1 - r) / step) + 1 : 0;
    const size_t row_step = (size_t)step * c;
    const float* pp = preds + (size_t)r * c + c0 + j;
    const uint8_t* yp = target + (size_t)r * c + c0 + j;
    float p[kStageRows], p_next[kStageRows];
    uint8_t y[kStageRows], y_next[kStageRows];
    auto load = [&](float* pv, uint8_t* yv) {
#pragma unroll
      for (int u = 0; u < kStageRows; ++u) {
        pv[u] = __ldg(pp);
        yv[u] = __ldg(yp);
        pp += row_step;
        yp += row_step;
      }
    };
    if (left >= kStageRows) {
      load(p, y);
      for (left -= kStageRows; left >= kStageRows; left -= kStageRows) {
        load(p_next, y_next);
#pragma unroll
        for (int u = 0; u < kStageRows; ++u) {
          add(p[u], y[u]);
          p[u] = p_next[u];
          y[u] = y_next[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kStageRows; ++u) add(p[u], y[u]);
    }
    for (; left > 0; --left, pp += row_step, yp += row_step) add(__ldg(pp), __ldg(yp));
  }

  if (parts > 1) {
    // block q of the cluster sums slice q of every block's histogram into
    // block 0's, which then writes the tile
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int len = (hist_words + parts - 1) / parts;
    const int hi = min(hist_words, (part + 1) * len);
    unsigned* lead = cluster.map_shared_rank(s_hist, 0);
    for (int i = part * len + threadIdx.x; i < hi; i += kThreads) {
      unsigned sum = 0;
      for (int q = 0; q < parts; ++q) sum += cluster.map_shared_rank(s_hist, q)[i];
      lead[i] = sum;
    }
    cluster.sync();  // block 0's histogram is whole, and no block leaves while another reads its own
    if (part) return;
  } else {
    __syncthreads();
  }

  // the permutation where the thresholds were (the search is over)
  const int* col = perm;
  if (kStaged) {
    int* s_perm = reinterpret_cast<int*>(s_thr);
    for (int i = threadIdx.x; i < t; i += kThreads) s_perm[i] = perm[i];
    col = s_perm;
  }

  // Suffix sums of the kSides * ct rows of bins, each row cut into segments
  // of one thread: the segment's sum, the sums of the segments above it,
  // then its bins from the top down, into the transposed copy. A warp takes
  // one bin of 32 rows: the reads hit 32 banks, and so do the writes (the
  // stride is odd).
  const int rows = kSides * ct;
  const int segs = kThreads / rows;
  const int seg_len = (bins + segs - 1) / segs;
  const int q = threadIdx.x % rows;
  const int sg = threadIdx.x / rows;
  const unsigned* h = s_hist + (q / ct) * bins * ct + q % ct;
  const int lo = min(bins, sg * seg_len);
  const int hi = min(bins, lo + seg_len);
  unsigned sum = 0;
  for (int b = lo; b < hi; ++b) sum += h[b * ct];
  s_seg[threadIdx.x] = sum;
  __syncthreads();
  {
    unsigned run = 0;
    for (int u = sg + 1; u < segs; ++u) run += s_seg[u * rows + q];
    unsigned* tr = s_tr + q * stride;
    for (int b = hi - 1; b >= lo; --b) {
      run += h[b * ct];
      tr[b] = run;  // the row's sum over bins >= b
    }
  }
  __syncthreads();

  // bin b's suffix sum is the count at sorted threshold b - 1: written
  // through the permutation, a warp per class
  const size_t plane = (size_t)c * t;
  for (int cls = threadIdx.x >> 5; cls < classes; cls += kThreads / 32) {
    const unsigned* tp = s_tr + cls * stride;
    const unsigned* fp = s_tr + (kWide ? ct + cls : cls) * stride;
    float* o = out + (size_t)(c0 + cls) * t;
    const unsigned pos_total = kWide ? tp[0] : tp[0] >> 16;  // all of the class's positives
    for (int b = 1 + (threadIdx.x & 31); b < bins; b += 32) {
      const unsigned pos = kWide ? tp[b] : tp[b] >> 16;
      const unsigned neg = kWide ? fp[b] : fp[b] & 0xffffu;
      const int oc = col[b - 1];
      o[oc] = (float)pos;
      o[plane + oc] = (float)neg;
      o[2 * plane + oc] = (float)(pos_total - pos);
    }
  }
}

// The few-class, many-row design; see the note at the top. blockIdx.y is
// the lane, blockIdx.x the part of its flat stream. scratch holds per lane
// the (2, C, T + 1) histogram and, after it, the lane's finished-block
// counter, all zero. kWide: a counter per side, else positives in the high
// half of one counter and negatives in its low half.
constexpr int kFlatThreads = 512;
constexpr int kFlatMaxClasses = 8;                  // the plan's C at most
constexpr long long kFlatMinElements = 1LL << 20;   // and its lanes * N * C at least
constexpr long long kFlatSmem = 44 * 1024;          // a block's dynamic shared memory at most: no opt-in, room for four an SM
constexpr int kFlatStage = 2;                       // vectors a thread loads ahead of those it bins (1 and 4 measured slower)
constexpr int kMaxCopies = 32;                      // copies of a block's histogram at most: one a warp lane

template <bool kWide>
__global__ void __launch_bounds__(kFlatThreads)
binned_counters_flat_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                            const float* __restrict__ sorted_thr, const int* __restrict__ perm,
                            int* __restrict__ scratch, float* __restrict__ out, long long per_lane, int c, int t,
                            int cells, int thr_words, int copies_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_valid, s_last;
  __shared__ float s_lo, s_hi;
  const int bins = t + 1;
  const int keys = (kWide ? 2 : 1) * bins * c;
  const int copies = 1 << copies_log2;
  // thr_words words of the sorted thresholds, their permutation (loaded
  // now, so that the last block reads none of it from device memory) and
  // the lookup grid; then the histogram's copies
  float* s_thr = reinterpret_cast<float*>(smem_raw);
  int* s_perm = reinterpret_cast<int*>(smem_raw) + ((t + 3) & ~3);
  unsigned* s_grid = reinterpret_cast<unsigned*>(smem_raw) + 2 * ((t + 3) & ~3);
  unsigned* s_hist = reinterpret_cast<unsigned*>(smem_raw) + thr_words;

  const size_t lane = blockIdx.y;
  const size_t plane = (size_t)c * bins;
  const float* p = preds + lane * per_lane;
  const uint8_t* y = target + lane * per_lane;
  int* hist = scratch + lane * (2 * plane + c);
  out += lane * 3 * (size_t)c * t;

  if (threadIdx.x == 0) {
    s_valid = t;
    s_lo = s_hi = 0.0f;
  }
  for (int i = threadIdx.x; i < t; i += kFlatThreads) {
    s_thr[i] = flush(sorted_thr[i]);
    s_perm[i] = perm[i];
  }
  for (int i = threadIdx.x; i < (keys << copies_log2); i += kFlatThreads) s_hist[i] = 0;
  __syncthreads();
  // the lookup grid, as binned_counters_lanes_kernel builds it
  for (int i = threadIdx.x; i < t; i += kFlatThreads) {
    const float v = s_thr[i];
    if (isnan(v) && (i == 0 || !isnan(s_thr[i - 1]))) s_valid = i;
    if (isfinite(v) && (i == 0 || !isfinite(s_thr[i - 1]))) s_lo = v;
    if (isfinite(v) && (i == t - 1 || !isfinite(s_thr[i + 1]))) s_hi = v;
  }
  __syncthreads();
  const float t0 = s_lo;
  const float inv = s_hi > s_lo ? (float)cells / (s_hi - s_lo) : 0.0f;
  for (int q = threadIdx.x; q < cells; q += kFlatThreads) {
    const int lo = first_in_cell(s_thr, s_valid, t0, inv, cells, q);
    const int hi = q + 1 < cells ? first_in_cell(s_thr, s_valid, t0, inv, cells, q + 1) : s_valid;
    s_grid[q] = (unsigned)lo | ((unsigned)hi << 16);
  }
  __syncthreads();

  // copy lane % R of the histogram, word key * R + lane % R
  unsigned* h = s_hist + (threadIdx.x & (copies - 1));
  auto add = [&](float x, bool pos, int cls) {
    x = flush(x);
    const unsigned w = s_grid[grid_cell(x, t0, inv, cells)];
    int lo = w & 0xffffu, hi = w >> 16;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_thr[mid] <= x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (kWide) {
      atomicAdd(h + ((((pos ? 0 : bins) + lo) * c + cls) << copies_log2), 1u);
    } else {
      atomicAdd(h + ((lo * c + cls) << copies_log2), pos ? 0x10000u : 1u);
    }
  };

  // the scalar head up to the scores' first 16-byte boundary, the vectors,
  // the scalar tail; the vectors cut into gridDim.x contiguous parts
  const long long head = min(per_lane, (long long)((16 - ((uintptr_t)p & 15)) & 15) >> 2);
  const long long vectors = (per_lane - head) >> 2;
  const long long tail0 = head + 4 * vectors;
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) add(__ldg(p + threadIdx.x), __ldg(y + threadIdx.x) != 0, (int)(threadIdx.x % c));
    const long long e = tail0 + threadIdx.x;
    if (e < per_lane) add(__ldg(p + e), __ldg(y + e) != 0, (int)(e % c));
  }
  const long long per_part = (vectors + gridDim.x - 1) / gridDim.x;
  const long long v0 = min(vectors, (long long)blockIdx.x * per_part) + threadIdx.x;
  const long long v1 = min(vectors, ((long long)blockIdx.x + 1) * per_part);
  long long left = v0 < v1 ? (v1 - 1 - v0) / kFlatThreads + 1 : 0;
  if (left > 0) {
    // the labels of vector v: bytes [head + 4v, head + 4v + 4), from the
    // aligned words around them (the second word holds a byte of the vector
    // whenever the shift is not 0, so it is never past the tensor)
    const int shift = 8 * (int)((uintptr_t)(y + head) & 3);
    const float4* pv = reinterpret_cast<const float4*>(p + head) + v0;
    const uint32_t* yv = reinterpret_cast<const uint32_t*>(y + head - (shift >> 3)) + v0;
    int cls = (int)((head + 4 * v0) % c);
    const int cls_step = (4 * kFlatThreads) % c;
    auto load = [&](float4& a, uint32_t& b) {
      a = __ldg(pv);
      b = shift ? __funnelshift_r(__ldg(yv), __ldg(yv + 1), shift) : __ldg(yv);
      pv += kFlatThreads;
      yv += kFlatThreads;
    };
    auto bin4 = [&](const float4& a, uint32_t b) {
      int k = cls;
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        add(v[j], ((b >> (8 * j)) & 0xffu) != 0, k);
        k = k + 1 == c ? 0 : k + 1;
      }
      cls += cls_step;
      if (cls >= c) cls -= c;
    };
    float4 a[kFlatStage], a_next[kFlatStage];
    uint32_t b[kFlatStage], b_next[kFlatStage];
    if (left >= kFlatStage) {
#pragma unroll
      for (int u = 0; u < kFlatStage; ++u) load(a[u], b[u]);
      for (left -= kFlatStage; left >= kFlatStage; left -= kFlatStage) {
#pragma unroll
        for (int u = 0; u < kFlatStage; ++u) load(a_next[u], b_next[u]);
#pragma unroll
        for (int u = 0; u < kFlatStage; ++u) {
          bin4(a[u], b[u]);
          a[u] = a_next[u];
          b[u] = b_next[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kFlatStage; ++u) bin4(a[u], b[u]);
    }
    for (; left > 0; --left) {
      load(a[0], b[0]);
      bin4(a[0], b[0]);
    }
  }
  __syncthreads();

  // each key's copies summed (read rotated: a warp's 32 keys in 32 banks
  // where R = 32) and added into the lane's scratch
  const int per_side = bins * c;
  for (int k = threadIdx.x; k < keys; k += kFlatThreads) {
    const unsigned* row = s_hist + (k << copies_log2);
    unsigned pos = 0, neg = 0;
    for (int s = 0; s < copies; ++s) {
      const unsigned v = row[(s + k) & (copies - 1)];
      if (kWide) {
        pos += v;
      } else {
        pos += v >> 16;
        neg += v & 0xffffu;
      }
    }
    const int side = kWide ? k / per_side : 0;
    const int r = k - side * per_side;
    const int b = r / c, cls = r - b * c;
    int* dst = hist + side * plane + (size_t)cls * bins + b;
    if (pos) atomicAdd(dst, (int)pos);
    if (!kWide && neg) atomicAdd(dst + plane, (int)neg);
  }

  // the last block of this lane to finish takes the suffix sums
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(reinterpret_cast<unsigned*>(hist + 2 * plane), 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int* s_h = reinterpret_cast<int*>(s_hist);  // [side][class][bin]; the plan leaves room for 2 C (T + 1)
  for (size_t i = threadIdx.x; i < 2 * plane; i += kFlatThreads) s_h[i] = __ldcg(hist + i);
  __syncthreads();

  // a warp a row of bins (2 C rows, at most 16 warps): each lane sums its
  // segment, a shuffle scan gives it the sum of the segments above, and it
  // writes its segment's suffix sums in place; bin b's suffix sum is the
  // count at sorted threshold b - 1, written through the permutation
  const int q = threadIdx.x >> 5, lane_id = threadIdx.x & 31;
  if (q < 2 * c) {
    const int side = q >= c;
    const int cls = q - side * c;
    int* hr = s_h + (size_t)q * bins;
    const int seg_len = (bins + 31) >> 5;
    const int lo = min(bins, lane_id * seg_len), hi = min(bins, lo + seg_len);
    int sum = 0;
    for (int bb = lo; bb < hi; ++bb) sum += hr[bb];
    int above = sum;  // becomes the sum of this lane's segment and every segment above it
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_down_sync(0xffffffffu, above, d);
      if (lane_id + d < 32) above += v;
    }
    int run = above - sum;
    for (int bb = hi - 1; bb >= lo; --bb) {
      run += hr[bb];
      hr[bb] = run;
    }
    __syncwarp();
    const size_t out_plane = (size_t)c * t;
    float* o_row = out + (side ? out_plane : 0) + (size_t)cls * t;
    const int pos_total = hr[0];  // all of the class's positives (side 0)
    for (int bb = 1 + lane_id; bb < bins; bb += 32) {
      const int v = hr[bb];
      const int o = s_perm[bb - 1];
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
  while (ct > 1 && (ct >> 1) >= c) ct >>= 1;  // no idle class slots where C < 4
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

// The shared memory a lanes kernel may use (the opt-in limit less the static
// shared memory of the instance that has the most, rounded up to 1 KB) and
// the card's SM count; 0 if either cannot be read.
int lanes_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0, got = 0;
    cudaFuncAttributes attr;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&got, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, binned_counters_lanes_kernel<false, true>) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    bytes = got - (((int)attr.sharedSizeBytes + 1023) & ~1023);
  }
  return bytes;
}

int sm_count() {
  static int sms = -1;
  if (sms < 0) {
    int dev = 0, got = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&got, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    sms = got;
  }
  return sms;
}

struct LanesPlan {
  int wide, staged, p2, cells, ct, parts, rows_per_part, thr_words, stride;
  long long tiles, smem;
};

// The many-row lane form's plan (c, t, lanes > 0): 0 for the one-pass
// kernel, 1 where one class's histogram and its suffix sums do not fit in a
// block's shared memory (the first design runs, its histogram in device
// memory), -1 if the card's limits cannot be read.
int lanes_plan(int lanes, int n, int c, int t, LanesPlan* pl) {
  const long long limit = lanes_shared_bytes();
  const long long sms = sm_count();
  if (limit <= 0 || sms <= 0) return -1;
  pl->wide = n >= (1 << 16);
  int p2 = 1;
  while (p2 <= t) p2 <<= 1;
  pl->p2 = p2;
  pl->staged = t <= kStagedThresholds;
  pl->cells = 1;
  while (pl->cells < 2 * t && pl->cells < kMaxCells) pl->cells <<= 1;
  pl->thr_words = pl->staged ? ((t + 3) & ~3) + pl->cells : 0;  // the thresholds (later the permutation), the grid
  const long long bins = (long long)t + 1;
  pl->stride = (int)(bins | 1);
  const long long sides = pl->wide ? 2 : 1;
  auto smem = [&](long long ct) { return 4 * (pl->thr_words + sides * ct * (bins + pl->stride)); };
  int ct = 1;
  while (ct < 32 && ct < c) ct <<= 1;
  while (ct > 1 && smem(ct) > kPreferredSmem) ct >>= 1;
  if (smem(ct) > limit) return 1;
  pl->ct = ct;
  pl->smem = smem(ct);
  pl->tiles = (c + ct - 1) / ct;
  // cut a (lane, tile)'s rows over a cluster where the grid has fewer than
  // two blocks an SM, each part at least one staged pass of rows
  const long long per_pass = (long long)kStageRows * (kThreads / ct);
  long long parts = (2 * sms + pl->tiles * lanes - 1) / (pl->tiles * lanes);
  if (parts > kMaxClusterParts) parts = kMaxClusterParts;
  if (parts > (n + per_pass - 1) / per_pass) parts = (n + per_pass - 1) / per_pass;
  if (parts < 1) parts = 1;
  pl->parts = (int)parts;
  pl->rows_per_part = (int)((n + parts - 1) / parts);
  return 0;
}

int lanes_launch(const float* preds, const uint8_t* target, const float* sorted_thr, const int* perm, float* out,
                 int lanes, int n, int c, int t, const LanesPlan& pl, cudaStream_t stream) {
  if (pl.tiles * pl.parts > 0x7fffffffLL || lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  void (*kernel)(const float*, const uint8_t*, const float*, const int*, float*, int, int, int, int, int, int, int, int,
                 int, int) = pl.wide ? (pl.staged ? binned_counters_lanes_kernel<true, true> : binned_counters_lanes_kernel<true, false>)
                                     : (pl.staged ? binned_counters_lanes_kernel<false, true> : binned_counters_lanes_kernel<false, false>);
  // each instance opts into the most shared memory it has been given so far
  static int opted[2][2] = {};
  if (pl.smem > opted[pl.wide][pl.staged]) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return (int)err;
    }
    opted[pl.wide][pl.staged] = (int)pl.smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(pl.tiles * pl.parts), (unsigned)lanes, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)pl.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, preds, target, sorted_thr, perm, out, n, c, t, pl.p2, pl.ct,
                                             pl.parts, pl.rows_per_part, pl.thr_words, pl.stride, pl.cells);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

struct FlatPlan {
  int wide, copies_log2, cells, thr_words, parts;
  long long smem;
};

// The flat design's plan (lanes, n > 0): 0 where it runs, 1 where the
// shape goes to the designs above, -1 if the card's limits cannot be read.
// Whether it runs depends on the shapes alone; the card's SM count and
// occupancy set only its grid.
int flat_plan(int lanes, int n, int c, int t, FlatPlan* pl) {
  const long long per_lane = (long long)n * c;
  if (c <= 0 || c > kFlatMaxClasses || t <= 0 || t > kStagedThresholds || (long long)lanes * per_lane < kFlatMinElements) return 1;
  pl->cells = 1;
  while (pl->cells < 2 * t && pl->cells < kMaxCells) pl->cells <<= 1;
  pl->thr_words = 2 * ((t + 3) & ~3) + pl->cells;  // the thresholds, their permutation, the grid
  const long long bins = (long long)t + 1;
  // the most copies that fit, the suffix sums' 2 C (T + 1) words at least
  auto fit = [&](int wide) {
    const long long keys = (wide ? 2 : 1) * bins * c;
    int copies = kMaxCopies;
    auto smem = [&](long long r) { return 4 * (pl->thr_words + (keys * r > 2 * bins * c ? keys * r : 2 * bins * c)); };
    while (copies > 1 && smem(copies) > kFlatSmem) copies >>= 1;
    pl->copies_log2 = 0;
    while ((1 << pl->copies_log2) < copies) ++pl->copies_log2;
    pl->smem = smem(copies);
    return pl->smem <= kFlatSmem;
  };
  if (!fit(0)) return 1;
  const long long sms = sm_count();
  // blocks an SM at this shared memory, asked once per size (a word each)
  static int occupancy[kFlatSmem / 4 + 1] = {};
  int per_sm = occupancy[pl->smem / 4];
  if (per_sm <= 0) {
    if (sms <= 0 || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binned_counters_flat_kernel<false>, kFlatThreads,
                                                                  (size_t)pl->smem) != cudaSuccess || per_sm <= 0) {
      cudaGetLastError();
      return -1;
    }
    occupancy[pl->smem / 4] = per_sm;
  }
  // a lane's vectors cut over ceil(blocks / lanes) parts, each at least
  // kFlatStage vectors a thread
  const long long vectors = per_lane / 4 + 1;
  long long parts = (sms * per_sm + lanes - 1) / lanes;
  const long long most = (vectors + (long long)kFlatThreads * kFlatStage - 1) / ((long long)kFlatThreads * kFlatStage);
  if (parts > most) parts = most;
  if (parts < 1) parts = 1;
  pl->parts = (int)parts;
  // the elements one copy can count: its threads' vectors, the head and the tail
  const long long per_thread = ((vectors + parts - 1) / parts + kFlatThreads - 1) / kFlatThreads;
  pl->wide = (kFlatThreads >> pl->copies_log2) * per_thread * 4 + 6 >= (1 << 16);
  if (pl->wide && !fit(1)) return 1;
  return 0;
}

int flat_launch(const float* preds, const uint8_t* target, const float* sorted_thr, const int* perm, int* scratch,
                float* out, int lanes, int n, int c, int t, const FlatPlan& pl, cudaStream_t stream) {
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)pl.parts, (unsigned)lanes);
  if (pl.wide) {
    binned_counters_flat_kernel<true><<<grid, kFlatThreads, (size_t)pl.smem, stream>>>(
        preds, target, sorted_thr, perm, scratch, out, (long long)n * c, c, t, pl.cells, pl.thr_words, pl.copies_log2);
  } else {
    binned_counters_flat_kernel<false><<<grid, kFlatThreads, (size_t)pl.smem, stream>>>(
        preds, target, sorted_thr, perm, scratch, out, (long long)n * c, c, t, pl.cells, pl.thr_words, pl.copies_log2);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// sorted_thr (t,) are the thresholds ascending (NaN last) and perm (t,) int32
// their original columns; scratch holds 2*c*(t+1) + c zeroed int32 values;
// out (3, c, t) float32 is written whole. The flat design where its plan
// takes the shape, else the binary-search histogram.
extern "C" int binned_counters_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                      const int* perm, int* scratch, float* out, int n, int c, int t, void* stream) {
  if (c <= 0 || t <= 0) return (int)cudaSuccess;
  FlatPlan fl;
  const int flat = n > 0 ? flat_plan(1, n, c, t, &fl) : 1;
  if (flat < 0) return (int)cudaErrorInvalidDevice;
  if (flat == 0) return flat_launch(preds, target, sorted_thr, perm, scratch, out, 1, n, c, t, fl, (cudaStream_t)stream);
  return launch(preds, target, sorted_thr, perm, scratch, out, 1, n, c, t, (cudaStream_t)stream);
}

// 1 where binned_counters_launch (lanes = 1) or binned_counters_lanes_launch
// runs the flat design at this shape with 16-bit halves, 2 where with a
// counter a side, else 0 (-1 if the card's limits cannot be read): how the
// wrapper counts the flat design's launches.
extern "C" int binned_counters_flat_plan(int lanes, int n, int c, int t) {
  if (n <= 1 || c <= 0 || t <= 0 || lanes <= 0) return 0;
  FlatPlan fl;
  const int flat = flat_plan(lanes, n, c, t, &fl);
  return flat < 0 ? -1 : flat == 0 ? 1 + fl.wide : 0;
}

// Scratch int32 values the lane-batched form needs: none for lanes of one
// row or where the one-pass kernel runs, else (the flat design, or the
// first design) 2*c*(t+1) + c per lane.
extern "C" long long binned_counters_lanes_scratch(int lanes, int n, int c, int t) {
  if (n <= 1 || c <= 0 || t <= 0 || lanes <= 0) return 0;
  const long long per_lane = 2LL * c * (t + 1) + c;
  FlatPlan fl;
  if (flat_plan(lanes, n, c, t, &fl) == 0) return lanes * per_lane;
  LanesPlan pl;
  return lanes_plan(lanes, n, c, t, &pl) == 1 ? lanes * per_lane : 0;
}

// The lane-batched form: preds and target (lanes, n, c), one shared set of
// thresholds, out (lanes, 3, c, t) float32 written whole. Lanes of one row
// take the one-row kernel; lanes of many the flat design where its plan
// takes them, else the one-pass kernel, or its first design where that
// plan says so, the last two over a zeroed scratch of
// binned_counters_lanes_scratch(lanes, n, c, t) values (at most 65,535
// lanes a launch; the wrapper splits).
extern "C" int binned_counters_lanes_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                            const int* perm, int* scratch, float* out, int lanes, int n, int c, int t,
                                            void* stream) {
  if (n == 1) return rows_launch(preds, target, sorted_thr, perm, out, lanes, c, t, 0, (cudaStream_t)stream);
  if (c <= 0 || t <= 0 || lanes <= 0) return (int)cudaSuccess;
  FlatPlan fl;
  const int flat = n > 0 ? flat_plan(lanes, n, c, t, &fl) : 1;
  if (flat < 0) return (int)cudaErrorInvalidDevice;
  if (flat == 0) return flat_launch(preds, target, sorted_thr, perm, scratch, out, lanes, n, c, t, fl, (cudaStream_t)stream);
  LanesPlan pl;
  const int how = lanes_plan(lanes, n, c, t, &pl);
  if (how < 0) return (int)cudaErrorInvalidDevice;
  if (how == 0) return lanes_launch(preds, target, sorted_thr, perm, out, lanes, n, c, t, pl, (cudaStream_t)stream);
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(preds, target, sorted_thr, perm, scratch, out, lanes, n, c, t, (cudaStream_t)stream);
}

// The many-row form's first design at any shape: the unbatched kernel with
// the lane on its grid, over a zeroed scratch of lanes * (2*c*(t+1) + c)
// int32 values. The form's path where the one-pass plan does not fit, and
// elsewhere the design that chip_smoke.py times beside the one-pass kernel
// (at lanes = 1 the binary-search histogram, whatever the flat plan says).
// Arguments as binned_counters_lanes_launch.
extern "C" int binned_counters_lanes_grid_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                                 const int* perm, int* scratch, float* out, int lanes, int n, int c,
                                                 int t, void* stream) {
  return launch(preds, target, sorted_thr, perm, scratch, out, lanes, n, c, t, (cudaStream_t)stream);
}

// The one-row form's warp-per-pair kernel at any T: the form's path for long
// rows, and at short rows its first design, which chip_smoke.py times beside
// the tiled kernel. Arguments as binned_counters_lanes_launch with n = 1.
extern "C" int binned_counters_rows_warp_launch(const float* preds, const uint8_t* target, const float* sorted_thr,
                                                const int* perm, float* out, int lanes, int c, int t, void* stream) {
  return rows_launch(preds, target, sorted_thr, perm, out, lanes, c, t, 1, (cudaStream_t)stream);
}
