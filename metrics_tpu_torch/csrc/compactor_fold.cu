// Kernel K3 for Hopper (sm_90a): KLL compactor folds, one level
// (compactor_fold_slots_kernel, compactor_fold_tiles_kernel) and a whole
// level cascade in one launch (compactor_cascade_kernel, and for lanes
// compactor_cascade_split_kernel).
//
// Replaces the TPU kernel metrics_tpu/ops/pallas_kernels.py::_make_fold_kernel
// -> _fold_kernel (pallas_call at :188), together with the jnp.sort that runs
// just before it in metrics_tpu/ops/compactor.py::fold_level, and the level
// loops around it: compactor.py::fold_cascade and
// streaming/sketches.py::QuantileSketchState.sketch_merge.
//
// One fold. Inputs are two ascending runs, each +inf past its valid count: a
// (na) with a_count valid values and b (nb) with b_count. Let merged be their
// merge and c = a_count + b_count. With p_len = (na + nb) / 2:
//   c <= k: items[t] = merged[t] for t < k, count = c, promoted all +inf,
//           pcount = 0 (the level absorbs everything);
//   c >  k: promoted[j] = merged[2j + (j & 1)] for j < c / 2 and +inf after,
//           pcount = c / 2; the odd leftover merged[2 (c / 2)] stays at the
//           level as items[0] (count = c % 2), items +inf otherwise.
// Both runs are sorted, so the sort is a merge, ties taken from a first.
// Equal values are equal bits (the sketch's items hold no NaN, no -0.0 and
// no denormal: the precompaction canonicalises them; a valid +inf equals the
// padding's), so the tie order cannot change an output, and merged[t] for
// t >= c is +inf: only the valid prefixes are merged. Counts are clamped to
// [0, na] and [0, nb].
//
// The single fold, one launch per fold; its lane-batched form
// (compactor_fold_lanes_launch, what fold_level becomes under
// torch.func.vmap) puts the lane on the grid's second axis, each lane with
// its own runs, counts and outputs. Bound by bytes: a fold reads its two
// valid prefixes and writes k + p_len floats, under 0.1 MB a lane at the
// stream's shape (k = 6600), a fraction of a microsecond; what a fold takes
// is latency. The first design (compactor_fold_search_kernel, still
// callable as compactor_fold_search_launch and _search_lanes_launch for
// timing beside this one) runs a thread for every output slot, each with a
// co-rank search over the whole of both arrays, +inf padding included: 13
// or 14 dependent loads even where a run is empty. This design has two
// kernels, and a plan that picks one from the shapes (the counts live on
// the device and the launch reads none back):
//   - compactor_fold_slots_kernel, a thread an output slot as before, but
//     searching the valid prefixes only and only the positions the fold
//     keeps (c when the level absorbs, c / 2 and the odd leftover when it
//     promotes); every other slot is a +inf store. Where a run is empty the
//     search ends at once and the fold is a copy. Latency is all a fold at
//     a few lanes has, and here a slot waits for its counts and one
//     search;
//   - compactor_fold_tiles_kernel, where the lanes are many: a block owns
//     kTile consecutive merged positions of [0, c); its threads each take a
//     run of 4, find the run's co-rank by one search in device memory
//     (neighbouring threads' searches share their first steps, which the
//     L1 cache serves) and merge the run into a shared tile, which the
//     block writes out coalesced: items[p] when c <= k; when c > k the
//     positions p % 4 in {0, 3} as promoted[p / 2] and the odd leftover
//     into items[0]. A quarter of the searches, none past c, and
//     ceil((na + nb) / kTile) blocks a lane instead of ceil((k + p_len) /
//     256); the +inf fills are float4 stores spread over the lane's blocks,
//     and with nothing incoming and c <= k a tile is a copy of a,
//     unsearched;
//   - the plan (fold_slots): the slots where the lanes' slot blocks fit on
//     the card at once (one wave, by the kernel's occupancy; PERF.md gives
//     the lanes that makes at the stream's shape), the tiles past that. On the card the tiles' chain (a
//     search, four dependent merge steps, a barrier) lost to the slots at
//     8 lanes in every state of the sketch's insert, and the slots' blocks
//     past one wave lost to the tiles at 100 (PERF.md).
// Staging the tile's windows of a and b in shared memory after two co-rank
// searches in device memory (by a warp's or 128 threads' probes), or the
// whole runs, measured slower on the card than the tiles: a round of
// scattered probes costs about as much as the L1-served search.
//
// The cascade. A sketch update folds a run into its start level, the
// promoted run into the next level, and so on up; the top level absorbs and
// saturates at k. A merge of two sketches first merges the other sketch's
// level with the carry from below, then folds that into the level. Done fold
// by fold that is one launch per level (11 per update and 39 per merge at the
// stream's shape) plus the host's work around each, while each fold moves
// only ~90 KB: the launch, not the bytes, was the cost. compactor_cascade_kernel
// walks all the levels in one launch:
//   - block 0 (1024 threads) walks the levels in order. The level being
//     folded, the incoming run and the carry live in dynamic shared memory:
//     2k + 2 max(M, k) floats for an insert, 7k for a merge (level k, other
//     level k, merged input 3k, promoted 2k): 184,800 B at k = 6600, within
//     the 227 KB a block may opt into. The next level (and, in a merge, the
//     other sketch's next level) is fetched with cp.async while the current
//     one is merged, only its valid prefix. Each thread finds its first
//     merged position by one co-rank search in shared memory and then merges
//     its own contiguous ~c/1024 outputs sequentially.
//   - the promoted run stays in shared memory as the next level's carry; the
//     counts are read and written on the device, so an update reads nothing
//     back to the host. Once an insert's carry is empty, block 0 copies the
//     levels above through unchanged; the levels below the start level are
//     copied by the other blocks of the launch, in parallel.
//   - larger k (where those buffers exceed the block's shared memory, e.g.
//     eps = 0.001, k ~ 66,000): the same kernel runs out of a device-memory
//     scratch (the merged input and the carries, L2-resident at that size)
//     and reads the levels straight from device memory. No new ceiling on k.
// That walking kernel is the unbatched cascade (compactor_cascade_launch).
//
// The lane-batched cascade (compactor_cascade_lanes_launch) is what the TPU
// fold becomes under pallas_call's batching rule, reached here from
// torch.func.vmap (ops/_build.py::lane_route): a bootstrap of a
// QuantileSketch updates or merges B sketches at once. Its first design
// was the walking kernel with the lane on the grid: at 8 lanes, 8
// SMs walk their chains of level steps while the rest of the card idles,
// and one block copies the levels an insert does not reach.
// compactor_cascade_split_kernel gives each lane `parts` blocks (4 to 8)
// that split every level by value:
//   - splitters are taken once, from the incoming run (an insert: block q
//     takes the run's values [ci q / parts, ci (q + 1) / parts)) or from the
//     sketch's fullest level (a merge); block q takes the values between
//     splitter q and q + 1 of every level. Every value of a block is at
//     most every value of the next, so the lane's merge is its blocks'
//     merges one after another; the promoted values of a block fall in its
//     own range, so its slice of the carry stays in its shared memory, and a
//     merge's input (the other sketch's level with the carry) is merged
//     slice by slice;
//   - at each level every block finds every block's slice bounds (parts - 1
//     searches in shared memory at once, one warp each), and with them and
//     the carry slices' counts (a function of the last level's) every
//     block's merged count and its own offset among the lane's merged
//     positions: the promotion's parity and the kept items are global
//     positions. No block waits for another, and nothing moves between
//     them;
//   - each block stages the next level (and a merge the other sketch's next
//     level) with cp.async while it folds the current one, splits the rows
//     written and the levels copied through with the other blocks, and
//     keeps the counts in shared memory.
// A thread-block cluster that keeps the whole carry in every block, each
// block pushing its share of the promoted run into the others' over
// distributed shared memory, measured slower than this: the remote stores
// and the cluster barrier a level cost more than the merge (PERF.md). The
// plan (lanes_parts) is decided from the shapes alone: parts = the SMs over
// the lanes, at most 8, where the buffers fit a block's shared memory;
// where they do not (k past about 14,000 for an insert of k items, 7,200
// for a merge; the walking kernel stages up to 8,300 and runs out of device
// memory past that) or where the lanes leave fewer than 4 blocks a lane
// (more than 33 lanes on 132 SMs), the lane form runs the walking kernel
// with the lane on the grid. compactor_cascade_lanes_walk_launch and
// _split_launch (at any size the plan can give) stay callable for timing
// and parity.
//
// Bound: bytes, and in practice latency. An insert at the stream's shape
// (L = 20, k = 6600) must read and write the (L, k) levels once: about 1 MB;
// a merge reads two sketches and writes one, 1.6 MB. The work per byte is a
// few compares. A cascade is a chain of short dependent level steps; what
// the one launch saves is the launches, and what the split shares out is
// each step's merge and the copies.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;        // merged positions a block of the tiled fold
constexpr int kTilePerThread = kTile / kThreads;
constexpr int kCascadeThreads = 1024;
constexpr int kCopyBlocks = 16;  // blocks that copy the levels below the start level
constexpr int kMaxParts = 8;     // blocks a lane of the value-split kernel at most
constexpr int kSplitThreads = 512;  // at least 32 * 2 * kMaxParts: a warp for each inner slice bound of two runs
constexpr int kMinRun = 4;           // merged positions a thread of the value-split kernel at least
constexpr int kMinParts = 4;         // the lane cascade's plan runs the value-split kernel from this many blocks a lane

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// Number of a's values among the first `diag` values of the merge (a first
// on ties).
__device__ __forceinline__ int merge_path(const float* a, int na, const float* b, int nb, int diag) {
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

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// dst[lo, hi) = +inf, by the `parts` blocks of which this block is `part`:
// 16-byte stores, a scalar head and tail
__device__ void fill_inf(float* dst, int lo, int hi, int part, int parts) {
  if (lo >= hi) return;
  const float inf = pos_inf();
  float* p = dst + lo;
  const int n = hi - lo;
  const int head = min(n, (int)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) >> 2));
  const int n4 = (n - head) >> 2;
  const int t = part * blockDim.x + threadIdx.x;
  const int stride = parts * blockDim.x;
  float4* body = reinterpret_cast<float4*>(p + head);
  for (int i = t; i < n4; i += stride) body[i] = make_float4(inf, inf, inf, inf);
  const int rest = head + 4 * n4;
  if (t < head) p[t] = inf;
  if (t < n - rest) p[rest + t] = inf;
}

// dst[0, n) = src[0, n), device memory to device memory, by the `parts`
// blocks of which this block is `part`: 16-byte copies where the two
// pointers share their alignment
__device__ void copy_share(float* __restrict__ dst, const float* __restrict__ src, long long n, int part, int parts) {
  if (n <= 0) return;
  const long long t = (long long)part * blockDim.x + threadIdx.x;
  const long long stride = (long long)parts * blockDim.x;
  if (((reinterpret_cast<uintptr_t>(dst) ^ reinterpret_cast<uintptr_t>(src)) & 15) != 0) {
    for (long long i = t; i < n; i += stride) dst[i] = src[i];
    return;
  }
  const long long head = min(n, (long long)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2));
  const long long n4 = (n - head) >> 2;
  for (long long i = t; i < n4; i += stride) {
    reinterpret_cast<float4*>(dst + head)[i] = reinterpret_cast<const float4*>(src + head)[i];
  }
  const long long rest = head + 4 * n4;
  if (t < head) dst[t] = src[t];
  if (t < n - rest) dst[rest + t] = src[rest + t];
}

// The single fold by tiles; see the note at the top. kLanes: blockIdx.y is the
// lane, and every array has a leading lane axis (the counts one value a
// lane).
template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
compactor_fold_tiles_kernel(const float* __restrict__ a, int na, const float* __restrict__ b, int nb,
                            const int* __restrict__ a_count, const int* __restrict__ b_count, int k,
                            float* __restrict__ items, int* __restrict__ count,
                            float* __restrict__ promoted, int* __restrict__ pcount) {
  __shared__ __align__(16) float s_out[kTile];
  if (kLanes) {
    const size_t lane = blockIdx.y;
    a += lane * na;
    b += lane * nb;
    a_count += lane;
    b_count += lane;
    items += lane * k;
    count += lane;
    promoted += lane * ((na + nb) / 2);
    pcount += lane;
  }
  const int ca = min(max(*a_count, 0), na);
  const int cb = min(max(*b_count, 0), nb);
  const int c = ca + cb;
  const bool overflow = c > k;
  const int pairs = c >> 1;
  const int leftover = c & 1;
  const int p_len = (na + nb) / 2;
  // the +inf fills, spread over the lane's blocks
  fill_inf(items, overflow ? leftover : c, k, blockIdx.x, gridDim.x);
  fill_inf(promoted, overflow ? pairs : 0, p_len, blockIdx.x, gridDim.x);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count = overflow ? leftover : c;
    *pcount = overflow ? pairs : 0;
  }
  const int p0 = blockIdx.x * kTile;  // this tile's merged positions [p0, p1)
  const int n_t = min(kTile, c - p0);
  if (n_t <= 0) return;
  const int p1 = p0 + n_t;
  if (cb == 0 && !overflow) {
    // nothing incoming and the level within k: the tile is a copy of a
    copy_share(items + p0, a + p0, n_t, 0, 1);
    return;
  }
  // each thread's run of kTilePerThread positions: its co-rank in device
  // memory (neighbouring threads' searches share their first steps, which
  // the L1 cache serves), then the run merged into the shared tile
  const int d = threadIdx.x * kTilePerThread;
  if (d < n_t) {
    int i = merge_path(a, ca, b, cb, p0 + d);
    int j = p0 + d - i;
    const int e = min(n_t, d + kTilePerThread);
    for (int p = d; p < e; ++p) {
      const bool take_a = i < ca && (j >= cb || !(b[j] < a[i]));
      s_out[p] = take_a ? a[i++] : b[j++];
    }
  }
  __syncthreads();
  if (!overflow) {
    float* dst = items + p0;
    int done = 0;
    if (aligned16(dst)) {
      const int n4 = n_t >> 2;
      for (int x = threadIdx.x; x < n4; x += blockDim.x) {
        reinterpret_cast<float4*>(dst)[x] = reinterpret_cast<const float4*>(s_out)[x];
      }
      done = n4 << 2;
    }
    for (int x = done + threadIdx.x; x < n_t; x += blockDim.x) dst[x] = s_out[x];
    return;
  }
  // promoted[j] = merged[2j + (j & 1)]: p0 is a multiple of 4, so the tile's
  // j from p0 / 2 on take its positions 2y + (y & 1)
  const int j_base = p0 >> 1;
  const int ny = min(kTile / 2, pairs - j_base);
  for (int y = threadIdx.x; y < ny; y += blockDim.x) promoted[j_base + y] = s_out[2 * y + (y & 1)];
  if (leftover && threadIdx.x == 0 && c - 1 < p1) items[0] = s_out[c - 1 - p0];
}

// The single fold a thread an output slot (see the note at the top):
// kLanes as in the tiled kernel.
template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
compactor_fold_slots_kernel(const float* __restrict__ a, int na, const float* __restrict__ b, int nb,
                            const int* __restrict__ a_count, const int* __restrict__ b_count, int k,
                            float* __restrict__ items, int* __restrict__ count,
                            float* __restrict__ promoted, int* __restrict__ pcount) {
  if (kLanes) {
    const size_t lane = blockIdx.y;
    a += lane * na;
    b += lane * nb;
    a_count += lane;
    b_count += lane;
    items += lane * k;
    count += lane;
    promoted += lane * ((na + nb) / 2);
    pcount += lane;
  }
  const int ca = min(max(*a_count, 0), na);
  const int cb = min(max(*b_count, 0), nb);
  const int c = ca + cb;
  const bool overflow = c > k;
  const int pairs = c >> 1;
  const int leftover = c & 1;
  const int p_len = (na + nb) / 2;
  const float inf = pos_inf();
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < k + p_len; s += gridDim.x * blockDim.x) {
    if (s < k) {
      float v = inf;
      if (!overflow) {
        if (s < c) v = merged_at(a, ca, b, cb, s);
      } else if (s == 0 && leftover) {
        v = merged_at(a, ca, b, cb, c - 1);
      }
      items[s] = v;
    } else {
      const int j = s - k;
      promoted[j] = overflow && j < pairs ? merged_at(a, ca, b, cb, 2 * j + (j & 1)) : inf;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *count = overflow ? leftover : c;
    *pcount = overflow ? pairs : 0;
  }
}

// The first design of the single fold: every output slot searches
// the whole merge for its value. Launched by compactor_fold_search_launch
// and compactor_fold_search_lanes_launch, which only chip_smoke.py calls, to
// time it beside the tiled kernel. kLanes as there.
template <bool kLanes>
__global__ void __launch_bounds__(kThreads)
compactor_fold_search_kernel(const float* __restrict__ a, int na, const float* __restrict__ b, int nb,
                             const int* __restrict__ a_count, const int* __restrict__ b_count, int k,
                             float* __restrict__ items, int* __restrict__ count,
                             float* __restrict__ promoted, int* __restrict__ pcount) {
  if (kLanes) {
    const size_t lane = blockIdx.y;
    a += lane * na;
    b += lane * nb;
    a_count += lane;
    b_count += lane;
    items += lane * k;
    count += lane;
    promoted += lane * ((na + nb) / 2);
    pcount += lane;
  }
  const int ca = *a_count;
  const int cb = *b_count;
  const int c = ca + cb;
  const bool overflow = c > k;
  const int pairs = c / 2;
  const int leftover = c - 2 * pairs;
  // nothing incoming and the level within k: it passes through unsearched
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

// ---------------------------------------------------------------------------
// the cascade: the walking kernel
// ---------------------------------------------------------------------------

// Issue cp.async copies of src[0, n) into shared dst[0, n) (no commit).
__device__ void stage_async(float* dst, const float* src, int n) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// This thread's share [lo, hi) of n positions.
__device__ __forceinline__ void my_share(int n, int& lo, int& hi) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  lo = min(n, (int)threadIdx.x * per);
  hi = min(n, lo + per);
}

// out[0, ca + cb) = merge(a[0, ca), b[0, cb)), by the block.
__device__ void merge_runs(const float* a, int ca, const float* b, int cb, float* out) {
  int lo, hi;
  my_share(ca + cb, lo, hi);
  if (lo >= hi) return;
  int i = merge_path(a, ca, b, cb, lo);
  int j = lo - i;
  for (int p = lo; p < hi; ++p) {
    const bool take_a = i < ca && (j >= cb || !(b[j] < a[i]));
    out[p] = take_a ? a[i++] : b[j++];
  }
}

// Fold the run b (cb valid) into the level a (ca valid) of size k, by the
// block. Writes the level's new items, +inf padded, to `row` (device
// memory) and the promoted run to `promoted`; returns the level's new count
// and sets `pcount`. The top level absorbs and saturates at k.
__device__ int fold_into(const float* a, int ca, const float* b, int cb, int k, bool top,
                         float* __restrict__ row, float* promoted, int& pcount) {
  const int c = ca + cb;
  const bool overflow = !top && c > k;
  const int pairs = c >> 1;
  const int kept = overflow ? (c & 1) : min(c, k);  // items that stay at the level
  const int n = overflow ? c : kept;                 // merged positions needed
  int lo, hi;
  my_share(n, lo, hi);
  if (lo < hi) {
    int i = merge_path(a, ca, b, cb, lo);
    int j = lo - i;
    for (int p = lo; p < hi; ++p) {
      const bool take_a = i < ca && (j >= cb || !(b[j] < a[i]));
      const float v = take_a ? a[i++] : b[j++];
      if (!overflow) {
        row[p] = v;
      } else if (p < 2 * pairs) {
        // one of each adjacent pair, alternating: merged[2j + (j & 1)]
        if ((p & 3) == 0 || (p & 3) == 3) promoted[p >> 1] = v;
      } else {
        row[0] = v;  // the odd leftover
      }
    }
  }
  fill_inf(row, kept, k, 0, 1);
  pcount = overflow ? pairs : 0;
  return kept;
}

__device__ __forceinline__ int clamp_count(int c, int hi) { return min(max(c, 0), hi); }

// One launch per sketch update (other == nullptr) or merge. Block 0 walks
// the levels from `start` up; blocks 1.. copy the levels below `start`.
// staged != 0: the buffers live in dynamic shared memory; otherwise in
// `scratch` (device memory) and the levels are read in place.
__global__ void __launch_bounds__(kCascadeThreads)
compactor_cascade_kernel(const float* __restrict__ items, const int* __restrict__ counts, int L, int k,
                         const float* __restrict__ inc, int m, const int* __restrict__ inc_count, int start,
                         const float* __restrict__ other, const int* __restrict__ other_counts,
                         float* __restrict__ out_items, int* __restrict__ out_counts,
                         float* __restrict__ scratch, long long scratch_stride, int staged, int kp, int cap) {
  const size_t row = (size_t)k;
  // blockIdx.y is the lane: each lane is a sketch of its own
  const size_t lane = blockIdx.y;
  items += lane * L * row;
  counts += lane * L;
  out_items += lane * L * row;
  out_counts += lane * L;
  if (inc != nullptr) {
    inc += lane * m;
    inc_count += lane;
  }
  if (other != nullptr) {
    other += lane * L * row;
    other_counts += lane * L;
  }
  if (scratch != nullptr) scratch += lane * scratch_stride;
  if (blockIdx.x > 0) {
    // the levels below the start level pass through, copied by these blocks
    copy_share(out_items, items, (long long)start * k, blockIdx.x - 1, gridDim.x - 1);
    return;
  }
  for (int l = threadIdx.x; l < start; l += blockDim.x) out_counts[l] = counts[l];
  if (start >= L) return;

  extern __shared__ __align__(16) float smem[];

  if (other == nullptr) {
    // ---- insert: fold inc into level `start`, the promoted run up --------
    // staged: [level x2 (kp each)][carry x2 (cap each)]; else [carry x2]
    float* lvl_now = smem;
    float* lvl_next = smem + kp;
    float* buf_a = staged ? smem + 2 * kp : scratch;
    float* buf_b = buf_a + cap;
    const float* c_in = inc;
    float* c_out = buf_a;
    int ci = clamp_count(*inc_count, m);
    if (staged) {
      stage_async(buf_b, inc, ci);
      stage_async(lvl_now, items + start * row, clamp_count(counts[start], k));
      __pipeline_commit();
      c_in = buf_b;
    }
    for (int l = start; l < L; ++l) {
      const int cl = clamp_count(counts[l], k);
      const bool top = l == L - 1;
      if (staged) {
        // fetch the next level while this one folds (unused if the carry
        // ends here)
        if (!top) stage_async(lvl_next, items + (l + 1) * row, clamp_count(counts[l + 1], k));
        __pipeline_commit();
        __pipeline_wait_prior(1);
      }
      __syncthreads();
      int pc;
      const int nc = fold_into(staged ? lvl_now : items + l * row, cl, c_in, ci, k, top, out_items + l * row, c_out, pc);
      if (threadIdx.x == 0) out_counts[l] = nc;
      __syncthreads();
      // the promoted run is the next level's input
      c_in = c_out;
      c_out = c_out == buf_a ? buf_b : buf_a;
      float* t = lvl_now;
      lvl_now = lvl_next;
      lvl_next = t;
      ci = pc;
      if (ci == 0 && !top) {
        // nothing promoted: the levels above pass through unchanged
        copy_share(out_items + (l + 1) * row, items + (l + 1) * row, (long long)(L - 1 - l) * k, 0, 1);
        for (int u = l + 1 + threadIdx.x; u < L; u += blockDim.x) out_counts[u] = counts[u];
        break;
      }
    }
    if (staged) __pipeline_wait_prior(0);
    return;
  }

  // ---- merge: at each level merge other[l] with the carry, then fold ------
  // staged: [level kp][other kp][input 3kp][carry 2kp]; else [input 3kp][carry 2kp]
  float* lvl_s = smem;
  float* oth_s = smem + kp;
  float* input = staged ? smem + 2 * kp : scratch;
  float* carry = input + 3 * kp;
  int cc = 0;
  if (staged) {
    stage_async(oth_s, other, clamp_count(other_counts[0], k));
    __pipeline_commit();
    stage_async(lvl_s, items, clamp_count(counts[0], k));
    __pipeline_commit();
  }
  for (int l = 0; l < L; ++l) {
    const int cl = clamp_count(counts[l], k);
    const int co = clamp_count(other_counts[l], k);
    const bool top = l == L - 1;
    if (staged) __pipeline_wait_prior(1);  // other[l] has landed; level l may be in flight
    __syncthreads();
    merge_runs(staged ? oth_s : other + l * row, co, carry, cc, input);
    __syncthreads();
    if (staged) {
      if (!top) {
        stage_async(oth_s, other + (l + 1) * row, clamp_count(other_counts[l + 1], k));
        __pipeline_commit();
        __pipeline_wait_prior(1);  // level l has landed
      } else {
        __pipeline_wait_prior(0);
      }
      __syncthreads();
    }
    int pc;
    const int nc = fold_into(staged ? lvl_s : items + l * row, cl, input, co + cc, k, top, out_items + l * row, carry, pc);
    if (threadIdx.x == 0) out_counts[l] = nc;
    __syncthreads();
    cc = pc;
    if (staged && !top) {
      stage_async(lvl_s, items + (l + 1) * row, clamp_count(counts[l + 1], k));
      __pipeline_commit();
    }
  }
}

// ---------------------------------------------------------------------------
// the cascade's lane form: a lane's levels split by value over its blocks
// ---------------------------------------------------------------------------

// The least j whose promoted position 2j + (j & 1) is at or past x.
__device__ __forceinline__ int first_promoted(int x) {
  const int j = x >> 1;
  return 2 * j + (j & 1) < x ? j + 1 : j;
}

// Promoted values from the merged positions [off, off + n) of a fold of c
// values into a level of k (none where it absorbs).
__device__ __forceinline__ int promoted_in(int off, int n, int c, int k, bool top) {
  if (top || c <= k) return 0;
  const int end = min(off + n, 2 * (c >> 1));
  return end > off ? first_promoted(end) - first_promoted(off) : 0;
}

// The first index of the ascending x[0, n) whose value is at or past v.
__device__ __forceinline__ int lower_bound(const float* x, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (x[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A lane's blocks split every level by value: block q takes the values v
// with split[q] <= v < split[q + 1] (the last block every v from
// split[q]). Every value of a block is at most every value of the next, so
// the lane's merge is its blocks' merges one after another (equal values are
// equal bits, so where their ties fall cannot change an output). Every
// block's slice of the ascending x[0, n): [s_b[q], s_b[q + 1]), the parts - 1
// inner bounds searched at once by the first thread of warps w0, w0 + 1, ...
// (the caller's barrier publishes them).
__device__ __forceinline__ void slice_bounds(const float* x, int n, const float* split, int parts, int* s_b, int w0) {
  const int q = (int)(threadIdx.x >> 5) - w0 + 1;
  if ((threadIdx.x & 31) == 0 && q >= 1 && q < parts) s_b[q] = lower_bound(x, n, split[q]);
  if (threadIdx.x == 0) {
    s_b[0] = 0;
    s_b[parts] = n;
  }
}

// Merge a[0, na) with b[0, nb) (ties a first) by the block, each thread a
// run of at least kMinRun positions found by one co-rank search; every value
// goes to place(position, value).
template <typename Place>
__device__ void merge_block(const float* a, int na, const float* b, int nb, Place place) {
  const int n = na + nb;
  const int per = max(kMinRun, (n + (int)blockDim.x - 1) / (int)blockDim.x);
  const int lo = min(n, (int)threadIdx.x * per);
  const int hi = min(n, lo + per);
  if (lo >= hi) return;
  int i = merge_path(a, na, b, nb, lo);
  int j = lo - i;
  for (int p = lo; p < hi; ++p) {
    const bool take_a = i < na && (j >= nb || !(b[j] < a[i]));
    place(p, take_a ? a[i++] : b[j++]);
  }
}

// Fold this block's slice of a level (a[0, na)) with its slice of the
// incoming run (b[0, nb)), at merged positions [off, off + na + nb) of the
// lane's c: the level's new items go to their positions of `row` (device
// memory), this block's promoted values in order into `carry` (its slice of
// the next level's run), the odd leftover into row[0]; the top level
// absorbs and saturates at k. The +inf fill of the row is split over the
// lane's blocks.
__device__ void fold_slice(const float* a, int na, const float* b, int nb, int off, int c, int k, bool top,
                           float* __restrict__ row, float* carry, int part, int parts) {
  const bool overflow = !top && c > k;
  const int pairs = c >> 1;
  const int kept = overflow ? (c & 1) : min(c, k);  // items that stay at the level
  const int j0 = first_promoted(off);
  merge_block(a, na, b, nb, [&](int q, float v) {
    const int p = off + q;
    if (!overflow) {
      if (p < kept) row[p] = v;
    } else if (p < 2 * pairs) {
      // one of each adjacent pair, alternating: merged[2j + (j & 1)]
      if ((p & 3) == 0 || (p & 3) == 3) carry[(p >> 1) - j0] = v;
    } else {
      row[0] = v;  // the odd leftover
    }
  });
  fill_inf(row, kept, k, part, parts);
}

// The value-split lane cascade: gridDim.x blocks a lane (blockIdx.y), block
// blockIdx.x its slice by value (slice_bounds), with splitters taken once
// from the incoming run (an insert) or from the sketch's fullest level (a
// merge). A block's promoted values fall in its own value range, so its
// slice of the carry never leaves its shared memory; and every block finds
// every block's slice of a level (parts - 1 searches at once), so each one
// knows every block's merged count, and with them its offset among the
// lane's merged positions, on its own: the blocks never wait for each other.
// Every buffer in each block's dynamic shared memory: an insert [level x2
// (kp each)][carry x2 (cap each)][counts L]; a merge [level x2 (kp
// each)][other kp][input 3kp][carry 2kp][counts L][other counts L].
__global__ void __launch_bounds__(kSplitThreads)
compactor_cascade_split_kernel(const float* __restrict__ items, const int* __restrict__ counts, int L, int k,
                               const float* __restrict__ inc, int m, const int* __restrict__ inc_count, int start,
                               const float* __restrict__ other, const int* __restrict__ other_counts,
                               float* __restrict__ out_items, int* __restrict__ out_counts, int kp, int cap) {
  __shared__ float s_split[kMaxParts + 1];
  __shared__ int s_lb[kMaxParts + 1];  // every block's slice of the level
  __shared__ int s_ob[kMaxParts + 1];  // every block's slice of the other sketch's level (a merge)
  const int parts = (int)gridDim.x;
  const int part = (int)blockIdx.x;
  const size_t row = (size_t)k;
  const size_t lane = blockIdx.y;
  items += lane * L * row;
  counts += lane * L;
  out_items += lane * L * row;
  out_counts += lane * L;
  if (inc != nullptr) {
    inc += lane * m;
    inc_count += lane;
  }
  if (other != nullptr) {
    other += lane * L * row;
    other_counts += lane * L;
  }
  extern __shared__ __align__(16) float smem[];
  const float inf = pos_inf();
  auto level_buf = [&](int l) { return smem + (l & 1) * kp; };
  int cs[kMaxParts];  // every block's slice of the carry: its count (the same in every thread)

  if (other == nullptr) {
    // ---- insert: fold inc into level `start`, the promoted run up --------
    float* c_in = smem + 2 * kp;
    float* c_out = c_in + cap;
    int* s_counts = reinterpret_cast<int*>(c_out + cap);
    int ci = clamp_count(*inc_count, m);
    if (start < L) {
      stage_async(c_in, inc, ci);
      stage_async(level_buf(start), items + start * row, clamp_count(counts[start], k));
    }
    __pipeline_commit();
    for (int l = threadIdx.x; l < L; l += blockDim.x) s_counts[l] = clamp_count(counts[l], k);
    // the levels below the start level pass through, while the first lands
    copy_share(out_items, items, (long long)start * k, part, parts);
    if (part == 0) {
      for (int l = threadIdx.x; l < start; l += blockDim.x) out_counts[l] = counts[l];
    }
    if (start >= L) {
      __pipeline_wait_prior(0);
      return;
    }
    __pipeline_wait_prior(0);
    __syncthreads();  // the run and level `start` have landed
    // the splitters: the run's values at its even fractions. Block q takes
    // the run's values [ci q / parts, ci (q + 1) / parts), all of them
    // between split[q] and split[q + 1], those equal to split[q + 1]
    // included: the order between blocks holds all the same.
    if ((int)threadIdx.x <= parts) {
      const int q = threadIdx.x;
      s_split[q] = q == 0 ? -inf : (q == parts || ci == 0 ? inf : c_in[(long long)ci * q / parts]);
    }
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q) cs[q] = q < parts ? (int)((long long)ci * (q + 1) / parts - (long long)ci * q / parts) : 0;
    const float* slice = c_in + (int)((long long)ci * part / parts);  // this block's slice of the run
    int cr = (int)((long long)ci * (part + 1) / parts - (long long)ci * part / parts);
    for (int l = start; l < L; ++l) {
      const bool top = l == L - 1;
      if (l > start) __pipeline_wait_prior(0);
      __syncthreads();  // level l has landed (and the splitters are set); the block is done with level l - 1
      // fetch the next level into level l - 1's buffer while this one folds
      // (unused if the carry ends here)
      if (!top) {
        stage_async(level_buf(l + 1), items + (l + 1) * row, s_counts[l + 1]);
        __pipeline_commit();
      }
      const float* lv = level_buf(l);
      slice_bounds(lv, s_counts[l], s_split, parts, s_lb, 0);
      __syncthreads();
      int off = 0, c = 0;
#pragma unroll
      for (int q = 0; q < kMaxParts; ++q) {
        const int n = q < parts ? s_lb[q + 1] - s_lb[q] + cs[q] : 0;
        off += q < part ? n : 0;
        c += n;
      }
      fold_slice(lv + s_lb[part], s_lb[part + 1] - s_lb[part], slice, cr, off, c, k, top, out_items + l * row, c_out,
                 part, parts);
      const bool overflow = !top && c > k;
      if (part == 0 && threadIdx.x == 0) out_counts[l] = overflow ? (c & 1) : min(c, k);
      int at = 0;
#pragma unroll
      for (int q = 0; q < kMaxParts; ++q) {
        const int n = q < parts ? s_lb[q + 1] - s_lb[q] + cs[q] : 0;
        cs[q] = promoted_in(at, n, c, k, top);
        cr = q == part ? cs[q] : cr;
        at += n;
      }
      slice = c_out;
      c_out = c_in;
      c_in = const_cast<float*>(slice);
      ci = overflow ? c >> 1 : 0;
      if (ci == 0 && !top) {
        // nothing promoted: the levels above pass through
        copy_share(out_items + (l + 1) * row, items + (l + 1) * row, (long long)(L - 1 - l) * k, part, parts);
        if (part == 0) {
          for (int u = l + 1 + threadIdx.x; u < L; u += blockDim.x) out_counts[u] = counts[u];
        }
        break;
      }
    }
    __pipeline_wait_prior(0);
    return;
  }

  // ---- merge: at each level merge other[l] with the carry, then fold ------
  float* oth_s = smem + 2 * kp;
  float* input = smem + 3 * kp;
  float* carry = input + 3 * kp;
  int* s_counts = reinterpret_cast<int*>(carry + 2 * kp);
  int* s_other = s_counts + L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    s_counts[l] = clamp_count(counts[l], k);
    s_other[l] = clamp_count(other_counts[l], k);
  }
  stage_async(oth_s, other, clamp_count(other_counts[0], k));
  stage_async(level_buf(0), items, clamp_count(counts[0], k));
  __pipeline_commit();
  __syncthreads();
  // the splitters: the fullest level's values at their even fractions
  if ((int)threadIdx.x <= parts) {
    int full = 0;
    for (int l = 1; l < L; ++l) full = s_counts[l] > s_counts[full] ? l : full;
    const int q = threadIdx.x;
    const int n = s_counts[full];
    s_split[q] = q == 0 ? -inf : (q == parts || n == 0 ? inf : items[full * row + (long long)n * q / parts]);
  }
#pragma unroll
  for (int q = 0; q < kMaxParts; ++q) cs[q] = 0;
  int cr = 0;  // this block's slice of the carry
  for (int l = 0; l < L; ++l) {
    const bool top = l == L - 1;
    __pipeline_wait_prior(0);
    __syncthreads();  // other[l] and level l have landed; the block is done with level l - 1
    if (!top) {
      // the next level into level l - 1's buffer while this one folds
      stage_async(level_buf(l + 1), items + (l + 1) * row, s_counts[l + 1]);
      __pipeline_commit();
    }
    const float* lv = level_buf(l);
    slice_bounds(lv, s_counts[l], s_split, parts, s_lb, 0);
    slice_bounds(oth_s, s_other[l], s_split, parts, s_ob, kMaxParts);
    __syncthreads();
    int off = 0, c = 0;
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q) {
      const int n = q < parts ? s_lb[q + 1] - s_lb[q] + s_ob[q + 1] - s_ob[q] + cs[q] : 0;
      off += q < part ? n : 0;
      c += n;
    }
    const int n_o = s_ob[part + 1] - s_ob[part];
    merge_block(oth_s + s_ob[part], n_o, carry, cr, [&](int q, float v) { input[q] = v; });
    __syncthreads();  // the input is whole; the carry and other[l] are free
    if (!top) {
      stage_async(oth_s, other + (l + 1) * row, s_other[l + 1]);
      __pipeline_commit();
    }
    fold_slice(lv + s_lb[part], s_lb[part + 1] - s_lb[part], input, n_o + cr, off, c, k, top, out_items + l * row,
               carry, part, parts);
    if (part == 0 && threadIdx.x == 0) out_counts[l] = !top && c > k ? (c & 1) : min(c, k);
    int at = 0;
#pragma unroll
    for (int q = 0; q < kMaxParts; ++q) {
      const int n = q < parts ? s_lb[q + 1] - s_lb[q] + s_ob[q + 1] - s_ob[q] + cs[q] : 0;
      cs[q] = promoted_in(at, n, c, k, top);
      cr = q == part ? cs[q] : cr;
      at += n;
    }
  }
  __pipeline_wait_prior(0);
}

// The shared memory one block may opt into (227 KB on an H100), less the
// kernel's static shared memory; the kernel opted into it once per process.
// 0 if the card's limits cannot be read.
template <typename Kernel>
int opt_in_shared_bytes(Kernel kernel) {
  int dev = 0, got = 0;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&got, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, got - (int)attr.sharedSizeBytes) !=
          cudaSuccess) {
    cudaGetLastError();  // not left behind for the launch's own check
    return 0;
  }
  return got - (int)attr.sharedSizeBytes;
}

int max_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    const int got = opt_in_shared_bytes(compactor_cascade_kernel);
    if (got == 0) return 0;
    bytes = got;
  }
  return bytes;
}

int split_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    const int got = opt_in_shared_bytes(compactor_cascade_split_kernel);
    if (got == 0) return 0;
    bytes = got;
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

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// floats of the buffers: in shared memory (staged) or in the scratch
long long cascade_floats(int k, int m, int merge, int staged) {
  const long long kp = round4(k);
  const long long cap = round4(m > k ? m : k);
  if (merge) return staged ? 7 * kp : 5 * kp;
  return staged ? 2 * kp + 2 * cap : 2 * cap;
}

// the value-split kernel's shared memory: the staged buffers and the counts
long long split_bytes(int L, int k, int m, int merge) {
  const long long kp = round4(k);
  const long long cap = round4(m > k ? m : k);
  if (merge) return 4 * (8 * kp + 2LL * L);
  return 4 * (2 * kp + 2 * cap + L);
}

// The lane form's plan, from the shapes: the value-split kernel's blocks a
// lane (kMinParts to 8: the SMs over the lanes), or 0 for the walking
// kernel, where the buffers do not fit a block's shared memory or the lanes
// leave fewer than kMinParts blocks a lane; -1 if the card's limits cannot
// be read.
int lanes_parts(int lanes, int L, int k, int m, int merge) {
  const int limit = split_shared_bytes();
  const int sms = sm_count();
  if (limit <= 0 || sms <= 0) return -1;
  if (split_bytes(L, k, m, merge) > limit) return 0;
  const int parts = sms / lanes;
  if (parts < kMinParts) return 0;
  return parts < kMaxParts ? parts : kMaxParts;
}

// The single fold's plan, from the shapes: a thread an output slot (1)
// where the lanes' slot blocks fit on the card at once, else the tiles (0;
// also where the card's limits cannot be read). See the note at the top.
int fold_slots(int lanes, int na, int nb, int k) {
  static int wave = -1;  // slot blocks resident on the card at once
  if (wave < 0) {
    int per_sm = 0;
    const int sms = sm_count();
    if (sms <= 0 ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, compactor_fold_slots_kernel<true>, kThreads, 0) != cudaSuccess) {
      cudaGetLastError();
      return 0;
    }
    wave = sms * per_sm;
  }
  const long long blocks = ((long long)k + (na + (long long)nb) / 2 + kThreads - 1) / kThreads;
  return (long long)lanes * blocks <= wave ? 1 : 0;
}

template <bool kLanes>
int fold(const float* a, int na, const float* b, int nb, const int* a_count, const int* b_count, int k, float* items,
         int* count, float* promoted, int* pcount, int lanes, cudaStream_t stream) {
  if (fold_slots(lanes, na, nb, k)) {
    const long long slots = (long long)k + (na + (long long)nb) / 2;
    const long long blocks = (slots + kThreads - 1) / kThreads;
    compactor_fold_slots_kernel<kLanes><<<dim3(blocks > 0 ? (unsigned)blocks : 1, lanes), kThreads, 0, stream>>>(
        a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount);
  } else {
    const long long tiles = ((long long)na + nb + kTile - 1) / kTile;
    compactor_fold_tiles_kernel<kLanes><<<dim3(tiles > 0 ? (unsigned)tiles : 1, lanes), kThreads, 0, stream>>>(
        a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` and returns the
// cudaError_t of the launch (0 on success); none synchronises.
extern "C" int compactor_fold_launch(const float* a, int na, const float* b, int nb,
                                     const int* a_count, const int* b_count, int k,
                                     float* items, int* count, float* promoted, int* pcount,
                                     void* stream) {
  return fold<false>(a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount, 1, (cudaStream_t)stream);
}

// The lane-batched single fold: `lanes` folds in one launch, the lane on the
// grid's second axis (at most 65,535 lanes; the wrapper splits). a (lanes,
// na), b (lanes, nb), a_count and b_count (lanes,) in; items (lanes, k),
// count (lanes,), promoted (lanes, (na + nb) / 2), pcount (lanes,) out.
extern "C" int compactor_fold_lanes_launch(const float* a, int na, const float* b, int nb,
                                           const int* a_count, const int* b_count, int k,
                                           float* items, int* count, float* promoted, int* pcount,
                                           int lanes, void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  return fold<true>(a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount, lanes, (cudaStream_t)stream);
}

// The single fold's plan at this shape (lanes 1 for compactor_fold_launch):
// 1 for a thread an output slot, 0 for the tiles.
extern "C" int compactor_fold_lanes_plan(int lanes, int na, int nb, int k) {
  return lanes > 0 ? fold_slots(lanes, na, nb, k) : 0;
}

// The single fold's first design, for timing beside the tiled kernel:
// arguments as compactor_fold_launch and compactor_fold_lanes_launch.
extern "C" int compactor_fold_search_launch(const float* a, int na, const float* b, int nb,
                                            const int* a_count, const int* b_count, int k,
                                            float* items, int* count, float* promoted, int* pcount,
                                            void* stream) {
  const long long n_out = (long long)k + (na + (long long)nb) / 2;
  const int blocks = (int)((n_out + kThreads - 1) / kThreads);
  compactor_fold_search_kernel<false><<<blocks > 0 ? blocks : 1, kThreads, 0, (cudaStream_t)stream>>>(
      a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount);
  return (int)cudaGetLastError();
}

extern "C" int compactor_fold_search_lanes_launch(const float* a, int na, const float* b, int nb,
                                                  const int* a_count, const int* b_count, int k,
                                                  float* items, int* count, float* promoted, int* pcount,
                                                  int lanes, void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  if (lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  const long long n_out = (long long)k + (na + (long long)nb) / 2;
  const int blocks = (int)((n_out + kThreads - 1) / kThreads);
  compactor_fold_search_kernel<true><<<dim3(blocks > 0 ? blocks : 1, lanes), kThreads, 0, (cudaStream_t)stream>>>(
      a, na, b, nb, a_count, b_count, k, items, count, promoted, pcount);
  return (int)cudaGetLastError();
}

// Floats of device-memory scratch a cascade of this shape needs: 0 when its
// buffers fit in one block's shared memory.
extern "C" long long compactor_cascade_scratch_floats(int k, int m, int merge) {
  const long long bytes = cascade_floats(k, m, merge, 1) * 4;
  return bytes <= max_shared_bytes() ? 0 : cascade_floats(k, m, merge, 0);
}

namespace {

int cascade(const float* items, const int* counts, int L, int k, const float* inc, int m, const int* inc_count,
            int start, const float* other, const int* other_counts, float* out_items, int* out_counts,
            float* scratch, int lanes, cudaStream_t stream) {
  if (L <= 0 || k <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  const int merge = other != nullptr;
  if (merge) start = 0;
  if (start > L) start = L;
  const long long bytes = cascade_floats(k, m, merge, 1) * 4;
  const int staged = bytes <= max_shared_bytes();
  if (!staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = staged ? (int)bytes : 0;
  const long long below = (long long)start * k;
  int copy_blocks = (int)((below + 4LL * kCascadeThreads * 8 - 1) / (4LL * kCascadeThreads * 8));
  if (copy_blocks > kCopyBlocks) copy_blocks = kCopyBlocks;
  const int kp = (int)round4(k);
  const int cap = (int)round4(m > k ? m : k);
  compactor_cascade_kernel<<<dim3(1 + copy_blocks, lanes), kCascadeThreads, smem, stream>>>(
      items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, scratch,
      staged ? 0 : cascade_floats(k, m, merge, 0), staged, kp, cap);
  return (int)cudaGetLastError();
}

// The value-split kernel at `parts` blocks a lane; refused (an error
// returned, nothing launched) where its buffers do not fit a block's shared
// memory.
int split_cascade(const float* items, const int* counts, int L, int k, const float* inc, int m, const int* inc_count,
                  int start, const float* other, const int* other_counts, float* out_items, int* out_counts, int lanes,
                  int parts, cudaStream_t stream) {
  if (L <= 0 || k <= 0 || lanes <= 0) return (int)cudaSuccess;
  if (lanes > 65535 || parts < kMinParts || parts > kMaxParts) return (int)cudaErrorInvalidConfiguration;
  const int merge = other != nullptr;
  if (merge) start = 0;
  if (start > L) start = L;
  const int limit = split_shared_bytes();
  if (limit <= 0) return (int)cudaErrorInvalidDevice;
  const long long bytes = split_bytes(L, k, m, merge);
  if (bytes > limit) return (int)cudaErrorInvalidValue;
  compactor_cascade_split_kernel<<<dim3((unsigned)parts, (unsigned)lanes), kSplitThreads, (size_t)bytes, stream>>>(
      items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, (int)round4(k),
      (int)round4(m > k ? m : k));
  return (int)cudaGetLastError();
}

}  // namespace

// One cascade: an insert of inc (m floats, *inc_count valid) at level
// `start` when other is null, else a merge with (other, other_counts) (inc
// unused). items/out_items are (L, k), counts/out_counts (L,); the outputs
// must not overlap the inputs. scratch holds
// compactor_cascade_scratch_floats(k, m, merge) floats (may be null if 0).
// The walking kernel, one block.
extern "C" int compactor_cascade_launch(const float* items, const int* counts, int L, int k,
                                        const float* inc, int m, const int* inc_count, int start,
                                        const float* other, const int* other_counts,
                                        float* out_items, int* out_counts, float* scratch, void* stream) {
  return cascade(items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, scratch,
                 1, (cudaStream_t)stream);
}

// The lane form's plan at this shape: the value-split kernel's blocks a lane, 0
// for the walking kernel, -1 if the card's limits cannot be read.
extern "C" int compactor_cascade_lanes_parts(int lanes, int L, int k, int m, int merge) {
  if (lanes <= 0) return 0;
  return lanes_parts(lanes, L, k, m, merge);
}

// The lane-batched form: `lanes` sketches in one launch (at most 65,535
// lanes; the wrapper splits), by the plan (compactor_cascade_lanes_parts):
// the value-split kernel's blocks a lane, or one walking block a lane. Every array
// gains a leading lane axis: items/other/out_items (lanes, L, k), counts/
// other_counts/out_counts (lanes, L), inc (lanes, m), inc_count (lanes,);
// start is shared. scratch holds lanes * compactor_cascade_scratch_floats(k,
// m, merge) floats (may be null if that is 0).
extern "C" int compactor_cascade_lanes_launch(const float* items, const int* counts, int L, int k,
                                              const float* inc, int m, const int* inc_count, int start,
                                              const float* other, const int* other_counts,
                                              float* out_items, int* out_counts, float* scratch, int lanes,
                                              void* stream) {
  if (L <= 0 || k <= 0 || lanes <= 0) return (int)cudaSuccess;
  const int parts = lanes_parts(lanes, L, k, m, other != nullptr);
  if (parts < 0) return (int)cudaErrorInvalidDevice;
  if (parts == 0) {
    return cascade(items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, scratch,
                   lanes, (cudaStream_t)stream);
  }
  return split_cascade(items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, lanes,
                       parts, (cudaStream_t)stream);
}

// The lane form's walking kernel at any shape (its first design):
// arguments as compactor_cascade_lanes_launch. The form's path where the
// plan says so, and elsewhere the design chip_smoke.py times beside the
// value-split kernel.
extern "C" int compactor_cascade_lanes_walk_launch(const float* items, const int* counts, int L, int k,
                                                   const float* inc, int m, const int* inc_count, int start,
                                                   const float* other, const int* other_counts,
                                                   float* out_items, int* out_counts, float* scratch, int lanes,
                                                   void* stream) {
  return cascade(items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, scratch,
                 lanes, (cudaStream_t)stream);
}

// The lane form's value-split kernel at `parts` blocks a lane (kMinParts to
// kMaxParts, the sizes the plan gives), for timing and parity at any side
// of the plan: arguments as
// compactor_cascade_lanes_launch without the scratch.
extern "C" int compactor_cascade_lanes_split_launch(const float* items, const int* counts, int L, int k,
                                                    const float* inc, int m, const int* inc_count, int start,
                                                    const float* other, const int* other_counts,
                                                    float* out_items, int* out_counts, int lanes, int parts,
                                                    void* stream) {
  return split_cascade(items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, lanes,
                       parts, (cudaStream_t)stream);
}
