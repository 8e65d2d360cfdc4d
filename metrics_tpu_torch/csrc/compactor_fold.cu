// Kernel K3 for Hopper (sm_90a): KLL compactor folds, one level
// (compactor_fold_kernel) and a whole level cascade in one launch
// (compactor_cascade_kernel).
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
// Both runs are sorted, so the sort is a merge: each output slot finds its
// merged element by a merge-path co-rank binary search, ties taken from a
// first. Equal values are equal bits (the sketch's items hold no NaN, no -0.0
// and no denormal: the precompaction canonicalises them), so the tie order
// cannot change an output. compactor_fold_kernel is that fold alone, one
// launch per fold over as many blocks as its k + p_len output slots need.
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
//
// Bound: bytes, and in practice latency. An insert at the stream's shape
// (L = 20, k = 6600) must read and write the (L, k) levels once: about 1 MB;
// a merge reads two sketches and writes one, 1.6 MB. The work per byte is a
// few compares. One block walks the levels that change, so a cascade is a
// chain of short dependent steps on one SM; what it saves is the launches.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCascadeThreads = 1024;
constexpr int kCopyBlocks = 16;  // blocks that copy the levels below the start level

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
// the cascade
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// dst[0, n) = src[0, n), device memory to device memory, by the block
__device__ void copy_floats(float* __restrict__ dst, const float* __restrict__ src, int n) {
  int done = 0;
  if (aligned16(dst) && aligned16(src)) {
    const int n4 = n >> 2;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
    }
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

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
  const float inf = pos_inf();
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
  for (int t = kept + threadIdx.x; t < k; t += blockDim.x) row[t] = inf;
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
                         float* __restrict__ scratch, int staged, int kp, int cap) {
  const size_t row = (size_t)k;
  if (blockIdx.x > 0) {
    // the levels below the start level pass through: a grid-stride copy
    const size_t n = (size_t)start * row;
    const size_t stride = (size_t)(gridDim.x - 1) * blockDim.x;
    const size_t first = (size_t)(blockIdx.x - 1) * blockDim.x + threadIdx.x;
    if (aligned16(items) && aligned16(out_items) && (n & 3) == 0) {
      for (size_t i = first; i < (n >> 2); i += stride) {
        reinterpret_cast<float4*>(out_items)[i] = reinterpret_cast<const float4*>(items)[i];
      }
    } else {
      for (size_t i = first; i < n; i += stride) out_items[i] = items[i];
    }
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
        copy_floats(out_items + (l + 1) * row, items + (l + 1) * row, (L - 1 - l) * k);
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
        cudaFuncGetAttributes(&attr, compactor_cascade_kernel) != cudaSuccess ||
        cudaFuncSetAttribute(compactor_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             got - (int)attr.sharedSizeBytes) != cudaSuccess) {
      cudaGetLastError();  // not left behind for the launch's own check
      return 0;
    }
    bytes = got - (int)attr.sharedSizeBytes;
  }
  return bytes;
}

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// floats of the buffers: in shared memory (staged) or in the scratch
long long cascade_floats(int k, int m, int merge, int staged) {
  const long long kp = round4(k);
  const long long cap = round4(m > k ? m : k);
  if (merge) return staged ? 7 * kp : 5 * kp;
  return staged ? 2 * kp + 2 * cap : 2 * cap;
}

}  // namespace

// Plain C entry points for ctypes. Each launches on `stream` and returns the
// cudaError_t of the launch (0 on success); none synchronises.
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

// Floats of device-memory scratch a cascade of this shape needs: 0 when its
// buffers fit in one block's shared memory.
extern "C" long long compactor_cascade_scratch_floats(int k, int m, int merge) {
  const long long bytes = cascade_floats(k, m, merge, 1) * 4;
  return bytes <= max_shared_bytes() ? 0 : cascade_floats(k, m, merge, 0);
}

// One cascade: an insert of inc (m floats, *inc_count valid) at level
// `start` when other is null, else a merge with (other, other_counts) (inc
// unused). items/out_items are (L, k), counts/out_counts (L,); the outputs
// must not overlap the inputs. scratch holds
// compactor_cascade_scratch_floats(k, m, merge) floats (may be null if 0).
extern "C" int compactor_cascade_launch(const float* items, const int* counts, int L, int k,
                                        const float* inc, int m, const int* inc_count, int start,
                                        const float* other, const int* other_counts,
                                        float* out_items, int* out_counts, float* scratch, void* stream) {
  if (L <= 0 || k <= 0) return (int)cudaSuccess;
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
  compactor_cascade_kernel<<<1 + copy_blocks, kCascadeThreads, smem, (cudaStream_t)stream>>>(
      items, counts, L, k, inc, m, inc_count, start, other, other_counts, out_items, out_counts, scratch, staged,
      kp, cap);
  return (int)cudaGetLastError();
}
