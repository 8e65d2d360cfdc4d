// Binned TP/FP/FN counters per (class, threshold) for Hopper (sm_90a).
//
// Replaces the TPU kernel metrics_tpu/ops/binned_counters.py::_counter_kernel.
// For preds p (N, C) float32, a 0/1 target y (N, C) uint8 and thresholds
// thr (T,) float32 it adds into an int32 (3, C, T) buffer that the caller
// zeroed:
//   tps[c, t] += sum_n y * ge,  fps[c, t] += sum_n (1 - y) * ge,
//   fns[c, t] += sum_n y * (1 - ge),  with ge = (p >= thr[t]).
// fn is counted from (1 - ge), never as y * (p < thr): a NaN score clears no
// threshold and so counts as a false negative at every one, as in both JAX
// forms. The thresholds may be in any order and need not be evenly spaced.
//
// What bounds it on an H100: it reads N*C*(4 + 1) bytes of scores and labels
// and writes 3*C*T*4 bytes of counts; at N = 1024, C = 1000, T = 100 that is
// about 6.3 MB, some 2 us at 3.35 TB/s. It does N*C*T compares, 1e8 at that
// shape, some 1.5 us at the float32 rate. This first design issues a compare
// and three integer adds for every (row, class, threshold), so it is bound by
// issued instructions, not by either of those.
//
// Design: the grid is (row chunk, class tile, threshold tile). A block
// stages kRows rows of its class tile's scores and labels in shared memory.
// Each thread owns one class of the tile and up to kCells of its
// thresholds, which it keeps in registers with exact integer counts; one
// shared-memory read of a (row, class) pair then serves kCells compares.
// At the end every nonzero count goes to device memory with one integer
// atomicAdd. Integer counts are exact and do not depend on the order in
// which blocks run; converted to float32 they equal the JAX package's
// float32 sums of 0/1 values while a call has fewer than 2^24 rows.
//
// The later redesign: sort the thresholds once, find each score's bin by
// binary search (log T compares instead of T), build a per-class histogram
// of bins and take its suffix sum; then stage tiles with cp.async or TMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 16;       // thresholds per thread, in registers
constexpr int kRows = 128;       // rows staged per block
constexpr int kMaxClasses = 64;  // classes per block: 40 KB of shared memory

__global__ void __launch_bounds__(kThreads)
binned_counters_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                       const float* __restrict__ thresholds, int* __restrict__ out,
                       int n, int c, int t, int tpc, int ct, int tt) {
  __shared__ float s_pred[kRows * kMaxClasses];
  __shared__ uint8_t s_tgt[kRows * kMaxClasses];

  const int row0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * ct;
  const int t0 = blockIdx.z * tt;
  const int rows = min(kRows, n - row0);
  const int classes = min(ct, c - c0);

  for (int i = threadIdx.x; i < rows * classes; i += kThreads) {
    const int r = i / classes;
    const int j = i - r * classes;
    const size_t g = (size_t)(row0 + r) * c + c0 + j;
    s_pred[r * kMaxClasses + j] = preds[g];
    s_tgt[r * kMaxClasses + j] = target[g] != 0;
  }
  __syncthreads();

  const int cl = threadIdx.x / tpc;    // the thread's class within the tile
  const int lane = threadIdx.x - cl * tpc;
  if (cl >= classes) return;

  // cell k holds threshold t0 + lane + k*tpc; cells past the tile hold NaN,
  // compare false, and are never written
  float thr[kCells];
  int tp[kCells], fp[kCells], fn[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int tl = lane + k * tpc;
    thr[k] = (tl < tt && t0 + tl < t) ? thresholds[t0 + tl] : __int_as_float(0x7fc00000);
    tp[k] = 0;
    fp[k] = 0;
    fn[k] = 0;
  }

  for (int r = 0; r < rows; ++r) {
    const float p = s_pred[r * kMaxClasses + cl];
    const int y = s_tgt[r * kMaxClasses + cl];
#pragma unroll
    for (int k = 0; k < kCells; ++k) {
      const int ge = p >= thr[k];
      tp[k] += y & ge;
      fp[k] += (y ^ 1) & ge;
      fn[k] += y & (ge ^ 1);
    }
  }

  const size_t plane = (size_t)c * t;
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int tl = lane + k * tpc;
    if (tl < tt && t0 + tl < t) {
      const size_t o = (size_t)(c0 + cl) * t + t0 + tl;
      if (tp[k]) atomicAdd(out + o, tp[k]);
      if (fp[k]) atomicAdd(out + plane + o, fp[k]);
      if (fn[k]) atomicAdd(out + 2 * plane + o, fn[k]);
    }
  }
}

}  // namespace

// Launches on `stream` and returns the launch's cudaError_t (0 on success).
// out must hold 3*c*t zeroed int32 values.
extern "C" int binned_counters_launch(const float* preds, const uint8_t* target, const float* thresholds,
                                      int* out, int n, int c, int t, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return (int)cudaSuccess;
  const int tt = t < kCells * kThreads ? t : kCells * kThreads;  // thresholds per block
  const int tpc = (tt + kCells - 1) / kCells;                       // threads per class
  int ct = kThreads / tpc;                                          // classes per block
  if (ct > kMaxClasses) ct = kMaxClasses;
  const dim3 grid((n + kRows - 1) / kRows, (c + ct - 1) / ct, (t + tt - 1) / tt);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  binned_counters_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(preds, target, thresholds, out, n, c, t,
                                                                      tpc, ct, tt);
  return (int)cudaGetLastError();
}
