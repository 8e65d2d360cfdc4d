// The previous design of K1, the binned TP/FP/FN counters, for Hopper
// (sm_90a). Nothing in metrics_tpu_torch launches it: chip_smoke.py builds
// it beside csrc/binned_counters.cu and times both on the same inputs in
// one run, so the redesign's gain is measured, not recalled.
//
// For preds p (N, C) float32, a 0/1 target y (N, C) uint8 and thresholds
// thr (T,) float32 it adds into an int32 (3, C, T) buffer that the caller
// zeroed:
//   tps[c, t] += sum_n y * ge,  fps[c, t] += sum_n (1 - y) * ge,
//   fns[c, t] += sum_n y * (1 - ge),  with ge = (p >= thr[t]).
// It issues a compare and three integer adds for every (row, class,
// threshold), so it is bound by issued instructions. It does not flush
// denormals, so it agrees with binned_counters.cu only on inputs without
// them.
//
// Design: the grid is (row chunk, class tile, threshold tile). A block
// stages kRows rows of its class tile's scores and labels in shared memory.
// Each thread owns one class of the tile and up to kCells of its
// thresholds, which it keeps in registers with exact integer counts; at the
// end every nonzero count goes to device memory with one integer atomicAdd.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 16;       // thresholds per thread, in registers
constexpr int kRows = 128;       // rows staged per block
constexpr int kMaxClasses = 64;  // classes per block: 40 KB of shared memory

__global__ void __launch_bounds__(kThreads)
binned_counters_loop_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
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
extern "C" int binned_counters_loop_launch(const float* preds, const uint8_t* target, const float* thresholds,
                                      int* out, int n, int c, int t, void* stream) {
  if (n <= 0 || c <= 0 || t <= 0) return (int)cudaSuccess;
  const int tt = t < kCells * kThreads ? t : kCells * kThreads;  // thresholds per block
  const int tpc = (tt + kCells - 1) / kCells;                       // threads per class
  int ct = kThreads / tpc;                                          // classes per block
  if (ct > kMaxClasses) ct = kMaxClasses;
  const dim3 grid((n + kRows - 1) / kRows, (c + ct - 1) / ct, (t + tt - 1) / tt);
  if (grid.y > 65535u || grid.z > 65535u) return (int)cudaErrorInvalidConfiguration;
  binned_counters_loop_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(preds, target, thresholds, out, n, c, t,
                                                                      tpc, ct, tt);
  return (int)cudaGetLastError();
}
