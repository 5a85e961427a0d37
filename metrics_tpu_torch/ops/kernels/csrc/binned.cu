// K3: binned precision-recall counts, TP/FP/FN (C, T) of (N, C) preds against T
// thresholds, with no (N, C, T) intermediate.
//
// Replaces the TPU kernel metrics_tpu/ops/binned_update.py::binned_counts_pallas
// (_binned_kernel). That grid streams row blocks through VMEM in order and loops the
// thresholds on the VPU, accumulating f32 counts into revisited (T, C) blocks. Here
// one thread owns one (class, threshold) pair, so the grid spreads over both the
// pairs (x) and row chunks (y): the one-shot update has N = 65 536 rows and C*T =
// 1000 pairs, the vmapped masked step has N = 1 row and C*T = 1024 * 10 * 100 pairs.
// A thread counts its chunk in registers (neighbouring threads share a class and read
// the same pred, which the cache broadcasts), then adds its three counts to an int32
// (3, C, T) buffer with one global atomic each. Integer atomics make the counts exact
// and deterministic; a second launch converts them to the f32 outputs the metric
// states hold.
//
// Semantics are binned_counts_jnp's: a pred counts as positive when pred >= threshold,
// so a NaN pred is never positive (it counts as a false negative when its target is
// set) and the -inf pred of a pad row with target 0 counts nowhere.
//
// What bounds it on an H100: at the one-shot shape the N*C*T compare-and-count
// operations (~3 per triple) and the N*C*5 bytes of input sit near the same bound of a
// few tenths of a microsecond; the vmapped shape is latency-bound.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MIN_CHUNK = 256;        // rows per block along y
constexpr int MAX_GRID_Y = 65535;

__global__ void count_pairs(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                            const float* __restrict__ thresholds, int64_t n, int c, int t,
                            int64_t chunk, int32_t* __restrict__ counts) {
  const int64_t pairs = (int64_t)c * t;
  const int64_t pair = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (pair >= pairs) return;
  const int col = (int)(pair / t);
  const float thr = thresholds[pair % t];
  const int64_t r0 = blockIdx.y * chunk;
  const int64_t r1 = r0 + chunk < n ? r0 + chunk : n;
  int32_t tp = 0, fp = 0, fn = 0;
  for (int64_t r = r0; r < r1; ++r) {
    const float p = preds[r * c + col];
    const bool y = target[r * c + col] != 0;
    const bool ge = p >= thr;
    tp += (y && ge);
    fp += (!y && ge);
    fn += (y && !ge);
  }
  if (tp) atomicAdd(&counts[pair], tp);
  if (fp) atomicAdd(&counts[pairs + pair], fp);
  if (fn) atomicAdd(&counts[2 * pairs + pair], fn);
}

__global__ void counts_to_f32(const int32_t* __restrict__ counts, int64_t pairs,
                              float* __restrict__ tp, float* __restrict__ fp,
                              float* __restrict__ fn) {
  const int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (i >= pairs) return;
  tp[i] = (float)counts[i];
  fp[i] = (float)counts[pairs + i];
  fn[i] = (float)counts[2 * pairs + i];
}

}  // namespace

// preds (N, C) f32; target (N, C) bool (1 byte); thresholds (T,) f32;
// counts: int32 scratch of 3*C*T; tp, fp, fn: (C, T) f32 outputs.
extern "C" int binned_counts(const void* preds, const void* target, const void* thresholds,
                             int64_t n, int c, int t, void* counts, void* tp, void* fp, void* fn,
                             void* stream) {
  if (c <= 0 || t <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t pairs = (int64_t)c * t;
  cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)(3 * pairs) * sizeof(int32_t), s);
  if (err != cudaSuccess) return (int)err;
  const int pair_blocks = (int)((pairs + THREADS - 1) / THREADS);
  if (n > 0) {
    int64_t chunk = MIN_CHUNK;
    if ((n + chunk - 1) / chunk > MAX_GRID_Y) chunk = (n + MAX_GRID_Y - 1) / MAX_GRID_Y;
    dim3 grid(pair_blocks, (unsigned)((n + chunk - 1) / chunk));
    count_pairs<<<grid, THREADS, 0, s>>>(static_cast<const float*>(preds),
                                         static_cast<const uint8_t*>(target),
                                         static_cast<const float*>(thresholds), n, c, t, chunk,
                                         static_cast<int32_t*>(counts));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  counts_to_f32<<<pair_blocks, THREADS, 0, s>>>(static_cast<const int32_t*>(counts), pairs,
                                                static_cast<float*>(tp), static_cast<float*>(fp),
                                                static_cast<float*>(fn));
  return (int)cudaGetLastError();
}
