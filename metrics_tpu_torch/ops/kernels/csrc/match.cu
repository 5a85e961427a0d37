// K9: COCO's greedy detection matcher, for every (problem, area range, IoU threshold) at once.
//
// Replaces no Pallas kernel: the JAX package runs the matcher as a lax.scan over the
// score-sorted detections, vmapped over thresholds, area ranges and (image, class) pairs
// (metrics_tpu/detection/map.py:200-239 _greedy_match_single, :242-293 _match_all_pairs,
// :535-641 grouped_corpus_device), which XLA compiles into one loop. In PyTorch the scan
// would be a Python loop of D steps of ~10 launches each over (P, A, T, G) tensors; the
// scan is sequential within a problem and independent across problems, so one warp runs
// one (problem, area, threshold) cell from the first detection to the last.
//
//   grid (P, ceil(A * T / WARPS)), WARPS warps a block, one (a, t) cell a warp; the
//   warps of a block share their problem's IoU block, so its rows come from L1 after the
//   first warp reads them. Lane l owns the ground truths g = l + 32 k (k < 32, so
//   G <= 1024): their valid, regular (not area-ignored) and matched flags are one 32-bit
//   word each, in registers. Detection d is one step: every lane forms the key
//     regular << 63 | (IoU bits without the sign) << 32 | 1 << 31 | g
//   of each of its open candidates (valid, unmatched, IoU >= the threshold), and one
//   five-level 64-bit shuffle max gives the winner: regular before area-ignored, then the
//   larger IoU, then the LATER gt index, as JAX's pool/max/where chain. An IoU is never
//   negative (intersection over a positive union, or 0), so its bits order like its
//   values, -0.0 taken as +0.0 as the comparison takes it; bit 31 marks a candidate, so
//   the key 0 means none. The owning lane sets the matched bit; lane d % 32 keeps the
//   step's (matched, index) and every 32 steps the warp writes 32 results coalesced.
//   The effective threshold is min(thr, 1 - 1e-10) in float32, which is 1.0f; a NaN
//   threshold stays NaN and matches nothing, as jnp.minimum propagates it.
//
// Arithmetic: comparisons only, no rounding: the IoUs arrive computed (PyTorch's
// elementwise ops, as JAX's box_iou), so nothing here can contract into an FMA.
//
// What bounds it on an H100: neither bytes nor compares. At COCO val2017's packed shape the
// IoU block is read once per cell from L1/L2 and the work is ~G/32 compares a lane a step,
// but the D steps of a cell run in sequence, each a shuffle tree: latency sets the time.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 1024;  // 32 ground truths a lane: each flag set is one 32-bit word a lane

__device__ __forceinline__ unsigned long long warp_max(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_xor_sync(0xffffffffu, v, o);
    v = w > v ? w : v;
  }
  return v;
}

__global__ void __launch_bounds__(THREADS)
    greedy_match_kernel(const float* __restrict__ iou, const int* __restrict__ iou_index,
                        const uint8_t* __restrict__ det_valid, const uint8_t* __restrict__ gt_valid,
                        const uint8_t* __restrict__ gt_ignore, const float* __restrict__ thresholds,
                        uint8_t* __restrict__ dm, int* __restrict__ mi, int64_t blocks, int D, int G, int A,
                        int T) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (cell >= A * T) return;  // whole warps only: the shuffles below see all 32 lanes
  const int64_t p = blockIdx.x;
  const int a = cell / T, t = cell % T;
  const float t_raw = thresholds[t];
  const float thr = t_raw > 1.0f ? 1.0f : t_raw;
  const int64_t block = iou_index[p];
  const bool in_range = block >= 0 && block < blocks;  // an index out of range reads nothing, matches nothing
  const float* rows = iou + (in_range ? block : 0) * static_cast<int64_t>(D) * G;
  const int slots = (G + 31) >> 5;
  uint32_t open = 0, regular = 0;
  for (int k = 0; k < slots; ++k) {
    const int g = (k << 5) + lane;
    if (g < G) {
      if (in_range && gt_valid[p * G + g]) open |= 1u << k;
      if (!gt_ignore[(p * A + a) * G + g]) regular |= 1u << k;
    }
  }
  const uint8_t* dvalid = det_valid + p * D;
  const int64_t out = ((p * A + a) * T + t) * D;
  uint8_t my_dm = 0;
  int my_mi = -1;
  for (int d = 0; d < D; ++d) {
    const float* row = rows + static_cast<int64_t>(d) * G;
    unsigned long long best = 0;
    for (int k = 0; k < slots; ++k) {
      if (!((open >> k) & 1u)) continue;
      const int g = (k << 5) + lane;
      const float v = __ldg(row + g);
      if (v >= thr) {
        const unsigned long long key = (static_cast<unsigned long long>((regular >> k) & 1u) << 63) |
                                       (static_cast<unsigned long long>(__float_as_uint(v) & 0x7fffffffu) << 32) |
                                       0x80000000ull | static_cast<unsigned>(g);
        best = key > best ? key : best;
      }
    }
    best = warp_max(best);
    const bool hit = best != 0 && dvalid[d] != 0;
    const int match = static_cast<int>(best & 0x7fffffffull);
    if (hit && (match & 31) == lane) open &= ~(1u << (match >> 5));
    if ((d & 31) == lane) {
      my_dm = hit ? 1 : 0;
      my_mi = hit ? match : -1;
    }
    if ((d & 31) == 31 || d == D - 1) {
      const int i = (d & ~31) + lane;
      if (i <= d) {
        dm[out + i] = my_dm;
        mi[out + i] = my_mi;
      }
    }
  }
}

}  // namespace

extern "C" {

// The largest ground-truth count G the kernel takes.
int match_max_gts() { return MAX_G; }

// dm, mi (P, A, T, D) <- the greedy match of every problem p against its IoU block
// iou[iou_index[p]] of (blocks, D, G), under the area range's ignore flags gt_ignore (P, A, G)
// and each threshold; det_valid (P, D), gt_valid (P, G) and gt_ignore are 0/1 bytes, mi is -1
// where a detection is unmatched. All contiguous. 1 <= G <= match_max_gts(), D >= 1,
// 1 <= P < 2^31, 1 <= A * T <= 65535 * WARPS. Returns a CUDA error code
// (cudaErrorInvalidValue for arguments out of range).
int greedy_match(const float* iou, const int* iou_index, const uint8_t* det_valid, const uint8_t* gt_valid,
                 const uint8_t* gt_ignore, const float* thresholds, uint8_t* dm, int* mi, int64_t blocks,
                 int64_t problems, int D, int G, int A, int T, void* stream) {
  if (G < 1 || G > MAX_G || D < 1 || A < 1 || T < 1 || blocks < 1 || problems < 1 ||
      problems >= (int64_t{1} << 31) || static_cast<int64_t>(A) * T > int64_t{65535} * WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(problems), static_cast<unsigned>((A * T + WARPS - 1) / WARPS));
  greedy_match_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, dm, mi, blocks, D, G, A, T);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
