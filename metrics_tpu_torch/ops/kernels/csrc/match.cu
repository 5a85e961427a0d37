// K9: COCO's greedy detection matcher, for every (problem, area range, IoU threshold) at once.
//
// Replaces no Pallas kernel: the JAX package runs the matcher as a lax.scan over the
// score-sorted detections, vmapped over thresholds, area ranges and (image, class) pairs
// (metrics_tpu/detection/map.py:200-239 _greedy_match_single, :242-293 _match_all_pairs,
// :535-641 grouped_corpus_device), which XLA compiles into one loop. In PyTorch the scan
// would be a Python loop of D steps of ~10 launches each over (P, A, T, G) tensors; the
// scan is sequential within a problem and independent across problems, so the kernel runs
// every (problem, area, threshold) cell from the first detection to the last, in one launch.
//
// The order of preference, JAX's pool/max/where chain: among the open candidates (valid,
// unmatched, IoU >= the threshold) a regular (not area-ignored) ground truth before an
// ignored one, then the larger IoU, then the LATER gt index. -0.0 counts as +0.0 (the float
// comparison's equality), and a NaN IoU or threshold matches nothing. The effective
// threshold is min(thr, 1 - 1e-10) in float32, which is 1.0f; a NaN threshold stays NaN, as
// jnp.minimum propagates it. A detection that is not valid matches nothing and changes
// nothing, so neither path spends a step on it.
//
// What bounds it on an H100: bytes, and mostly the outputs. At COCO val2017's packed shape
// (P ~ 195 520, D = 40, G = 8, A = 4, T = 10) dm and mi are 1.56 GB of writes against a 250
// MB IoU block, and the compares this data needs are few (a pair holds ~2.6 valid detections
// and far fewer ground truths). The step of a cell is sequential, so what the design does is
// keep each step short and keep the stores coalesced:
//
//   G <= 32, the thread path: one thread a cell, the matched set one 32-bit register mask
//   and no shuffle in the step. A block holds pb problems' A * T cells (pb * cb <= 256
//   threads) and stages, per chunk of dc detections, each problem's IoU rows and detection
//   flags in shared memory with coalesced loads; every cell of a problem reads them there.
//   A thread walks only the valid detections and, for each, only its open ground truths
//   (the set bits of its mask, in rising index, so >= keeps the later of equal IoUs). Its
//   match indices go to a shared tile that starts at -1; the block then writes the tile's
//   dm and mi rows out, as one contiguous stream where the block's rows are contiguous in
//   the output (every cell of its problems, every detection in one chunk).
//
//   G > 32, the warp path (up to 1024): one warp a cell, lane l owning the ground truths
//   g = l + 32 k (k < 32), their open and regular flags one 32-bit word each. The warp
//   takes the valid detections of each 32 from a ballot. A lane's best candidate is the
//   largest 32-bit key hi = class << 30 | ord >> 2 (class 2 regular, 1 ignored, 0 none;
//   ord the float's bits mapped to an unsigned order, -0.0 as +0.0, exact for every
//   non-NaN float, so an IoU above 1.0 orders as its value and needs no clamp), then lo =
//   (ord & 3) << 10 | g. Two __reduce_max_sync instructions give the winner: the largest hi,
//   then the largest lo among the lanes that hold it. Lane d % 32 keeps detection d's
//   result, and the warp writes 32 results at a time, coalesced.
//
// Arithmetic: comparisons only, no rounding: the IoUs arrive computed (PyTorch's
// elementwise ops, as JAX's box_iou), so nothing here can contract into an FMA; no flag
// flushes denormals, so they compare as their values.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // the warp path: one cell a warp
constexpr int THREADS = WARPS * 32;
constexpr int MAX_G = 1024;       // 32 ground truths a lane on the warp path
constexpr int THREAD_MAX_G = 32;  // the thread path: the matched set is one 32-bit mask
constexpr int MAX_CHUNK = 64;     // detections a chunk on the thread path
constexpr int THREAD_SMEM = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float effective_threshold(float t) { return t > 1.0f ? 1.0f : t; }

// grid (ceil(P / pb), ceil(A * T / cb)), pb * cb threads: thread tid runs the cell
// (p0 + tid / cb, cy0 + tid % cb) of the flattened (a, t) index. Shared memory per chunk of
// dc detections: IoU rows (pb, dc, G) float, match indices (pb * cb, dc) int, detection flags
// (pb, dc) bytes.
__global__ void __launch_bounds__(THREADS)
    match_thread_kernel(const float* __restrict__ iou, const int* __restrict__ iou_index,
                        const uint8_t* __restrict__ det_valid, const uint8_t* __restrict__ gt_valid,
                        const uint8_t* __restrict__ gt_ignore, const float* __restrict__ thresholds,
                        uint8_t* __restrict__ dm, int* __restrict__ mi, int64_t blocks, int64_t P, int D, int G,
                        int A, int T, int pb, int cb, int dc) {
  extern __shared__ float smem[];
  float* s_iou = smem;
  int* s_mi = reinterpret_cast<int*>(s_iou + pb * dc * G);
  uint8_t* s_dv = reinterpret_cast<uint8_t*>(s_mi + pb * cb * dc);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cells = A * T;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * pb;
  const int pbn = static_cast<int>(P - p0 < pb ? P - p0 : pb);
  const int cy0 = blockIdx.y * cb;
  const int cbn = cells - cy0 < cb ? cells - cy0 : cb;
  const int pi = tid / cb, ci = tid - pi * cb;
  const bool active = pi < pbn && ci < cbn;
  const int64_t p = p0 + pi;
  uint32_t open = 0, regular = 0;
  float thr = 0.0f;
  if (active) {
    const int c = cy0 + ci, a = c / T;
    thr = effective_threshold(thresholds[c - a * T]);
    const int64_t block = iou_index[p];
    if (block >= 0 && block < blocks) {  // an index out of range reads nothing, matches nothing
      for (int g = 0; g < G; ++g)
        if (gt_valid[p * G + g]) open |= 1u << g;
    }
    for (int g = 0; g < G; ++g)
      if (!gt_ignore[(p * A + a) * G + g]) regular |= 1u << g;
  }
  // every cell of the block's problems and every detection in one chunk: the rows are one range
  const bool contiguous = cb == cells && dc == D;
  const float neg_inf = -__int_as_float(0x7f800000);
  for (int dc0 = 0; dc0 < D; dc0 += dc) {
    const int dcn = D - dc0 < dc ? D - dc0 : dc;
    for (int q = 0; q < pbn; ++q) {
      const int64_t block = iou_index[p0 + q];
      if (block < 0 || block >= blocks) continue;
      const float* src = iou + (block * D + dc0) * G;
      float* dst = s_iou + q * dc * G;
      for (int e = tid; e < dcn * G; e += nthreads) dst[e] = src[e];
      for (int e = tid; e < dcn; e += nthreads) s_dv[q * dc + e] = det_valid[(p0 + q) * D + dc0 + e];
    }
    for (int e = tid; e < pb * cb * dc; e += nthreads) s_mi[e] = -1;
    __syncthreads();
    if (active) {
      for (int dd = 0; dd < dcn && open != 0; ++dd) {
        if (!s_dv[pi * dc + dd]) continue;
        const float* row = s_iou + (pi * dc + dd) * G;
        int gr = -1, gi = -1;
        float vr = neg_inf, vi = neg_inf;
        for (uint32_t m = open; m != 0; m &= m - 1) {
          const int g = __ffs(m) - 1;
          const float v = row[g];
          if (v >= thr) {
            if ((regular >> g) & 1u) {
              if (v >= vr) {
                vr = v;
                gr = g;
              }
            } else if (v >= vi) {
              vi = v;
              gi = g;
            }
          }
        }
        const int match = gr >= 0 ? gr : gi;
        if (match >= 0) {
          open &= ~(1u << match);
          s_mi[tid * dc + dd] = match;
        }
      }
    }
    __syncthreads();
    if (contiguous) {
      const int64_t base = p0 * cells * static_cast<int64_t>(D);
      for (int e = tid; e < pbn * cells * D; e += nthreads) {
        const int v = s_mi[e];
        mi[base + e] = v;
        dm[base + e] = v >= 0;
      }
    } else {
      for (int e = tid; e < pb * cb * dcn; e += nthreads) {
        const int row = e / dcn, col = e - row * dcn;
        const int q = row / cb, cr = row - q * cb;
        if (q >= pbn || cr >= cbn) continue;
        const int64_t o = ((p0 + q) * cells + cy0 + cr) * static_cast<int64_t>(D) + dc0 + col;
        const int v = s_mi[row * dc + col];
        mi[o] = v;
        dm[o] = v >= 0;
      }
    }
    __syncthreads();  // the tile is written out before the next chunk refills it
  }
}

// grid (P, ceil(A * T / WARPS)), WARPS warps a block, one (a, t) cell a warp; the warps of a
// block share their problem's IoU block, so its rows come from L1 after the first warp reads
// them.
__global__ void __launch_bounds__(THREADS)
    match_warp_kernel(const float* __restrict__ iou, const int* __restrict__ iou_index,
                      const uint8_t* __restrict__ det_valid, const uint8_t* __restrict__ gt_valid,
                      const uint8_t* __restrict__ gt_ignore, const float* __restrict__ thresholds,
                      uint8_t* __restrict__ dm, int* __restrict__ mi, int64_t blocks, int D, int G, int A, int T) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.y * WARPS + (threadIdx.x >> 5);
  if (cell >= A * T) return;  // whole warps only: the reductions below see all 32 lanes
  const int64_t p = blockIdx.x;
  const int a = cell / T, t = cell % T;
  const float thr = effective_threshold(thresholds[t]);
  const int64_t block = iou_index[p];
  const bool in_range = block >= 0 && block < blocks;
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
  const int64_t out = ((p * A + a) * T + t) * static_cast<int64_t>(D);
  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const uint32_t live = __ballot_sync(FULL, d < D && dvalid[d] != 0);
    int my_mi = -1;
    for (uint32_t m = live; m != 0; m &= m - 1) {  // the same detections in every lane
      const int dd = __ffs(m) - 1;
      const float* row = rows + static_cast<int64_t>(d0 + dd) * G;
      uint32_t hi = 0, lo = 0;
      for (uint32_t o = open; o != 0; o &= o - 1) {
        const int k = __ffs(o) - 1;
        const int g = (k << 5) + lane;
        const float v = __ldg(row + g);
        if (v >= thr) {
          const uint32_t u = v == 0.0f ? 0u : __float_as_uint(v);
          const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
          const uint32_t h = (((regular >> k) & 1u) ? 0x80000000u : 0x40000000u) | (ord >> 2);
          const uint32_t l = ((ord & 3u) << 10) | static_cast<uint32_t>(g);
          if (h > hi || (h == hi && l > lo)) {
            hi = h;
            lo = l;
          }
        }
      }
      const uint32_t best_hi = __reduce_max_sync(FULL, hi);
      if (best_hi != 0) {
        const int match = static_cast<int>(__reduce_max_sync(FULL, hi == best_hi ? lo : 0u) & 1023u);
        if ((match & 31) == lane) open &= ~(1u << (match >> 5));
        if (dd == lane) my_mi = match;
      }
    }
    if (d < D) {
      dm[out + d] = my_mi >= 0;
      mi[out + d] = my_mi;
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
// 1 <= P < 2^31, 1 <= A * T <= 65535 * WARPS. One kernel launch: the thread path for
// G <= 32, the warp path above. Returns a CUDA error code (cudaErrorInvalidValue for
// arguments out of range).
int greedy_match(const float* iou, const int* iou_index, const uint8_t* det_valid, const uint8_t* gt_valid,
                 const uint8_t* gt_ignore, const float* thresholds, uint8_t* dm, int* mi, int64_t blocks,
                 int64_t problems, int D, int G, int A, int T, void* stream) {
  if (G < 1 || G > MAX_G || D < 1 || A < 1 || T < 1 || blocks < 1 || problems < 1 ||
      problems >= (int64_t{1} << 31) || static_cast<int64_t>(A) * T > int64_t{65535} * WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = A * T;
  if (G <= THREAD_MAX_G) {
    const int cb = cells < THREADS ? cells : THREADS;
    const int pb = THREADS / cb;
    const int per_detection = pb * (4 * G + 4 * cb + 1);  // bytes of shared memory a detection of the chunk
    int dc = D < MAX_CHUNK ? D : MAX_CHUNK;
    if (dc * per_detection > THREAD_SMEM) dc = THREAD_SMEM / per_detection;
    const dim3 grid(static_cast<unsigned>((problems + pb - 1) / pb), static_cast<unsigned>((cells + cb - 1) / cb));
    match_thread_kernel<<<grid, pb * cb, static_cast<size_t>(dc) * per_detection, s>>>(
        iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, dm, mi, blocks, problems, D, G, A, T, pb, cb, dc);
  } else {
    const dim3 grid(static_cast<unsigned>(problems), static_cast<unsigned>((cells + WARPS - 1) / WARPS));
    match_warp_kernel<<<grid, THREADS, 0, s>>>(iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, dm, mi,
                                                blocks, D, G, A, T);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
