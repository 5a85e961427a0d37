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
//   G > 1024, the block path (any G): one block a cell, the open set a bitset of G bits in
//   shared memory up to 2^18 ground truths (32 KB), in the cell's slice of a global scratch
//   beyond. Thread i scans g = i + 256 j for each valid detection with the same key, split
//   as (class << 32 | ord) and g so that any G orders; a shuffle tree and one barrier fold
//   the warps' best, and thread 0 clears the winner's bit and writes the detection's result.
//   Two barriers a valid detection: a rare size (COCO's crowds stay far below it), kept
//   simple.
//
// Every path loops over the cells in launches of at most 65 535 grid rows, so A * T has no
// limit but the outputs'.
//
// Arithmetic: comparisons only, no rounding: the IoUs arrive computed (PyTorch's
// elementwise ops, as JAX's box_iou), so nothing here can contract into an FMA; no flag
// flushes denormals, so they compare as their values.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;  // the warp path: one cell a warp
constexpr int THREADS = WARPS * 32;
constexpr int WARP_MAX_G = 1024;  // 32 ground truths a lane on the warp path
constexpr int SHARED_BITSET_G = 1 << 18;  // the block path's open set in shared memory: 32 KB
constexpr int64_t MAX_GRID_Y = 65535;
constexpr int THREAD_MAX_G = 32;  // the thread path: the matched set is one 32-bit mask
constexpr int MAX_CHUNK = 64;     // detections a chunk on the thread path
constexpr int THREAD_SMEM = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float effective_threshold(float t) { return t > 1.0f ? 1.0f : t; }

// grid (ceil(P / pb), rows y0 .. of ceil(A * T / cb)), pb * cb threads: thread tid runs the
// cell (p0 + tid / cb, cy0 + tid % cb) of the flattened (a, t) index. Shared memory per chunk of
// dc detections: IoU rows (pb, dc, G) float, match indices (pb * cb, dc) int, detection flags
// (pb, dc) bytes.
__global__ void __launch_bounds__(THREADS)
    match_thread_kernel(const float* __restrict__ iou, const int* __restrict__ iou_index,
                        const uint8_t* __restrict__ det_valid, const uint8_t* __restrict__ gt_valid,
                        const uint8_t* __restrict__ gt_ignore, const float* __restrict__ thresholds,
                        uint8_t* __restrict__ dm, int* __restrict__ mi, int64_t blocks, int64_t P, int D, int G,
                        int A, int T, int pb, int cb, int dc, int y0) {
  extern __shared__ float smem[];
  float* s_iou = smem;
  int* s_mi = reinterpret_cast<int*>(s_iou + pb * dc * G);
  uint8_t* s_dv = reinterpret_cast<uint8_t*>(s_mi + pb * cb * dc);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int cells = A * T;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * pb;
  const int pbn = static_cast<int>(P - p0 < pb ? P - p0 : pb);
  const int cy0 = (y0 + static_cast<int>(blockIdx.y)) * cb;
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

// grid (P, rows y0 .. of ceil(A * T / WARPS)), WARPS warps a block, one (a, t) cell a warp; the warps of a
// block share their problem's IoU block, so its rows come from L1 after the first warp reads
// them.
__global__ void __launch_bounds__(THREADS)
    match_warp_kernel(const float* __restrict__ iou, const int* __restrict__ iou_index,
                      const uint8_t* __restrict__ det_valid, const uint8_t* __restrict__ gt_valid,
                      const uint8_t* __restrict__ gt_ignore, const float* __restrict__ thresholds,
                      uint8_t* __restrict__ dm, int* __restrict__ mi, int64_t blocks, int D, int G, int A, int T,
                      int y0) {
  const int lane = threadIdx.x & 31;
  const int cell = (y0 + static_cast<int>(blockIdx.y)) * WARPS + (threadIdx.x >> 5);
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


// The block path's candidate order: key = class << 32 | ord (class 2 regular, 1 ignored, 0
// none), then the larger g. Returns whether (k2, g2) beats (k1, g1).
__device__ __forceinline__ bool beats(unsigned long long k2, int64_t g2, unsigned long long k1, int64_t g1) {
  return k2 > k1 || (k2 == k1 && g2 > g1);
}

// grid (P, cells y0 ..), THREADS threads a block, one (a, t) cell a block. open is the cell's
// G-bit open set: dynamic shared memory when scratch is null, else the block's slice of
// scratch (words a block).
__global__ void __launch_bounds__(THREADS)
    match_block_kernel(const float* __restrict__ iou, const int* __restrict__ iou_index,
                       const uint8_t* __restrict__ det_valid, const uint8_t* __restrict__ gt_valid,
                       const uint8_t* __restrict__ gt_ignore, const float* __restrict__ thresholds,
                       uint8_t* __restrict__ dm, int* __restrict__ mi, int64_t blocks, int D, int G, int A, int T,
                       int y0, uint32_t* scratch) {
  extern __shared__ uint32_t s_open[];
  __shared__ unsigned long long s_key[WARPS];
  __shared__ int64_t s_g[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t p = blockIdx.x;
  const int cell = y0 + static_cast<int>(blockIdx.y);
  const int a = cell / T, t = cell % T;
  const float thr = effective_threshold(thresholds[t]);
  const int64_t block = iou_index[p];
  const bool in_range = block >= 0 && block < blocks;
  const int64_t words = (static_cast<int64_t>(G) + 31) >> 5;
  uint32_t* open =
      scratch == nullptr ? s_open
                         : scratch + (static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x) * words;
  const uint8_t* gvalid = gt_valid + p * G;
  const uint8_t* ignored = gt_ignore + (p * A + a) * static_cast<int64_t>(G);
  for (int64_t w = tid; w < words; w += THREADS) {
    uint32_t bits = 0;
    if (in_range)
      for (int j = 0; j < 32; ++j) {
        const int64_t g = (w << 5) + j;
        if (g < G && gvalid[g]) bits |= 1u << j;
      }
    open[w] = bits;
  }
  __syncthreads();
  const float* rows = iou + (in_range ? block : 0) * static_cast<int64_t>(D) * G;
  const uint8_t* dvalid = det_valid + p * D;
  const int64_t out = ((p * A + a) * T + t) * static_cast<int64_t>(D);
  for (int d = 0; d < D; ++d) {
    if (!dvalid[d]) {  // the same flag in every thread: the whole block skips it
      if (tid == 0) {
        dm[out + d] = 0;
        mi[out + d] = -1;
      }
      continue;
    }
    const float* row = rows + static_cast<int64_t>(d) * G;
    unsigned long long key = 0;
    int64_t best = -1;
    for (int64_t g = tid; g < G; g += THREADS) {
      if (!((open[g >> 5] >> (g & 31)) & 1u)) continue;
      const float v = __ldg(row + g);
      if (v >= thr) {
        const uint32_t u = v == 0.0f ? 0u : __float_as_uint(v);
        const uint32_t ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
        const unsigned long long k = (static_cast<unsigned long long>(ignored[g] ? 1u : 2u) << 32) | ord;
        if (beats(k, g, key, best)) {
          key = k;
          best = g;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long k2 = __shfl_xor_sync(FULL, key, o);
      const int64_t g2 = __shfl_xor_sync(FULL, best, o);
      if (beats(k2, g2, key, best)) {
        key = k2;
        best = g2;
      }
    }
    if (lane == 0) {
      s_key[warp] = key;
      s_g[warp] = best;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w)
        if (beats(s_key[w], s_g[w], key, best)) {
          key = s_key[w];
          best = s_g[w];
        }
      if (key != 0) open[best >> 5] &= ~(1u << (best & 31));
      dm[out + d] = key != 0;
      mi[out + d] = key != 0 ? static_cast<int>(best) : -1;
    }
    __syncthreads();  // the open set and the slots settled before the next detection
  }
}

// Launches of kernel over rows 0 .. rows - 1 of grid y, at most MAX_GRID_Y a launch.
template <typename Launch>
int over_rows(int64_t rows, Launch launch) {
  for (int64_t y0 = 0; y0 < rows; y0 += MAX_GRID_Y) {
    launch(static_cast<int>(y0), static_cast<unsigned>(rows - y0 < MAX_GRID_Y ? rows - y0 : MAX_GRID_Y));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int64_t block_path_rows(int64_t cells) { return cells < MAX_GRID_Y ? cells : MAX_GRID_Y; }

}  // namespace

extern "C" {

// 32-bit words of global scratch greedy_match needs for these sizes: the block path's open
// sets when G is past what shared memory holds, else 0.
int64_t match_scratch_words(int64_t problems, int A, int T, int G) {
  if (G <= SHARED_BITSET_G) return 0;
  return problems * block_path_rows(static_cast<int64_t>(A) * T) * ((static_cast<int64_t>(G) + 31) >> 5);
}

// dm, mi (P, A, T, D) <- the greedy match of every problem p against its IoU block
// iou[iou_index[p]] of (blocks, D, G), under the area range's ignore flags gt_ignore (P, A, G)
// and each threshold; det_valid (P, D), gt_valid (P, G) and gt_ignore are 0/1 bytes, mi is -1
// where a detection is unmatched. All contiguous. G, D, A, T >= 1, 1 <= P < 2^31, A * T <
// 2^31, and scratch holds match_scratch_words(P, A, T, G) words (null when that is 0). The
// thread path for G <= 32, the warp path up to 1024, the block path above, each in launches
// of at most 65 535 grid rows. Returns a CUDA error code (cudaErrorInvalidValue for arguments
// out of range).
int greedy_match(const float* iou, const int* iou_index, const uint8_t* det_valid, const uint8_t* gt_valid,
                 const uint8_t* gt_ignore, const float* thresholds, uint8_t* dm, int* mi, uint32_t* scratch,
                 int64_t blocks, int64_t problems, int D, int G, int A, int T, void* stream) {
  const int64_t cells64 = static_cast<int64_t>(A) * T;
  if (G < 1 || D < 1 || A < 1 || T < 1 || blocks < 1 || problems < 1 || problems >= (int64_t{1} << 31) ||
      cells64 >= (int64_t{1} << 31) || (match_scratch_words(problems, A, T, G) > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cells = static_cast<int>(cells64);
  if (G <= THREAD_MAX_G) {
    const int cb = cells < THREADS ? cells : THREADS;
    const int pb = THREADS / cb;
    const int per_detection = pb * (4 * G + 4 * cb + 1);  // bytes of shared memory a detection of the chunk
    int dc = D < MAX_CHUNK ? D : MAX_CHUNK;
    if (dc * per_detection > THREAD_SMEM) dc = THREAD_SMEM / per_detection;
    const unsigned px = static_cast<unsigned>((problems + pb - 1) / pb);
    return over_rows((cells + cb - 1) / cb, [&](int y0, unsigned rows) {
      match_thread_kernel<<<dim3(px, rows), pb * cb, static_cast<size_t>(dc) * per_detection, s>>>(
          iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, dm, mi, blocks, problems, D, G, A, T, pb, cb,
          dc, y0);
    });
  }
  if (G <= WARP_MAX_G)
    return over_rows((cells + WARPS - 1) / WARPS, [&](int y0, unsigned rows) {
      match_warp_kernel<<<dim3(static_cast<unsigned>(problems), rows), THREADS, 0, s>>>(
          iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, dm, mi, blocks, D, G, A, T, y0);
    });
  const size_t smem = G <= SHARED_BITSET_G ? ((static_cast<size_t>(G) + 31) >> 5) * sizeof(uint32_t) : 0;
  return over_rows(cells, [&](int y0, unsigned rows) {
    match_block_kernel<<<dim3(static_cast<unsigned>(problems), rows), THREADS, smem, s>>>(
        iou, iou_index, det_valid, gt_valid, gt_ignore, thresholds, dm, mi, blocks, D, G, A, T, y0,
        G <= SHARED_BITSET_G ? nullptr : scratch);
  });
}

}  // extern "C"
