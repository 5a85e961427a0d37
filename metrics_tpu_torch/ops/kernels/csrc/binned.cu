// K3: binned precision-recall counts, TP/FP/FN (C, T) of (N, C) preds against T
// thresholds, with no (N, C, T) intermediate.
//
// Replaces the TPU kernel metrics_tpu/ops/binned_update.py::binned_counts_pallas
// (_binned_kernel). That grid streams row blocks through VMEM in order and loops the
// thresholds on the VPU, accumulating f32 counts into revisited (T, C) blocks. Here
// one launch does it all. A thread owns one class and Q consecutive thresholds (Q = 4
// when T is a multiple of 4 and the thresholds and outputs start on 16 bytes, so it
// reads them and writes each output as one float4; else Q = 1), and counts in
// registers, for its rows, the positives (pred >= threshold), the true positives and
// the targets; FP = positives - TP and FN = targets - TP.
//
//   few rows (N < 64: the vmapped masked step, N = 1 row of B*C widened classes,
//   nearly every launch of the engines): binned_rows_kernel, 256 threads a block
//   over the (class, threshold) pairs, no shared memory and no barrier; each thread
//   reads its preds and targets, counts and writes its three outputs as f32. No
//   scratch, no atomics, no conversion pass: the bytes are the inputs once and the
//   3*C*T*4 output bytes once.
//
//   many rows (the one-shot update): binned_chunks_kernel, 32 pair lanes x 8 row
//   lanes over (pair tiles x row chunks), about two blocks per SM. The row lanes fold their
//   counts in shared memory; each block adds its counts with int32 atomics to a
//   (3, C, T) buffer, and the last block of a pair tile to finish (an integer counter
//   behind __threadfence(), atomicInc wrapping it to 0) takes the sums with
//   atomicExch(.., 0), so the buffer is zero again for the next launch, and writes
//   them as f32. Integer counts are exact in any order: the result is deterministic.
//
// Semantics are binned_counts_jnp's: a pred counts as positive when pred >= threshold,
// so a NaN pred or a NaN threshold is never positive (a NaN pred counts as a false
// negative when its target is set), the -inf pred of a pad row with target 0 counts
// nowhere (but at a -inf threshold), and thresholds may come in any order, repeated.
//
// What bounds it on an H100: at the vmapped shape, bytes: the 3*C*T f32 outputs
// (12 MB at B = 1024) dwarf the inputs, and the kernel writes each once in 16-byte
// stores; at 64 and 256 rows the launch itself outweighs them. At the one-shot shape
// the N*C*T compares (~3 instructions each) and the N*C*5 input bytes sit near the
// same bound of a few tenths of a microsecond; the many-row form is far from it (its
// row loop of scattered 4- and 1-byte loads and the atomics onto each output are the
// suspects), and a row tile staged through shared memory is the next design.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int MANY_ROWS = 64;            // from this many rows: row lanes and row chunks
constexpr int ROW_LANES = 8;             // row lanes per block when the rows are many
constexpr int ROWS_PER_LANE = 32;        // rows a row lane aims to count
constexpr int TARGET_BLOCKS = 2 * 132;   // two blocks on each of the card's 132 SMs
constexpr int MAX_CHUNKS = 65535;

template <int Q>
__device__ __forceinline__ void load_q(const float* __restrict__ p, float (&v)[Q]) {
  if constexpr (Q == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int Q>
__device__ __forceinline__ void store_q(float* __restrict__ p, const int (&v)[Q]) {
  if constexpr (Q == 4) {
    *reinterpret_cast<float4*>(p) = make_float4((float)v[0], (float)v[1], (float)v[2], (float)v[3]);
  } else {
    p[0] = (float)v[0];
  }
}

// Count rows r0, r0 + step, ... < r1 of class cls against the Q thresholds thr into
// tp, fp and fn (FP = positives - TP, FN = targets - TP).
template <int Q>
__device__ __forceinline__ void count_rows(const float* __restrict__ preds,
                                           const uint8_t* __restrict__ target, const float (&thr)[Q],
                                           int64_t r0, int64_t r1, int step, int c, int cls,
                                           int (&tp)[Q], int (&fp)[Q], int (&fn)[Q]) {
  int pos[Q];
  int y_count = 0;
#pragma unroll
  for (int q = 0; q < Q; ++q) pos[q] = tp[q] = 0;
#pragma unroll 16
  for (int64_t r = r0; r < r1; r += step) {
    const float p = __ldg(preds + r * c + cls);
    const int y = __ldg(target + r * c + cls) != 0;
    y_count += y;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int ge = p >= thr[q];
      pos[q] += ge;
      tp[q] += ge & y;
    }
  }
#pragma unroll
  for (int q = 0; q < Q; ++q) fp[q] = pos[q] - tp[q], fn[q] = y_count - tp[q];
}

// Few rows: one thread per Q pairs counts every row and writes its outputs.
template <int Q>
__global__ void __launch_bounds__(THREADS)
binned_rows_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                   const float* __restrict__ thresholds, int n, int c, int t,
                   float* __restrict__ tp_out, float* __restrict__ fp_out, float* __restrict__ fn_out) {
  const int per_class = t / Q;
  const int g = blockIdx.x * THREADS + threadIdx.x;  // this thread's Q pairs (C*T < 2**31)
  if (g >= c * per_class) return;
  const int cls = g / per_class, t0 = g % per_class * Q;
  float thr[Q];
  int tp[Q], fp[Q], fn[Q];
  load_q<Q>(thresholds + t0, thr);
  count_rows<Q>(preds, target, thr, 0, n, 1, c, cls, tp, fp, fn);
  const int64_t at = (int64_t)cls * t + t0;
  store_q<Q>(tp_out + at, tp);
  store_q<Q>(fp_out + at, fp);
  store_q<Q>(fn_out + at, fn);
}

// Many rows: row lanes, row chunks, and int32 sums the last chunk of a tile takes.
template <int Q>
__global__ void __launch_bounds__(THREADS)
binned_chunks_kernel(const float* __restrict__ preds, const uint8_t* __restrict__ target,
                     const float* __restrict__ thresholds, int64_t n, int c, int t,
                     int64_t chunk_rows, int32_t* __restrict__ sums, unsigned* __restrict__ counters,
                     float* __restrict__ tp_out, float* __restrict__ fp_out,
                     float* __restrict__ fn_out) {
  __shared__ int red[3 * Q * THREADS];
  __shared__ bool last;
  const int ty = threadIdx.y, tid = ty * blockDim.x + threadIdx.x;
  const int per_class = t / Q;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;  // this thread's Q pairs (C*T < 2**31)
  const bool on = g < c * per_class;
  const int cls = on ? g / per_class : 0;
  const int t0 = on ? g % per_class * Q : 0;
  const int64_t at = (int64_t)cls * t + t0;  // its first output

  float thr[Q];
  int tp[Q], fp[Q], fn[Q];
  if (on) {
    load_q<Q>(thresholds + t0, thr);
    const int64_t r0 = blockIdx.y * chunk_rows, r1 = r0 + chunk_rows < n ? r0 + chunk_rows : n;
    count_rows<Q>(preds, target, thr, r0 + ty, r1, blockDim.y, c, cls, tp, fp, fn);
  } else {
#pragma unroll
    for (int q = 0; q < Q; ++q) tp[q] = fp[q] = fn[q] = 0;
  }

  // fold the row lanes into lane 0 through shared memory
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    red[(0 * Q + q) * THREADS + tid] = tp[q];
    red[(1 * Q + q) * THREADS + tid] = fp[q];
    red[(2 * Q + q) * THREADS + tid] = fn[q];
  }
  __syncthreads();
  if (ty == 0) {
    for (int y = 1; y < blockDim.y; ++y) {
      const int o = tid + y * blockDim.x;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        tp[q] += red[(0 * Q + q) * THREADS + o];
        fp[q] += red[(1 * Q + q) * THREADS + o];
        fn[q] += red[(2 * Q + q) * THREADS + o];
      }
    }
  }

  const int chunks = gridDim.y;
  const int64_t pairs = (int64_t)c * t;
  if (chunks > 1) {
    // add this chunk's counts; the pair tile's last chunk to finish takes the sums
    if (ty == 0 && on) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (tp[q]) atomicAdd(sums + at + q, tp[q]);
        if (fp[q]) atomicAdd(sums + pairs + at + q, fp[q]);
        if (fn[q]) atomicAdd(sums + 2 * pairs + at + q, fn[q]);
      }
    }
    __threadfence();  // the counts are in before the counter says so
    __syncthreads();
    if (tid == 0) last = atomicInc(counters + blockIdx.x, chunks - 1) == chunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (ty == 0 && on) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        tp[q] = atomicExch(sums + at + q, 0);  // read, and leave the buffer zero
        fp[q] = atomicExch(sums + pairs + at + q, 0);
        fn[q] = atomicExch(sums + 2 * pairs + at + q, 0);
      }
    }
  }
  if (ty == 0 && on) {
    store_q<Q>(tp_out + at, tp);
    store_q<Q>(fp_out + at, fp);
    store_q<Q>(fn_out + at, fn);
  }
}

struct Plan {
  int q, lanes, rows, tiles;
  int64_t chunks, chunk_rows;
};

Plan make_plan(int64_t n, int c, int t, bool aligned) {
  Plan p;
  p.q = (aligned && t % 4 == 0) ? 4 : 1;
  p.rows = n >= MANY_ROWS ? ROW_LANES : 1;
  p.lanes = THREADS / p.rows;
  const int64_t units = (int64_t)c * (t / p.q);
  p.tiles = (int)((units + p.lanes - 1) / p.lanes);
  int64_t chunks = 1;
  if (n >= MANY_ROWS) {
    chunks = (n + (int64_t)p.rows * ROWS_PER_LANE - 1) / ((int64_t)p.rows * ROWS_PER_LANE);
    if (chunks * p.tiles < TARGET_BLOCKS)
      chunks = std::min<int64_t>((TARGET_BLOCKS + p.tiles - 1) / p.tiles, (n + p.rows - 1) / p.rows);
    chunks = std::max<int64_t>(1, std::min<int64_t>(chunks, MAX_CHUNKS));
  }
  p.chunk_rows = n > 0 ? (n + chunks - 1) / chunks : 0;
  p.chunks = n > 0 ? (n + p.chunk_rows - 1) / p.chunk_rows : 1;
  return p;
}

template <int Q>
cudaError_t launch(const Plan& p, const float* preds, const uint8_t* target, const float* thr,
                   int64_t n, int c, int t, int32_t* sums, unsigned* counters, float* tp, float* fp,
                   float* fn, cudaStream_t s) {
  if (n < MANY_ROWS)
    binned_rows_kernel<Q><<<p.tiles, THREADS, 0, s>>>(preds, target, thr, (int)n, c, t, tp, fp, fn);
  else
    binned_chunks_kernel<Q><<<dim3(p.tiles, (unsigned)p.chunks), dim3(p.lanes, p.rows), 0, s>>>(
        preds, target, thr, n, c, t, p.chunk_rows, sums, counters, tp, fp, fn);
  return cudaGetLastError();
}

}  // namespace

// The int32 scratch elements binned_counts needs for N rows of C classes against T
// thresholds: 0 when one row chunk takes them (no scratch is read), else room for
// the (3, C, T) sums and one counter per pair tile.
extern "C" int64_t binned_scratch_ints(int64_t n, int c, int t) {
  return n >= MANY_ROWS ? 4 * (int64_t)c * t : 0;
}

// preds (N, C) f32; target (N, C) bool (1 byte); thresholds (T,) f32; tp, fp, fn:
// (C, T) f32 outputs. scratch: binned_scratch_ints(n, c, t) int32 elements, zero before
// the launch and zero after it (null when that is 0).
extern "C" int binned_counts(const void* preds, const void* target, const void* thresholds,
                             int64_t n, int c, int t, void* scratch, void* tp, void* fp, void* fn,
                             void* stream) {
  if (c <= 0 || t <= 0 || n < 0 || (binned_scratch_ints(n, c, t) > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(thresholds) | reinterpret_cast<uintptr_t>(tp) |
                         reinterpret_cast<uintptr_t>(fp) | reinterpret_cast<uintptr_t>(fn)) % 16) == 0;
  const Plan p = make_plan(n, c, t, aligned);
  int32_t* sums = static_cast<int32_t*>(scratch);
  unsigned* counters = sums == nullptr ? nullptr : reinterpret_cast<unsigned*>(sums + 3 * (int64_t)c * t);
  const auto* pr = static_cast<const float*>(preds);
  const auto* tg = static_cast<const uint8_t*>(target);
  const auto* th = static_cast<const float*>(thresholds);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o0 = static_cast<float*>(tp);
  auto* o1 = static_cast<float*>(fp);
  auto* o2 = static_cast<float*>(fn);
  return (int)(p.q == 4 ? launch<4>(p, pr, tg, th, n, c, t, sums, counters, o0, o1, o2, s)
                        : launch<1>(p, pr, tg, th, n, c, t, sums, counters, o0, o1, o2, s));
}
