// K4, K6 and K7: the masked segment reduce, (S, F) state (+) a masked reduce of the
// (N, F) rows into the segment each row's id addresses.
//
// Replaces three TPU kernels that share one body:
//   K4 metrics_tpu/ops/kernels/pallas_segment.py::segment_reduce_pallas (one
//      reduction for every column: the multi-stream engine's per-leaf step);
//   K6 metrics_tpu/ops/kernels/pallas_megastep.py::megastep_segment_pallas
//      (_mega_segment_kernel: a per-column op row, 0 sum / 1 min / 2 max, over a
//      packed arena dtype of the paged engine's resident slots);
//   K7 its q8 form (_mega_segment_q8_kernel): flagged slots first replace their
//      quantized columns by f32(codes) * scales cast to the state's dtype.
// The TPU grid keeps the whole (S, F) state in VMEM as one revisited block and, for
// every row block, compare-select-reduces it once per segment. Hopper blocks run
// in no order, so this port gives each output cell exactly one writer instead:
//
//   pass 0  one warp: a stable counting sort of the row indices by segment. Masked
//           rows and rows whose id lies outside [0, S) go to an extra bin S that
//           pass 1 never reads, so a pad row's garbage id is never used as an
//           address. The bin counts live in shared memory while S + 1 <= 12288
//           (48 KB) and in a global buffer past that, so every S works.
//   pass 1  grid (segments x 128-column tiles), one thread per column: seed the cell
//           from the state (K7: or from the decode), fold the segment's rows in row
//           order under the column's op, write the cell. A segment without rows
//           copies its state through.
//
// One writer per cell means no atomics, and the fold order is the rows' own order,
// so float sums are the same on every run, and a K7 step equals a K6 step on a state
// decoded beforehand, bit for bit. Min and max propagate NaN; int32 sums wrap; bf16
// sums accumulate in f32 and round once before the add to the state, as K1 does.
// Out-of-range unmasked ids drop, as the TPU kernel's ids == s compare drops them
// (the JAX package's plain .at[ids] path would wrap a negative id instead).
//
// What bounds it on an H100: bytes. The rows are read once, the (S, F) state read
// and written once (plus codes and scales for K7); the work is one add or compare
// per row element. At the paged engine's shapes (S = 128 slots of 3000 f32
// columns, a few dozen rows) the state dominates: 3 MB in and out, ~1 us at HBM
// rate, against two launches of a few us each.
#include "reduce.cuh"

namespace {

using namespace reduce;

constexpr int MIXED = 3;  // op row not uniform: per-column op
constexpr int TILE = 128;  // columns per pass-1 block
constexpr int SHARED_BINS = 12288;  // keep in step with segment_cuda._SHARED_BINS

__device__ __forceinline__ int row_bin(const int32_t* ids, const int32_t* mask, int r, int s) {
  if (mask[r] == 0) return s;  // test the mask before the id is trusted
  const int id = ids[r];
  return (id >= 0 && id < s) ? id : s;
}

// One warp. offsets (S + 2): offsets[k] is the first position of bin k in order,
// offsets[S + 1] == N. cur (S + 1) holds the bin counts, then the running cursors.
__global__ void sort_rows(const int32_t* __restrict__ ids, const int32_t* __restrict__ mask,
                          int n, int s, int32_t* __restrict__ offsets, int32_t* cursor_global,
                          int32_t* __restrict__ order) {
  extern __shared__ int32_t shared_bins[];
  int32_t* cur = cursor_global != nullptr ? cursor_global : shared_bins;
  const int lane = threadIdx.x;
  for (int i = lane; i <= s; i += 32) cur[i] = 0;
  __syncwarp();
  for (int base = 0; base < n; base += 32) {  // counts: one add per distinct bin per chunk
    const int r = base + lane;
    const bool live = r < n;
    const int bin = live ? row_bin(ids, mask, r, s) : -1;
    const unsigned active = __ballot_sync(0xffffffffu, live);
    if (live) {
      const unsigned peers = __match_any_sync(active, bin);
      if (lane == __ffs(peers) - 1) cur[bin] += __popc(peers);
    }
    __syncwarp();
  }
  int carry = 0;  // exclusive scan of the S + 1 counts
  for (int base = 0; base <= s; base += 32) {
    const int i = base + lane;
    const int v = i <= s ? cur[i] : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    if (i <= s) {
      offsets[i] = carry + incl - v;
      cur[i] = carry + incl - v;
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) offsets[s + 1] = n;
  __syncwarp();
  for (int base = 0; base < n; base += 32) {  // stable scatter, 32 rows at a time
    const int r = base + lane;
    const bool live = r < n;
    const int bin = live ? row_bin(ids, mask, r, s) : -1;
    const unsigned active = __ballot_sync(0xffffffffu, live);
    unsigned peers = 0;
    if (live) {
      peers = __match_any_sync(active, bin);
      // a row's rank among the earlier rows of its bin in this chunk keeps row order
      order[cur[bin] + __popc(peers & ((1u << lane) - 1u))] = r;
    }
    __syncwarp();  // every lane has read its cursor before the leader moves it
    if (live && lane == __ffs(peers) - 1) cur[bin] += __popc(peers);
    __syncwarp();
  }
}

template <typename T, int FX>
__device__ __forceinline__ T fold_cell(T seed, const T* __restrict__ rows,
                                       const int32_t* __restrict__ order, int lo, int hi, int f,
                                       int c) {
  using A = typename AccOf<T>::type;
  A acc = identity<A, FX>();
  for (int i = lo; i < hi; ++i) acc = combine<FX>(acc, to_acc(rows[(int64_t)order[i] * f + c]));
  return store<FX>(seed, acc);
}

// The host codec's _decode_blocks arithmetic: an exact int8 -> f32 convert, ONE f32
// multiply, one cast. __fmul_rn is never contracted into an FMA with the fold's first
// add, which would round differently from the host decode.
__device__ __forceinline__ float decode(int8_t code, float scale, float) {
  return __fmul_rn((float)code, scale);
}
__device__ __forceinline__ __nv_bfloat16 decode(int8_t code, float scale, __nv_bfloat16) {
  return __float2bfloat16(__fmul_rn((float)code, scale));
}

template <typename T, int UNI, bool Q8>
__global__ void segment_fold(const T* __restrict__ state, const T* __restrict__ rows,
                             const int32_t* __restrict__ order, const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ ops, const int32_t* __restrict__ flags,
                             const int8_t* __restrict__ codes, const float* __restrict__ scales,
                             const int32_t* __restrict__ qcol, T* __restrict__ out, int f) {
  const int seg = blockIdx.x;
  const int c = blockIdx.y * TILE + threadIdx.x;
  if (c >= f) return;
  const int64_t cell = (int64_t)seg * f + c;
  T seed = state[cell];
  if constexpr (Q8) {
    if (flags[seg] != 0 && qcol[c] != 0) seed = decode(codes[cell], scales[cell], seed);
  }
  const int lo = offsets[seg], hi = offsets[seg + 1];
  const int op = UNI == MIXED ? ops[c] : UNI;
  T v;
  switch (op) {
    case SUM: v = fold_cell<T, SUM>(seed, rows, order, lo, hi, f, c); break;
    case MIN: v = fold_cell<T, MIN>(seed, rows, order, lo, hi, f, c); break;
    default: v = fold_cell<T, MAX>(seed, rows, order, lo, hi, f, c); break;
  }
  out[cell] = v;
}

struct Args {
  const void* state;
  const void* rows;
  const int32_t* ops;
  const int32_t* flags;
  const int8_t* codes;
  const float* scales;
  const int32_t* qcol;
  const int32_t* order;
  const int32_t* offsets;
  void* out;
  int f, s;
};

template <typename T, int UNI, bool Q8>
cudaError_t launch_fold(const Args& a, cudaStream_t stream) {
  dim3 grid(a.s, (a.f + TILE - 1) / TILE);
  segment_fold<T, UNI, Q8><<<grid, TILE, 0, stream>>>(
      static_cast<const T*>(a.state), static_cast<const T*>(a.rows), a.order, a.offsets, a.ops,
      a.flags, a.codes, a.scales, a.qcol, static_cast<T*>(a.out), a.f);
  return cudaGetLastError();
}

template <typename T, bool Q8>
cudaError_t launch_op(int uniform, const Args& a, cudaStream_t s) {
  switch (uniform) {
    case SUM: return launch_fold<T, SUM, Q8>(a, s);
    case MIN: return launch_fold<T, MIN, Q8>(a, s);
    case MAX: return launch_fold<T, MAX, Q8>(a, s);
    case MIXED: return launch_fold<T, MIXED, Q8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// state, out (S, F) and rows (N, F) share the dtype; ids, mask (N,) int32; ops (F,)
// int32, read only when uniform == 3 (mixed). flags (S,) int32, codes (S, F) int8,
// scales (S, F) f32 and qcol (F,) int32 are all null (K4, K6) or all given (K7, float
// dtypes only). Scratch: offsets (S + 2) and order (N) int32; cursor (S + 1) int32
// when S + 1 > 12288, else null (the bins then live in shared memory).
extern "C" int segment_fold(const void* state, const void* rows, const void* ids,
                            const void* mask, const void* ops, const void* flags,
                            const void* codes, const void* scales, const void* qcol,
                            void* offsets, void* cursor, void* order, void* out, int n, int f,
                            int s, int dtype, int uniform, void* stream) {
  const bool q8 = flags != nullptr;
  if (f <= 0 || s <= 0 || n < 0 || (uniform == MIXED && ops == nullptr) ||
      (cursor == nullptr && s + 1 > SHARED_BINS) ||
      (q8 && (codes == nullptr || scales == nullptr || qcol == nullptr || dtype == I32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t shared = cursor == nullptr ? (size_t)(s + 1) * sizeof(int32_t) : 0;
  sort_rows<<<1, 32, shared, st>>>(static_cast<const int32_t*>(ids),
                                   static_cast<const int32_t*>(mask), n, s,
                                   static_cast<int32_t*>(offsets), static_cast<int32_t*>(cursor),
                                   static_cast<int32_t*>(order));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args a{state, rows, static_cast<const int32_t*>(ops), static_cast<const int32_t*>(flags),
         static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
         static_cast<const int32_t*>(qcol), static_cast<const int32_t*>(order),
         static_cast<const int32_t*>(offsets), out, f, s};
  switch (dtype) {
    case F32: return (int)(q8 ? launch_op<float, true>(uniform, a, st)
                              : launch_op<float, false>(uniform, a, st));
    case BF16: return (int)(q8 ? launch_op<__nv_bfloat16, true>(uniform, a, st)
                               : launch_op<__nv_bfloat16, false>(uniform, a, st));
    case I32: return (int)launch_op<int32_t, false>(uniform, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
