// K1 and K5: the masked row fold, (1, F) state (+) a masked reduce over (N, F) rows,
// each column under its own reduction (0 sum, 1 min, 2 max).
//
// Replaces two TPU kernels that share one body:
//   K1 metrics_tpu/ops/kernels/pallas_fold.py::fold_rows_pallas (_fold_kernel): one
//      reduction for every column (the per-leaf masked step);
//   K5 metrics_tpu/ops/kernels/pallas_megastep.py::megastep_fold_pallas
//      (_mega_fold_kernel): a per-column op row over a packed arena dtype; a
//      uniform op row takes a body without the per-column select.
// Those grids walk the row blocks in order and accumulate into one revisited (1, F)
// output block. Thread blocks on Hopper run in no order, so this port is two
// deterministic passes:
//
//   pass 1  grid (column tiles x row chunks): each block folds ROWS_PER_CHUNK rows
//           of a 32-column tile under each column's op (masked rows skipped, i.e.
//           they contribute the reduction's identity) and writes one partial;
//   pass 2  one thread per column folds the R partials in chunk order, then the
//           carried state.
//
// The fold order is fixed by the launch shape alone, so float sums are the same on
// every run; min and max are exact in any order; int32 sums wrap as jnp's do.
// bf16 rows accumulate in f32 and round once, as jnp.sum over bf16 does, before the
// bf16 state is added. The op is a template constant when every column shares it
// (K1 always); the mixed body reads it per column (the columns of one leaf share
// it, so a warp rarely diverges). Each column computes only its own op's
// reduction, which selects the same value as the TPU kernel's
// compute-all-three-then-select.
//
// What bounds it on an H100: bytes. The unmasked rows are read once
// (N*F*itemsize) and the work is one compare-select or add per element, far below
// the card's 67 TFLOP/s f32 rate. At the engine's shapes (a 1024-row bucket,
// F <= 3000) the rows are a few MB, a few us at HBM rate, and the two launches
// cost about as much again.
#include "reduce.cuh"

namespace {

using namespace reduce;

constexpr int MIXED = 3;    // op row not uniform: per-column op
constexpr int TILE_F = 32;  // columns per block: one warp reads 32 neighbouring elements
constexpr int ROWS_Y = 8;   // thread rows per block
constexpr int FINISH_THREADS = 256;

template <typename T, int FX>
__device__ __forceinline__ typename AccOf<T>::type chunk_acc(const T* __restrict__ rows,
                                                             const int32_t* __restrict__ mask,
                                                             int r0, int r1, int f, int c) {
  using A = typename AccOf<T>::type;
  A acc = identity<A, FX>();
  for (int r = r0 + threadIdx.y; r < r1; r += ROWS_Y) {
    if (mask[r] != 0) acc = combine<FX>(acc, to_acc(rows[(int64_t)r * f + c]));
  }
  return acc;
}

template <int FX, typename A>
__device__ __forceinline__ A tile_acc(A (*tile)[TILE_F], A acc) {
  for (int y = 1; y < ROWS_Y; ++y) acc = combine<FX>(acc, tile[y][threadIdx.x]);
  return acc;
}

template <typename T, int UNI>
__global__ void fold_partials(const T* __restrict__ rows, const int32_t* __restrict__ mask,
                              const int32_t* __restrict__ ops,
                              typename AccOf<T>::type* __restrict__ partials, int n, int f,
                              int chunk) {
  using A = typename AccOf<T>::type;
  __shared__ A tile[ROWS_Y][TILE_F];
  const int c = blockIdx.x * TILE_F + threadIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = c < f ? min(n, r0 + chunk) : r0;  // out-of-range columns read nothing
  const int op = UNI == MIXED ? (c < f ? ops[c] : SUM) : UNI;
  A acc;
  switch (op) {
    case SUM: acc = chunk_acc<T, SUM>(rows, mask, r0, r1, f, c); break;
    case MIN: acc = chunk_acc<T, MIN>(rows, mask, r0, r1, f, c); break;
    default: acc = chunk_acc<T, MAX>(rows, mask, r0, r1, f, c); break;
  }
  tile[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < f) {
    switch (op) {
      case SUM: acc = tile_acc<SUM>(tile, acc); break;
      case MIN: acc = tile_acc<MIN>(tile, acc); break;
      default: acc = tile_acc<MAX>(tile, acc); break;
    }
    partials[(int64_t)blockIdx.y * f + c] = acc;
  }
}

template <typename T, int FX>
__device__ __forceinline__ T finish_col(T state, const typename AccOf<T>::type* partials, int f,
                                        int r, int c) {
  using A = typename AccOf<T>::type;
  A acc = identity<A, FX>();
  for (int i = 0; i < r; ++i) acc = combine<FX>(acc, partials[(int64_t)i * f + c]);
  return store<FX>(state, acc);
}

template <typename T, int UNI>
__global__ void fold_finish(const T* __restrict__ state, const typename AccOf<T>::type* partials,
                            const int32_t* __restrict__ ops, T* __restrict__ out, int f, int r) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= f) return;
  const int op = UNI == MIXED ? ops[c] : UNI;
  switch (op) {
    case SUM: out[c] = finish_col<T, SUM>(state[c], partials, f, r, c); break;
    case MIN: out[c] = finish_col<T, MIN>(state[c], partials, f, r, c); break;
    default: out[c] = finish_col<T, MAX>(state[c], partials, f, r, c); break;
  }
}

template <typename T, int UNI>
cudaError_t launch(const void* state, const void* rows, const int32_t* mask, const int32_t* ops,
                   void* partials, void* out, int n, int f, int chunk, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const int r = (n + chunk - 1) / chunk;
  if (r > 0) {
    dim3 grid((f + TILE_F - 1) / TILE_F, r);
    dim3 block(TILE_F, ROWS_Y);
    fold_partials<T, UNI><<<grid, block, 0, stream>>>(static_cast<const T*>(rows), mask, ops,
                                                      static_cast<A*>(partials), n, f, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fold_finish<T, UNI><<<(f + FINISH_THREADS - 1) / FINISH_THREADS, FINISH_THREADS, 0, stream>>>(
      static_cast<const T*>(state), static_cast<const A*>(partials), ops, static_cast<T*>(out),
      f, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int uniform, const void* state, const void* rows, const int32_t* mask,
                      const int32_t* ops, void* partials, void* out, int n, int f, int chunk,
                      cudaStream_t s) {
  switch (uniform) {
    case SUM: return launch<T, SUM>(state, rows, mask, ops, partials, out, n, f, chunk, s);
    case MIN: return launch<T, MIN>(state, rows, mask, ops, partials, out, n, f, chunk, s);
    case MAX: return launch<T, MAX>(state, rows, mask, ops, partials, out, n, f, chunk, s);
    case MIXED: return launch<T, MIXED>(state, rows, mask, ops, partials, out, n, f, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// state (F,), rows (N, F) and out (F,) share the dtype; mask (N,) int32 0/1. uniform
// 0/1/2 names the op every column shares (K1, or K5 on a uniform op row); uniform 3
// (mixed) reads each column's op from ops (F,) int32, which may be null otherwise.
// partials holds ceil(N / chunk) * F accumulators (f32 for f32/bf16, int32 for int32).
extern "C" int fold_rows(const void* state, const void* rows, const void* mask, const void* ops,
                         void* partials, void* out, int n, int f, int chunk, int dtype,
                         int uniform, void* stream) {
  if (f <= 0 || n < 0 || chunk <= 0 || (uniform == MIXED && ops == nullptr))
    return (int)cudaErrorInvalidValue;
  const int32_t* m = static_cast<const int32_t*>(mask);
  const int32_t* o = static_cast<const int32_t*>(ops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return (int)launch_op<float>(uniform, state, rows, m, o, partials, out, n, f, chunk, s);
    case BF16:
      return (int)launch_op<__nv_bfloat16>(uniform, state, rows, m, o, partials, out, n, f, chunk, s);
    case I32: return (int)launch_op<int32_t>(uniform, state, rows, m, o, partials, out, n, f, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
