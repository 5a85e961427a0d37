// K1: masked row fold, (1, F) state (+) masked sum/min/max over (N, F) rows.
//
// Replaces the TPU kernel metrics_tpu/ops/kernels/pallas_fold.py::fold_rows_pallas
// (_fold_kernel). That grid walks the row blocks in order and accumulates into one
// revisited (1, F) output block. Thread blocks on Hopper run in no order, so this
// port is two deterministic passes:
//
//   pass 1  grid (column tiles x row chunks): each block folds ROWS_PER_CHUNK rows
//           of a 32-column tile (masked rows skipped, i.e. they contribute the
//           reduction's identity) and writes one (1, 32) partial;
//   pass 2  one thread per column folds the R partials in chunk order, then the
//           carried state.
//
// The fold order is fixed by the launch shape alone, so float sums are the same on
// every run; min and max are exact in any order; int32 sums wrap as jnp's do.
// bf16 rows accumulate in f32 and round once, as jnp.sum over bf16 does, before the
// bf16 state is added.
//
// What bounds it on an H100: bytes. The rows are read once (N*F*itemsize) and the
// work is one compare-select or add per element, far below the card's 67 TFLOP/s
// f32 rate; at the masked step's shapes (N = 1024 bucket rows, F <= 1000) the two
// launches themselves cost more than the ~1 us of HBM traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_F = 32;  // columns per block: one warp reads 32 neighbouring elements
constexpr int ROWS_Y = 8;   // thread rows per block
constexpr int FINISH_THREADS = 256;

enum Fx { SUM = 0, MIN = 1, MAX = 2 };
enum Dtype { F32 = 0, BF16 = 1, I32 = 2 };

template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int32_t> { using type = int32_t; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int32_t to_acc(int32_t v) { return v; }

template <int FX> __device__ __forceinline__ float identity_f() {
  return FX == SUM ? 0.0f : (FX == MIN ? INFINITY : -INFINITY);
}
template <int FX> __device__ __forceinline__ int32_t identity_i() {
  return FX == SUM ? 0 : (FX == MIN ? INT32_MAX : INT32_MIN);
}
template <typename A, int FX> __device__ __forceinline__ A identity();
template <> __device__ __forceinline__ float identity<float, SUM>() { return identity_f<SUM>(); }
template <> __device__ __forceinline__ float identity<float, MIN>() { return identity_f<MIN>(); }
template <> __device__ __forceinline__ float identity<float, MAX>() { return identity_f<MAX>(); }
template <> __device__ __forceinline__ int32_t identity<int32_t, SUM>() { return identity_i<SUM>(); }
template <> __device__ __forceinline__ int32_t identity<int32_t, MIN>() { return identity_i<MIN>(); }
template <> __device__ __forceinline__ int32_t identity<int32_t, MAX>() { return identity_i<MAX>(); }

// NaN propagates through min/max, as in torch.min / jnp.min.
template <int FX> __device__ __forceinline__ float combine(float a, float b) {
  if (FX == SUM) return a + b;
  if (a != a) return a;
  if (b != b) return b;
  if (FX == MIN) return b < a ? b : a;
  return b > a ? b : a;
}
template <int FX> __device__ __forceinline__ int32_t combine(int32_t a, int32_t b) {
  if (FX == SUM) return (int32_t)((uint32_t)a + (uint32_t)b);  // two's-complement wrap
  if (FX == MIN) return b < a ? b : a;
  return b > a ? b : a;
}

template <typename T, int FX>
__global__ void fold_partials(const T* __restrict__ rows, const int32_t* __restrict__ mask,
                              typename AccOf<T>::type* __restrict__ partials, int n, int f,
                              int chunk) {
  using A = typename AccOf<T>::type;
  __shared__ A tile[ROWS_Y][TILE_F];
  const int c = blockIdx.x * TILE_F + threadIdx.x;
  const int r0 = blockIdx.y * chunk;
  const int r1 = min(n, r0 + chunk);
  A acc = identity<A, FX>();
  if (c < f) {
    for (int r = r0 + threadIdx.y; r < r1; r += ROWS_Y) {
      if (mask[r] != 0) acc = combine<FX>(acc, to_acc(rows[(int64_t)r * f + c]));
    }
  }
  tile[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && c < f) {
    for (int y = 1; y < ROWS_Y; ++y) acc = combine<FX>(acc, tile[y][threadIdx.x]);
    partials[(int64_t)blockIdx.y * f + c] = acc;
  }
}

template <int FX>
__device__ __forceinline__ void store(float* out, int c, float state, float acc) {
  out[c] = combine<FX>(state, acc);
}
template <int FX>
__device__ __forceinline__ void store(int32_t* out, int c, int32_t state, int32_t acc) {
  out[c] = combine<FX>(state, acc);
}
template <int FX>
__device__ __forceinline__ void store(__nv_bfloat16* out, int c, __nv_bfloat16 state, float acc) {
  // the rows' own reduction rounds to bf16 first (jnp.sum over bf16 returns bf16),
  // then the bf16 add with the state rounds again; min/max values are exact bf16
  const float red = __bfloat162float(__float2bfloat16(acc));
  out[c] = __float2bfloat16(combine<FX>(__bfloat162float(state), red));
}

template <typename T, int FX>
__global__ void fold_finish(const T* __restrict__ state,
                            const typename AccOf<T>::type* __restrict__ partials,
                            T* __restrict__ out, int f, int r) {
  using A = typename AccOf<T>::type;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= f) return;
  A acc = identity<A, FX>();
  for (int i = 0; i < r; ++i) acc = combine<FX>(acc, partials[(int64_t)i * f + c]);
  store<FX>(out, c, state[c], acc);
}

template <typename T, int FX>
cudaError_t launch(const void* state, const void* rows, const int32_t* mask, void* partials,
                   void* out, int n, int f, int chunk, cudaStream_t stream) {
  using A = typename AccOf<T>::type;
  const int r = (n + chunk - 1) / chunk;
  if (r > 0) {
    dim3 grid((f + TILE_F - 1) / TILE_F, r);
    dim3 block(TILE_F, ROWS_Y);
    fold_partials<T, FX><<<grid, block, 0, stream>>>(static_cast<const T*>(rows), mask,
                                                     static_cast<A*>(partials), n, f, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  fold_finish<T, FX><<<(f + FINISH_THREADS - 1) / FINISH_THREADS, FINISH_THREADS, 0, stream>>>(
      static_cast<const T*>(state), static_cast<const A*>(partials), static_cast<T*>(out), f, r);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fx(int fx, const void* state, const void* rows, const int32_t* mask,
                      void* partials, void* out, int n, int f, int chunk, cudaStream_t stream) {
  switch (fx) {
    case SUM: return launch<T, SUM>(state, rows, mask, partials, out, n, f, chunk, stream);
    case MIN: return launch<T, MIN>(state, rows, mask, partials, out, n, f, chunk, stream);
    case MAX: return launch<T, MAX>(state, rows, mask, partials, out, n, f, chunk, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// state (F,), rows (N, F) and out (F,) share the dtype; mask (N,) int32 0/1;
// partials holds ceil(N / chunk) * F accumulators (f32 for f32/bf16, int32 for int32).
extern "C" int fold_rows(const void* state, const void* rows, const void* mask, void* partials,
                         void* out, int n, int f, int chunk, int dtype, int fx, void* stream) {
  if (f <= 0 || n < 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* m = static_cast<const int32_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return (int)launch_fx<float>(fx, state, rows, m, partials, out, n, f, chunk, s);
    case BF16: return (int)launch_fx<__nv_bfloat16>(fx, state, rows, m, partials, out, n, f, chunk, s);
    case I32: return (int)launch_fx<int32_t>(fx, state, rows, m, partials, out, n, f, chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
