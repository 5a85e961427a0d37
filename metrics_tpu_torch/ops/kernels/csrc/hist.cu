// K2: masked/weighted fixed-length histogram (bincount) accumulate.
//
// Replaces the TPU kernel metrics_tpu/ops/kernels/pallas_hist.py::histogram_pallas
// (_hist_kernel). The TPU has no fast scatter, so that kernel builds a (blk, L)
// one-hot block and contracts it with the weight columns on the MXU. Hopper has fast
// atomics in shared memory, so this port scatters directly:
//
//   shared path  (L * K * 4 bytes fit in SMEM_LIMIT): each block zeroes a private
//                (L, K) histogram in shared memory, adds its rows with shared-memory
//                atomics, then adds each non-zero bin to the output with one global
//                atomic;
//   global path  (longer histograms, e.g. the 1024 x 100 = 102 400 bins of a vmapped
//                confusion matrix over one 1024-row bucket): atomics straight into the
//                output.
//
// Both paths cover every length, so the TPU gates MAX_HIST_LENGTH and
// _HIST_EXACT_ROWS have no counterpart here. Counts accumulate in int32 and are exact
// (up to 2^31 - 1 per bin). Weight sums accumulate in f32 (bf16 weights are widened
// first) and the caller casts the (L, K) result to the weights' dtype, as
// pallas_hist.py does; float atomics add in no fixed order, so float sums match the
// plain version only within reassociation error.
//
// Index semantics are jnp.bincount's: a negative index counts in bin 0, an index >= L
// drops. The caller drops a masked row by giving it index L.
//
// What bounds it on an H100: bytes (each index and weight is read once, one add per
// element); at the slice's sizes (<= 65 536 rows) launch latency dominates.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1056;          // 8 blocks on each of the H100's 132 SMs
constexpr int SMEM_LIMIT = 48 * 1024;     // default dynamic shared memory, no opt-in needed

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int bin_of(int32_t i) { return i < 0 ? 0 : i; }

__global__ void counts_shared(const int32_t* __restrict__ idx, int64_t n, int length,
                              int32_t* __restrict__ out) {
  extern __shared__ int32_t hist_i[];
  for (int b = threadIdx.x; b < length; b += blockDim.x) hist_i[b] = 0;
  __syncthreads();
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int b = bin_of(idx[r]);
    if (b < length) atomicAdd(&hist_i[b], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < length; b += blockDim.x) {
    if (hist_i[b] != 0) atomicAdd(&out[b], hist_i[b]);
  }
}

__global__ void counts_global(const int32_t* __restrict__ idx, int64_t n, int length,
                              int32_t* __restrict__ out) {
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int b = bin_of(idx[r]);
    if (b < length) atomicAdd(&out[b], 1);
  }
}

template <typename W>
__global__ void weights_shared(const int32_t* __restrict__ idx, const W* __restrict__ w,
                               int64_t n, int length, int k, float* __restrict__ out) {
  extern __shared__ float hist_f[];
  const int bins = length * k;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) hist_f[b] = 0.0f;
  __syncthreads();
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int b = bin_of(idx[r]);
    if (b < length) {
      for (int j = 0; j < k; ++j) atomicAdd(&hist_f[b * k + j], widen(w[r * k + j]));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    if (hist_f[b] != 0.0f) atomicAdd(&out[b], hist_f[b]);
  }
}

template <typename W>
__global__ void weights_global(const int32_t* __restrict__ idx, const W* __restrict__ w,
                               int64_t n, int length, int k, float* __restrict__ out) {
  for (int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; r < n;
       r += (int64_t)gridDim.x * blockDim.x) {
    const int b = bin_of(idx[r]);
    if (b < length) {
      for (int j = 0; j < k; ++j) atomicAdd(&out[(int64_t)b * k + j], widen(w[r * k + j]));
    }
  }
}

int blocks_for(int64_t n) {
  const int64_t b = (n + THREADS - 1) / THREADS;
  return (int)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

template <typename W>
cudaError_t launch_weights(const int32_t* idx, const void* w, int64_t n, int length, int k,
                           float* out, cudaStream_t stream) {
  const size_t smem = (size_t)length * k * sizeof(float);
  if (smem <= SMEM_LIMIT) {
    weights_shared<W><<<blocks_for(n), THREADS, smem, stream>>>(idx, static_cast<const W*>(w), n,
                                                               length, k, out);
  } else {
    weights_global<W><<<blocks_for(n), THREADS, 0, stream>>>(idx, static_cast<const W*>(w), n,
                                                            length, k, out);
  }
  return cudaGetLastError();
}

}  // namespace

// idx (N,) int32; out (L,) int32, zeroed here.
extern "C" int histogram_counts(const void* idx, int64_t n, int length, void* out, void* stream) {
  if (length <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)length * sizeof(int32_t), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int32_t* i = static_cast<const int32_t*>(idx);
  int32_t* o = static_cast<int32_t*>(out);
  const size_t smem = (size_t)length * sizeof(int32_t);
  if (smem <= SMEM_LIMIT) {
    counts_shared<<<blocks_for(n), THREADS, smem, s>>>(i, n, length, o);
  } else {
    counts_global<<<blocks_for(n), THREADS, 0, s>>>(i, n, length, o);
  }
  return (int)cudaGetLastError();
}

// idx (N,) int32; w (N, K) f32 (wdtype 0) or bf16 (wdtype 1); out (L, K) f32, zeroed here.
extern "C" int histogram_weights(const void* idx, const void* w, int64_t n, int length, int k,
                                 int wdtype, void* out, void* stream) {
  if (length <= 0 || k <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)length * k * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  const int32_t* i = static_cast<const int32_t*>(idx);
  float* o = static_cast<float*>(out);
  switch (wdtype) {
    case 0: return (int)launch_weights<float>(i, w, n, length, k, o, s);
    case 1: return (int)launch_weights<__nv_bfloat16>(i, w, n, length, k, o, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
