// K2: the batched masked/weighted fixed-length histogram (bincount).
//
// Replaces metrics_tpu/ops/kernels/pallas_hist.py::histogram_pallas (_hist_kernel).
// Under jax.vmap that pallas_call gains a batch axis in its grid and computes one
// (L, K) histogram per row; this kernel is that batched function itself:
//
//   out[b, j, c] = the sum of w[b, i, c] over the i with mask[b, i] and bin(idx[b, i]) == j
//
// (w = 1 and int32 counts without weights), where bin(v) = max(v, 0) and v >= L drops,
// jnp.bincount's semantics. The index is compared in 64 bits, so an int64 index past
// 2^31 drops and does not wrap into range. Every input is read in place through its
// strides: int32 or int64 indices, a bool/uint8 or int32 mask, weights of nine dtypes,
// each with a batch stride that may be 0 (an unbatched argument the vmap rule expands
// without a copy). The kernel writes the whole (B, L[, K]) output, every element
// exactly once, zeros included: no memset, no global atomics, no host-side index
// folding, one launch per call.
//
// Two forms, by the number N of indices in a row:
//   direct (N <= 16; the vmapped confusion matrix sends (B, 1) int64 indices, L = 100,
//           B = 64, 256 or 1024): a thread owns 4 consecutive output elements, reads
//           its row's N indices and counts the matches of its 4 bins in registers, then
//           writes the 4 with one vector store (16 bytes for 4-byte outputs). No shared
//           memory, no atomic, no barrier; sums add in index order.
//   shared (N > 16; the one-shot confusion matrix sends (1, 16 384) int64, L = 100): a
//           row's indices are split over one thread-block cluster of up to 8 blocks,
//           2048 indices a block, 8 loads a thread issued together. Each block adds its
//           chunk into a private histogram tile in shared memory with shared-memory
//           atomics; after a cluster barrier, rank r sums its slice of the tile over the
//           cluster's blocks in rank order through distributed shared memory and writes
//           it; a second barrier keeps the tiles alive until every rank has. A tile holds
//           48 KB of accumulators (L * K of them when they fit); longer histograms are
//           cut into bin tiles along grid z, each of which reads the row's indices again,
//           so the form costs N * ceil(L * K * sizeof(acc) / 48 KB) index reads: a
//           global-atomic form would pay off only at millions of rows and bins at once,
//           which no caller sends.
//
// Accumulation: counts in int32 (exact up to 2^31 - 1 a bin); f32, bf16 and f16 weights
// in f32, rounded once to the weights' dtype; f64 in f64; int8, int16, int32 and uint8
// in int32 and int64 in 64 bits, wrapping as two's complement and cast back, which
// gives what a sum in the narrow dtype gives. Integer results are exact and the same on
// every run. The shared form's float atomics add in a run-dependent order, so float sums
// match the plain version within reassociation error (2 * n * 2^-24 * sum |w| a cell in
// f32), and the direct form's within the same bound.
//
// What bounds it on an H100: bytes (each index, mask element and weight read once, each
// output element written once), well under a microsecond at the main path's shapes, so
// launch latency decides: one launch, one round of loads, one store per output vector.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                  // output elements a direct-form thread writes
constexpr int DIRECT_MAX_N = 16;        // indices a row up to which the direct form runs
constexpr int UNROLL = 8;               // indices a shared-form thread loads at once
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int TILE_BYTES = 48 * 1024;   // default dynamic shared memory, no opt-in
constexpr int MAX_BLOCKS = 16 * 132;    // direct-form grid; a grid-stride loop beyond
constexpr int MAX_GRID_Y = 65535;       // rows a launch spans; a row loop beyond

// weight dtype codes (hist_cuda.py::_WDTYPE_CODE); COUNTS: no weights, int32 counts
enum Wdtype { COUNTS = -1, F32 = 0, BF16 = 1, F16 = 2, F64 = 3, I8 = 4, I16 = 5, I32 = 6, I64 = 7, U8 = 8 };
enum MaskKind { NO_MASK = 0, MASK_U8 = 1, MASK_I32 = 2 };  // bool is one byte, as uint8

struct Count {};  // the weight type of counts: 1 for every kept index

template <typename T> struct Acc { using type = int32_t; };  // counts, int8, int16, int32, uint8
template <> struct Acc<float> { using type = float; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
template <> struct Acc<__half> { using type = float; };
template <> struct Acc<double> { using type = double; };
template <> struct Acc<int64_t> { using type = unsigned long long; };  // wraps, and has atomicAdd

template <typename T> struct Out { using type = T; };
template <> struct Out<Count> { using type = int32_t; };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ int32_t widen(int8_t v) { return v; }
__device__ __forceinline__ int32_t widen(int16_t v) { return v; }
__device__ __forceinline__ int32_t widen(int32_t v) { return v; }
__device__ __forceinline__ int32_t widen(uint8_t v) { return v; }
__device__ __forceinline__ unsigned long long widen(int64_t v) { return static_cast<unsigned long long>(v); }

// the accumulator in the output dtype: float types round once, integer types keep the
// low bits (two's complement)
template <typename O, typename A> __device__ __forceinline__ O narrow(A a) { return static_cast<O>(a); }
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16, float>(float a) {
  return __float2bfloat16(a);
}
template <> __device__ __forceinline__ __half narrow<__half, float>(float a) { return __float2half(a); }

template <typename A> __device__ __forceinline__ A add(A a, A b) { return a + b; }
template <> __device__ __forceinline__ int32_t add<int32_t>(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

template <typename T> struct alignas(sizeof(T) * VEC) Vec { T x[VEC]; };

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }

// Element (b, i) of an input lies at base + b * stride_b + i * stride_i (elements).
struct Args {
  const void* idx;
  int64_t idx_b, idx_i;
  int idx_wide;  // 0 int32, 1 int64
  const void* mask;
  int64_t mask_b, mask_i;
  int mask_kind;
  const void* w;  // (b, i, c) at w + b * w_b + i * w_i + c * w_c
  int64_t w_b, w_i, w_c;
  int64_t rows, n, length;
  int k;
  void* out;  // (rows, length, k) contiguous
};

// The bins the U indices base, base + step, ... of row b add to, -1 where one drops
// (masked, >= L, or at or past end). The mask and the index are loaded together and
// the mask decides before the index is used. Every load of the batch is issued before
// any is used: the dtype branches sit outside the unrolled loads, which they would
// otherwise serialize.
template <int U>
__device__ __forceinline__ void bins_of(const Args& a, int64_t b, int64_t base, int step, int64_t end,
                                        int64_t (&bin)[U]) {
  int64_t v[U];
  bool keep[U];
  if (a.idx_wide) {
    const int64_t* p = static_cast<const int64_t*>(a.idx) + b * a.idx_b;
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = base + u * step < end ? p[(base + u * step) * a.idx_i] : 0;
  } else {
    const int32_t* p = static_cast<const int32_t*>(a.idx) + b * a.idx_b;
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = base + u * step < end ? p[(base + u * step) * a.idx_i] : 0;
  }
  if (a.mask_kind == MASK_U8) {
    const uint8_t* p = static_cast<const uint8_t*>(a.mask) + b * a.mask_b;
#pragma unroll
    for (int u = 0; u < U; ++u) keep[u] = base + u * step < end && p[(base + u * step) * a.mask_i] != 0;
  } else if (a.mask_kind == MASK_I32) {
    const int32_t* p = static_cast<const int32_t*>(a.mask) + b * a.mask_b;
#pragma unroll
    for (int u = 0; u < U; ++u) keep[u] = base + u * step < end && p[(base + u * step) * a.mask_i] != 0;
  } else {
#pragma unroll
    for (int u = 0; u < U; ++u) keep[u] = base + u * step < end;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int64_t c = v[u] < 0 ? 0 : v[u];
    bin[u] = keep[u] && c < a.length ? c : -1;
  }
}

// The bin index (b, i) adds to, or -1.
__device__ __forceinline__ int64_t bin_of(const Args& a, int64_t b, int64_t i) {
  int64_t bin[1];
  bins_of<1>(a, b, i, 0, i + 1, bin);
  return bin[0];
}

template <typename T>
__device__ __forceinline__ typename Acc<T>::type weight(const Args& a, int64_t b, int64_t i, int c) {
  if constexpr (std::is_same<T, Count>::value) {
    return 1;
  } else {
    return widen(static_cast<const T*>(a.w)[b * a.w_b + i * a.w_i + c * a.w_c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) hist_direct(Args a) {
  using A = typename Acc<T>::type;
  using O = typename Out<T>::type;
  const int64_t lk = a.length * a.k, total = a.rows * lk;
  const bool fits32 = total <= INT32_MAX;  // then 32-bit division: a few instructions, not a call
  O* out = static_cast<O*>(a.out);
  for (int64_t e0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * VEC; e0 < total;
       e0 += (int64_t)gridDim.x * THREADS * VEC) {
    // (row, bin, column) of each element: the first by division, the next by stepping
    int64_t row[VEC], bin[VEC];
    int col[VEC];
    {
      const int64_t b = fits32 ? (int64_t)((uint32_t)e0 / (uint32_t)lk) : e0 / lk;
      const int64_t r = e0 - b * lk;
      const int64_t j = a.k == 1 ? r : (fits32 ? (int64_t)((uint32_t)r / (uint32_t)a.k) : r / a.k);
      row[0] = b, bin[0] = j, col[0] = (int)(r - j * a.k);
    }
#pragma unroll
    for (int u = 1; u < VEC; ++u) {
      row[u] = row[u - 1], bin[u] = bin[u - 1], col[u] = col[u - 1] + 1;
      if (col[u] == a.k) {
        col[u] = 0;
        if (++bin[u] == a.length) bin[u] = 0, ++row[u];
      }
    }
    A acc[VEC];
#pragma unroll
    for (int u = 0; u < VEC; ++u) acc[u] = 0;
    if (row[VEC - 1] == row[0]) {  // one row (always when L * K is a multiple of VEC): each index read once
      for (int64_t i = 0; i < a.n; ++i) {
        const int64_t j = bin_of(a, row[0], i);
#pragma unroll
        for (int u = 0; u < VEC; ++u)
          if (j == bin[u]) acc[u] = add(acc[u], weight<T>(a, row[0], i, col[u]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        if (row[u] < a.rows)
          for (int64_t i = 0; i < a.n; ++i)
            if (bin_of(a, row[u], i) == bin[u]) acc[u] = add(acc[u], weight<T>(a, row[u], i, col[u]));
    }
    Vec<O> v;
#pragma unroll
    for (int u = 0; u < VEC; ++u) v.x[u] = narrow<O>(acc[u]);
    if (e0 + VEC <= total) {
      *reinterpret_cast<Vec<O>*>(out + e0) = v;
    } else {
#pragma unroll
      for (int u = 0; u < VEC; ++u)
        if (e0 + u < total) out[e0 + u] = v.x[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) hist_shared(Args a, int64_t chunk, int tile_bins) {
  using A = typename Acc<T>::type;
  using O = typename Out<T>::type;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) unsigned char smem[];
  A* tile = reinterpret_cast<A*>(smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ranks = (int)cluster.num_blocks();
  const int64_t j0 = (int64_t)blockIdx.z * tile_bins;
  const int bins = (int)lmin(tile_bins, a.length - j0);
  const int elems = bins * a.k;
  const int64_t i0 = rank * chunk, i1 = lmin(a.n, i0 + chunk);
  O* out = static_cast<O*>(a.out);
  for (int64_t b = blockIdx.y; b < a.rows; b += gridDim.y) {
    for (int e = threadIdx.x; e < elems; e += THREADS) tile[e] = A(0);
    __syncthreads();
    for (int64_t base = i0 + threadIdx.x; base < i1; base += THREADS * UNROLL) {
      int64_t at[UNROLL];
      bins_of<UNROLL>(a, b, base, THREADS, i1, at);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        at[u] -= j0;  // a dropped index, -1, stays below 0
        if (at[u] >= 0 && at[u] < bins)
          for (int c = 0; c < a.k; ++c)
            atomicAdd(&tile[at[u] * a.k + c], weight<T>(a, b, base + (int64_t)u * THREADS, c));
      }
    }
    cluster.sync();  // every block's tile is complete and visible to the cluster
    for (int e = rank * THREADS + threadIdx.x; e < elems; e += ranks * THREADS) {
      A part[MAX_CLUSTER];  // the ranks' values, loaded together, then added in rank order
#pragma unroll
      for (int q = 0; q < MAX_CLUSTER; ++q) part[q] = q < ranks ? *cluster.map_shared_rank(tile + e, q) : A(0);
      A s = part[0];
#pragma unroll
      for (int q = 1; q < MAX_CLUSTER; ++q) s = add(s, part[q]);
      out[(b * a.length + j0) * a.k + e] = narrow<O>(s);
    }
    cluster.sync();  // no block zeroes or leaves while another may still read its tile
  }
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using A = typename Acc<T>::type;
  using O = typename Out<T>::type;
  const int64_t total = a.rows * a.length * a.k;
  if (total == 0) return cudaSuccess;
  if (a.n <= DIRECT_MAX_N) {
    if (reinterpret_cast<uintptr_t>(a.out) % sizeof(Vec<O>) != 0) return cudaErrorMisalignedAddress;
    const int64_t blocks = lmin((total + THREADS * VEC - 1) / (THREADS * VEC), MAX_BLOCKS);
    hist_direct<T><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const int64_t per_block = (int64_t)THREADS * UNROLL;
  const int ranks = (int)lmin(MAX_CLUSTER, (a.n + per_block - 1) / per_block);
  const int64_t chunk = (a.n + ranks - 1) / ranks;
  const int64_t tile_bins = lmin(a.length, TILE_BYTES / ((int64_t)a.k * sizeof(A)));
  if (tile_bins == 0) return cudaErrorInvalidValue;  // K columns alone exceed a tile
  const int64_t tiles = (a.length + tile_bins - 1) / tile_bins;
  if (tiles > 65535) return cudaErrorInvalidValue;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = ranks;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ranks, (unsigned)lmin(a.rows, MAX_GRID_Y), (unsigned)tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = (size_t)tile_bins * a.k * sizeof(A);
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, hist_shared<T>, a, chunk, (int)tile_bins);
}

}  // namespace

// idx (B, N) int32 (idx_wide 0) or int64 (1); mask null (mask_kind 0) or (B, N) bool or
// uint8 (1) or int32 (2); w null with wdtype -1 (counts: out (B, L) int32, k = 1), else
// (B, N, K) of the dtype wdtype names (out (B, L, K) of the same dtype). Strides are in
// elements and may be 0. out is contiguous and written whole.
extern "C" int histogram(const void* idx, int idx_wide, int64_t idx_b, int64_t idx_i,
                         const void* mask, int mask_kind, int64_t mask_b, int64_t mask_i,
                         const void* w, int wdtype, int64_t w_b, int64_t w_i, int64_t w_c,
                         int64_t rows, int64_t n, int64_t length, int k, void* out, void* stream) {
  // an empty tensor's data pointer may be null: pointers are checked only where read
  if (rows < 0 || n < 0 || length <= 0 || k <= 0 || (wdtype == COUNTS && k != 1) ||
      (n > 0 && (idx == nullptr || (mask_kind != NO_MASK && mask == nullptr) || (wdtype != COUNTS && w == nullptr))))
    return (int)cudaErrorInvalidValue;
  const Args a{idx, idx_b, idx_i, idx_wide, mask, mask_b, mask_i, mask_kind, w, w_b, w_i, w_c,
               rows, n, length, k, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wdtype) {
    case COUNTS: return (int)launch<Count>(a, s);
    case F32: return (int)launch<float>(a, s);
    case BF16: return (int)launch<__nv_bfloat16>(a, s);
    case F16: return (int)launch<__half>(a, s);
    case F64: return (int)launch<double>(a, s);
    case I8: return (int)launch<int8_t>(a, s);
    case I16: return (int)launch<int16_t>(a, s);
    case I32: return (int)launch<int32_t>(a, s);
    case I64: return (int)launch<int64_t>(a, s);
    case U8: return (int)launch<uint8_t>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
