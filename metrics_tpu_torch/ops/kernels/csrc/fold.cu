// K1 and K5: the masked row fold, (F,) state (+) a masked reduce over (N, F) rows,
// each column under its own reduction (0 sum, 1 min, 2 max).
//
// Replaces two TPU kernels that share one body:
//   K1 metrics_tpu/ops/kernels/pallas_fold.py::fold_rows_pallas (_fold_kernel): one
//      reduction for every column (the per-leaf masked step);
//   K5 metrics_tpu/ops/kernels/pallas_megastep.py::megastep_fold_pallas
//      (_mega_fold_kernel): a per-column op row over a packed arena dtype; a
//      uniform op row takes a body without the per-column select.
// Those grids walk the row blocks in order and accumulate into one revisited (1, F)
// output block. Thread blocks on Hopper run in no order, so here one launch splits
// the rows of each column tile over one thread-block cluster and folds the pieces
// through distributed shared memory:
//
//   grid (column tiles x row chunks), one cluster of at most 8 chunks per tile,
//   256 threads a block as TX column lanes x TY row lanes. A column lane owns 16
//   bytes of a row (4 f32 or int32 columns, 8 bf16) when F fills whole vectors and
//   the rows start on 16 bytes, else one column (the scalar body: F = 146, the
//   flagship's int32 arena, takes it). Row lane y folds rows y, y + TY, ... of its
//   chunk, UNROLL rows a round: it issues their mask words and their rows together
//   (a masked row is read, and its value dropped), so the row loads never wait for
//   the mask and every shape the engines send (<= 1024 rows) is one round of loads.
//   The row lanes fold into one value per column through shared memory in a fixed
//   tree; after a cluster barrier, rank 0 reads the other chunks' values from their
//   blocks' shared memory, folds them in rank order, then the state, and writes the
//   output; a second barrier keeps that shared memory alive until it has.
//
// No global scratch, no fence, no atomic, no second launch: an earlier form published
// partials to global memory and named the last block with a counter behind
// __threadfence(), and that chain cost as much device time as the second launch it
// saved. The fold order is fixed by the launch shape alone, so float sums are the
// same on every run; min and max are exact in any order (NaN propagates); int32 sums
// wrap as jnp's do. bf16 rows accumulate in f32 and round once, as jnp.sum over bf16
// does, before the bf16 state is added.
//
// What bounds it on an H100: bytes. The unmasked rows are read once (N*F*itemsize)
// and the work is one compare-select or add per element, far below the card's
// 67 TFLOP/s f32 rate. At the engines' shapes (a 256- or 1024-row bucket, F <= 3000)
// the rows are at most 12 MB, a few us at 3.35 TB/s, so latency decides: one launch,
// one round of loads, one cluster exchange.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstring>

#include "reduce.cuh"

namespace {

using namespace reduce;

constexpr int MIXED = 3;        // op row not uniform: per-column op
constexpr int THREADS = 256;    // per block: TX column lanes x TY row lanes
constexpr int UNROLL = 16;      // rows a row lane loads before it folds them
constexpr int MAX_CLUSTER = 8;  // row chunks of a column tile: the portable cluster size
constexpr int TARGET_BLOCKS = 2 * 132;  // two blocks on each of the card's 132 SMs

template <typename T> struct VecOf { static constexpr int value = 16 / sizeof(T); };

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(v, &u, 16);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

// Fold the TY row lanes' values of each column into row lane 0, in a fixed tree.
// Every thread of the block calls it.
template <typename A, int VEC>
__device__ __forceinline__ void fold_lanes(A (&acc)[VEC], const int (&op)[VEC], A* red) {
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * blockDim.x + tx;
#pragma unroll
  for (int i = 0; i < VEC; ++i) red[i * THREADS + tid] = acc[i];
  __syncthreads();
  for (int s = blockDim.y / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[i] = combine_op<A>(op[i], acc[i], red[i * THREADS + tid + s * blockDim.x]);
        red[i * THREADS + tid] = acc[i];
      }
    }
    __syncthreads();
  }
}

template <typename T, int VEC, int UNI>
__global__ void __launch_bounds__(THREADS)
fold_rows_kernel(const T* __restrict__ state, const T* __restrict__ rows,
                 const int32_t* __restrict__ mask, const int32_t* __restrict__ ops,
                 T* __restrict__ out, int n, int f, int chunk_rows) {
  using A = typename AccOf<T>::type;
  namespace cg = cooperative_groups;
  __shared__ A red[VEC * THREADS];
  const int tx = threadIdx.x, ty = threadIdx.y, rows_step = blockDim.y;
  const int c0 = (blockIdx.x * blockDim.x + tx) * VEC;  // this lane's first column
  const bool on = c0 < f;  // VEC > 1 only when F is a multiple of VEC
  int op[VEC];
  A acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    op[i] = UNI == MIXED ? (on ? ops[c0 + i] : SUM) : UNI;
    acc[i] = identity_op<A>(op[i]);
  }

  const int r0 = blockIdx.y * chunk_rows, r1 = min(n, r0 + chunk_rows);
  if (on) {
    for (int base = r0 + ty; base < r1; base += rows_step * UNROLL) {
      int live[UNROLL];
      T v[UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = base + u * rows_step;
        live[u] = 0;
        if (r < r1) {  // the mask word and the row go out together
          live[u] = __ldg(mask + r);
          load_vec<T, VEC>(rows + (int64_t)r * f + c0, v[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (live[u] != 0) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[i] = combine_op<A>(op[i], acc[i], to_acc(v[u][i]));
        }
    }
  }
  fold_lanes<A, VEC>(acc, op, red);  // row lane 0's red slots now hold this chunk's value

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every chunk's value is in its block's shared memory
  if (cluster.block_rank() == 0 && ty == 0 && on) {
    const unsigned chunks = cluster.num_blocks();
    for (unsigned k = 1; k < chunks; ++k) {
      const A* other = cluster.map_shared_rank(red, k);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = combine_op<A>(op[i], acc[i], other[i * THREADS + tx]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[c0 + i] = store_op(op[i], state[c0 + i], acc[i]);
  }
  cluster.sync();  // no block leaves while rank 0 may still read its shared memory
}

struct Plan {
  int vec, tx, ty, tiles, chunks, chunk_rows;
};

// The launch shape: column lanes as wide as the columns need (at most a warp), the
// rest of the block as row lanes, and as many row chunks (one cluster) as one round
// of UNROLL rows a lane needs, more while the grid holds fewer than two blocks per SM
// and a lane has more than one row.
Plan make_plan(int n, int f, int vec) {
  Plan p;
  p.vec = vec;
  const int units = f / vec;
  p.tx = 1;
  while (p.tx < 32 && p.tx < units) p.tx *= 2;
  p.ty = THREADS / p.tx;
  p.tiles = (units + p.tx - 1) / p.tx;
  int chunks = (n + p.ty * UNROLL - 1) / (p.ty * UNROLL);
  if ((int64_t)chunks * p.tiles < TARGET_BLOCKS)
    chunks = std::min((TARGET_BLOCKS + p.tiles - 1) / p.tiles, (n + p.ty - 1) / p.ty);
  chunks = std::max(1, std::min(chunks, MAX_CLUSTER));
  p.chunk_rows = (n + chunks - 1) / chunks;
  p.chunks = chunks;
  return p;
}

template <typename T, int VEC, int UNI>
cudaError_t launch(const void* state, const void* rows, const int32_t* mask, const int32_t* ops,
                   void* out, int n, int f, const Plan& p, cudaStream_t stream) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = p.chunks;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles, p.chunks);
  cfg.blockDim = dim3(p.tx, p.ty);
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fold_rows_kernel<T, VEC, UNI>, static_cast<const T*>(state),
                            static_cast<const T*>(rows), mask, ops, static_cast<T*>(out), n, f,
                            p.chunk_rows);
}

template <typename T, int UNI>
cudaError_t launch_vec(const void* state, const void* rows, const int32_t* mask, const int32_t* ops,
                       void* out, int n, int f, const Plan& p, cudaStream_t s) {
  constexpr int VEC = VecOf<T>::value;
  return p.vec > 1 ? launch<T, VEC, UNI>(state, rows, mask, ops, out, n, f, p, s)
                   : launch<T, 1, UNI>(state, rows, mask, ops, out, n, f, p, s);
}

template <typename T>
cudaError_t launch_op(int uniform, const void* state, const void* rows, const int32_t* mask,
                      const int32_t* ops, void* out, int n, int f, cudaStream_t s) {
  constexpr int VEC = VecOf<T>::value;
  const bool aligned = reinterpret_cast<uintptr_t>(rows) % 16 == 0 && f % VEC == 0;
  const Plan p = make_plan(n, f, aligned ? VEC : 1);
  switch (uniform) {
    case SUM: return launch_vec<T, SUM>(state, rows, mask, ops, out, n, f, p, s);
    case MIN: return launch_vec<T, MIN>(state, rows, mask, ops, out, n, f, p, s);
    case MAX: return launch_vec<T, MAX>(state, rows, mask, ops, out, n, f, p, s);
    case MIXED: return launch_vec<T, MIXED>(state, rows, mask, ops, out, n, f, p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// state (F,), rows (N, F) and out (F,) share the dtype; mask (N,) int32 0/1. uniform
// 0/1/2 names the op every column shares (K1, or K5 on a uniform op row); uniform 3
// (mixed) reads each column's op from ops (F,) int32, which may be null otherwise.
extern "C" int fold_rows(const void* state, const void* rows, const void* mask, const void* ops,
                         void* out, int n, int f, int dtype, int uniform, void* stream) {
  if (f <= 0 || n < 0 || (uniform == MIXED && ops == nullptr)) return (int)cudaErrorInvalidValue;
  const int32_t* m = static_cast<const int32_t*>(mask);
  const int32_t* o = static_cast<const int32_t*>(ops);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return (int)launch_op<float>(uniform, state, rows, m, o, out, n, f, s);
    case BF16: return (int)launch_op<__nv_bfloat16>(uniform, state, rows, m, o, out, n, f, s);
    case I32: return (int)launch_op<int32_t>(uniform, state, rows, m, o, out, n, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
