// Shared pieces of the reduction kernels (fold.cu, segment.cu): the
// reductions' identities, the NaN-propagating combine, and the bf16 store rule.
// Every kernel folds masked-out rows as the reduction's identity, with the SAME
// element the plain versions use (ops/kernels/common.py::reduce_identity).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace reduce {

enum Fx { SUM = 0, MIN = 1, MAX = 2 };  // indices into common.REDUCE_OPS
enum Dtype { F32 = 0, BF16 = 1, I32 = 2 };

// f32 and bf16 accumulate in f32, int32 in int32
template <typename T> struct AccOf { using type = float; };
template <> struct AccOf<int32_t> { using type = int32_t; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ int32_t to_acc(int32_t v) { return v; }

template <typename A, int FX> __device__ __forceinline__ A identity();
template <> __device__ __forceinline__ float identity<float, SUM>() { return 0.0f; }
template <> __device__ __forceinline__ float identity<float, MIN>() { return INFINITY; }
template <> __device__ __forceinline__ float identity<float, MAX>() { return -INFINITY; }
template <> __device__ __forceinline__ int32_t identity<int32_t, SUM>() { return 0; }
template <> __device__ __forceinline__ int32_t identity<int32_t, MIN>() { return INT32_MAX; }
template <> __device__ __forceinline__ int32_t identity<int32_t, MAX>() { return INT32_MIN; }

// NaN propagates through min/max, as in torch.minimum / jnp.minimum (fminf and
// fmaxf would drop it).
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

// state (+) the rows' reduction, in the state's dtype
template <int FX> __device__ __forceinline__ float store(float state, float acc) {
  return combine<FX>(state, acc);
}
template <int FX> __device__ __forceinline__ int32_t store(int32_t state, int32_t acc) {
  return combine<FX>(state, acc);
}
template <int FX>
__device__ __forceinline__ __nv_bfloat16 store(__nv_bfloat16 state, float acc) {
  // the rows' own reduction rounds to bf16 first (jnp.sum over bf16 returns bf16),
  // then the bf16 add with the state rounds again; min/max values are exact bf16
  const float red = __bfloat162float(__float2bfloat16(acc));
  return __float2bfloat16(combine<FX>(__bfloat162float(state), red));
}

// The same three with the op known only at run time (a per-column op row); with a
// compile-time op the switch folds away.
template <typename A> __device__ __forceinline__ A identity_op(int op) {
  switch (op) {
    case SUM: return identity<A, SUM>();
    case MIN: return identity<A, MIN>();
    default: return identity<A, MAX>();
  }
}
template <typename A> __device__ __forceinline__ A combine_op(int op, A a, A b) {
  switch (op) {
    case SUM: return combine<SUM>(a, b);
    case MIN: return combine<MIN>(a, b);
    default: return combine<MAX>(a, b);
  }
}
template <typename T, typename A> __device__ __forceinline__ T store_op(int op, T state, A acc) {
  switch (op) {
    case SUM: return store<SUM>(state, acc);
    case MIN: return store<MIN>(state, acc);
    default: return store<MAX>(state, acc);
  }
}

}  // namespace reduce
