// K8: the batched symmetric Toeplitz solve of SDR, T x = b with T[i][j] = r[|i - j|], by the
// Levinson recursion.
//
// Replaces no Pallas kernel: the JAX package solves SDR's system with XLA's LU
// (metrics_tpu/functional/audio/sdr.py:87, jnp.linalg.solve). On the card PyTorch hands a
// batch of 512 x 512 systems to MAGMA's batched LU, which a CUDA graph cannot capture, and
// cuSOLVER's capturable LU takes ~5x as long; a Cholesky fails on the near-singular systems
// of a pure tone. The recursion needs only the first column r, so this kernel reads 2L
// values a system instead of L^2, and does 4L^2 flops.
//
//   grid (B), one block of THREADS threads per system; r, b and x are float32 in memory
//   (SDR's only dtype), while r, b, the forward vector f and the solution x live in shared
//   memory in double (4L doubles: 16 KB at L = 512), and every step accumulates in double:
//   the f32 recursion breaks down (|e_f| >= 1) on systems that float64 still solves.
//
//   Step k (k = 1 .. L-1) grows the size-k solutions to size k + 1. With
//     e_f = sum_{i<k} r[k-i] f[i],  e_x = sum_{i<k} r[k-i] x[i]
//   (T_k f = e_1 and T_k x = b[0:k] before the step):
//     f <- ([f; 0] - e_f [0; rev f]) / (1 - e_f^2),   x <- [x; 0] + (b[k] - e_x) rev(f).
//   A thread updates f in pairs (i, k - i), reading both before writing both; after a
//   barrier each thread updates its x[i] and forms its share of the next step's two dot
//   products, which one warp-shuffle tree and one barrier fold into a per-warp slot. The
//   slots alternate between two buffers by step parity, so a step needs two barriers.
//
// A silent target gives r = 0: 1/r[0] is inf and the solution NaN, as the LU's. A system
// the recursion cannot solve (a singular or indefinite leading block) gives inf or NaN,
// never a host read: nothing reads info.
//
// What bounds it on an H100: neither bytes nor operations. At (32, 512) the inputs are
// 128 KB and the work 34 Mflop of FP64; the L - 1 steps run in sequence, each two block
// barriers and a five-level shuffle tree, so latency sets the time.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_L = 6144;  // 4L doubles of shared memory: 192 KB, under the H100's 227 KB
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS) levinson_kernel(const float* __restrict__ r_g, const float* __restrict__ b_g,
                                                           float* __restrict__ x_g, int L) {
  extern __shared__ double sh[];
  double* r = sh;
  double* b = sh + L;
  double* f = sh + 2 * L;
  double* x = sh + 3 * L;
  __shared__ double red[2][2][WARPS];  // [step parity][e_f, e_x][warp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L;
  for (int i = tid; i < L; i += THREADS) {
    r[i] = static_cast<double>(r_g[base + i]);
    b[i] = static_cast<double>(b_g[base + i]);
    f[i] = 0.0;
    x[i] = 0.0;
  }
  __syncthreads();
  if (tid == 0) {
    f[0] = 1.0 / r[0];
    x[0] = b[0] / r[0];
  }
  __syncthreads();
  {  // the dot products of step 1
    double pf = 0.0, px = 0.0;
    if (tid == 0 && L > 1) {
      pf = r[1] * f[0];
      px = r[1] * x[0];
    }
    pf = warp_sum(pf);
    px = warp_sum(px);
    if (lane == 0) {
      red[1][0][warp] = pf;
      red[1][1][warp] = px;
    }
  }
  __syncthreads();
  for (int k = 1; k < L; ++k) {
    const int slot = k & 1;
    double ef = 0.0, ex = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      ef += red[slot][0][w];
      ex += red[slot][1][w];
    }
    const double inv = 1.0 / (1.0 - ef * ef);
    // f[k] is still 0, so [f; 0] and [0; rev f] read f[i] and f[k - i] for every i <= k
    for (int p = tid; 2 * p <= k; p += THREADS) {
      const int q = k - p;
      const double fp = f[p], fq = f[q];
      f[p] = (fp - ef * fq) * inv;
      if (q != p) f[q] = (fq - ef * fp) * inv;
    }
    __syncthreads();
    const double g = b[k] - ex;
    double pf = 0.0, px = 0.0;
    const bool next = k + 1 < L;
    for (int i = tid; i <= k; i += THREADS) {
      const double xi = x[i] + g * f[k - i];
      x[i] = xi;
      if (next) {
        pf += r[k + 1 - i] * f[i];
        px += r[k + 1 - i] * xi;
      }
    }
    pf = warp_sum(pf);
    px = warp_sum(px);
    if (lane == 0) {
      red[slot ^ 1][0][warp] = pf;
      red[slot ^ 1][1][warp] = px;
    }
    __syncthreads();
  }
  for (int i = tid; i < L; i += THREADS) x_g[base + i] = static_cast<float>(x[i]);
}

// Whether each device has opted the kernel in to more than 48 KB of dynamic shared memory:
// a function attribute holds for one device only, so the first launch on each device sets it
// (an eager launch: a capture's warm-up runs first).
std::atomic<bool> opted_in[MAX_DEVICES];

int launch(const float* r, const float* b, float* x, int64_t batch, int L, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(L) * sizeof(double);
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    if (!opted_in[device].load()) {
      err = cudaFuncSetAttribute(levinson_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 4 * MAX_L * static_cast<int>(sizeof(double)));
      if (err != cudaSuccess) return static_cast<int>(err);
      opted_in[device].store(true);
    }
  }
  levinson_kernel<<<static_cast<unsigned>(batch), THREADS, smem, stream>>>(r, b, x, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest system size the kernel takes.
int toeplitz_max_length() { return MAX_L; }

// x (batch, L) <- T(r)^-1 b for each of the batch's rows; r, b, x contiguous float32;
// 1 <= L <= toeplitz_max_length(), 1 <= batch < 2^31. Returns a CUDA error code
// (cudaErrorInvalidValue for arguments out of range).
int toeplitz_solve(const float* r, const float* b, float* x, int64_t batch, int L, void* stream) {
  if (L < 1 || L > MAX_L || batch < 1 || batch >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(r, b, x, batch, L, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
