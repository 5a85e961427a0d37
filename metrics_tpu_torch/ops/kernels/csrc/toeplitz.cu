// K8: the batched symmetric Toeplitz solve of SDR, T x = b with T[i][j] = r[|i - j|], by the
// Levinson recursion.
//
// Replaces no Pallas kernel: the JAX package solves SDR's system with XLA's LU
// (metrics_tpu/functional/audio/sdr.py:77, jnp.linalg.solve). On the card PyTorch hands a
// batch of 512 x 512 systems to MAGMA's batched LU, which a CUDA graph cannot capture, and
// cuSOLVER's capturable LU takes ~5x as long; a Cholesky fails on the near-singular systems
// of a pure tone. The recursion needs only the first column r, so this kernel reads 2L
// values a system instead of L^2, and does 4L^2 flops. r, b and x are float32 in memory
// (SDR's only dtype); every step computes in double: the f32 recursion breaks down
// (|e_f| >= 1) on systems that float64 still solves.
//
// Step k (k = 1 .. L-1) grows the size-k solutions to size k + 1. With
//   e_f = sum_{i<k} r[k-i] f[i],  e_x = sum_{i<k} r[k-i] x[i]
// (T_k f = e_1 and T_k x = b[0:k] before the step), inv = 1 / (1 - e_f^2) and
// t_i = f[k-i] - e_f f[i]:
//   f'[k-i] = inv t_i,   x'[i] = x[i] + (b[k] - e_x) inv t_i.
//
// What bounds it on an H100: neither bytes nor operations. At (32, 512) the inputs are
// 128 KB and the work 34 Mflop of FP64, but the L - 1 steps of a system run in sequence and
// each ends in two dot products that every element of the next step waits for: the time is
// L - 1 times the time of one step, which one warp's latency and instruction rate set. The
// design shortens the step.
//
//   L <= 512, the main path's form (levinson_registers): one warp runs one system's whole
//   recursion, with no block barrier; __syncwarp orders the warp's shared-memory traffic. A
//   block holds up to MAX_WARPS systems, one a warp, and takes more than one only when the
//   batch outnumbers the SMs, so an update's 32 systems run on 32 SMs. Lane l owns the
//   elements i = l + 32 j, j < 16: x, r[i+1] and the step's reads live in registers. The step is branch-free: shared memory is laid out so that an element past
//   k reads zeros and writes a zero where one already is, every index a lane's base plus a
//   constant. The recursion runs in phases of 1, 2, 4, 8 and 16 elements a lane, so a step
//   touches only the elements that can be live: one instantiation serves every L <= 512. Each step forms the next step's dot
//   products from three sums over the values it has just read (see steps below), and one
//   pair of interleaved five-level shuffle trees sums e_f' and e_x' while the element
//   updates run.
//
//   512 < L <= 6144 (levinson_block): a step's element work outgrows one warp (at L = 1024
//   one warp took 2.7x as long as a block), so one block of BLOCK_THREADS threads runs one
//   system, r, b, f and x in shared memory in double, two block barriers a step.
//
//   L > 6144 (levinson_global): the same block recursion with f and x in a global scratch of
//   2L doubles a system, which the caller allocates on the launch's stream, and r and b read
//   from the float32 inputs (each converts exactly to the double the shared form stores).
//   The block's barriers order its global accesses as they order shared ones; the vectors
//   stay in the SM's L1 and the L2. No length limit but the batch's scratch.
//
// Shared memory: 16 KB a system at L <= 512; 32 bytes an element up to 6144 (192 KB there,
// one system a block); none but the barrier slots above.
//
// A silent target gives r = 0: 1/r[0] is inf and the solution NaN, as the LU's. A system
// the recursion cannot solve (a singular or indefinite leading block) gives inf or NaN,
// never a host read: nothing reads info.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int MAX_SHARED_L = 6144;         // the longest system of the shared-memory block form
constexpr int MAX_WARPS = 8;            // systems a block of the register form
constexpr int REGISTER_L = 512;         // the longest system of the register form
constexpr int REGISTER_J = REGISTER_L / 32;  // the register form's elements a lane
constexpr int BLOCK_THREADS = 256;      // the block form's threads, one system a block
constexpr int BLOCK_WARPS = BLOCK_THREADS / 32;
constexpr int MAX_SMEM = 32 * MAX_SHARED_L;  // the block form's r, b, f, x in double at L = 6144: 192 KB
constexpr int MAX_DEVICES = 64;
constexpr unsigned FULL = 0xffffffffu;

// Doubles of shared memory a system of the register form takes (levinson_registers).
constexpr int REGISTER_STRIDE = 4 * REGISTER_L + 2;

// pf and px each summed over the warp, in every lane, by two interleaved butterfly trees:
// every lane adds the same values in the same pairs, so all lanes hold bit-equal sums.
__device__ __forceinline__ void warp_sum2(double& pf, double& px) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    pf += __shfl_xor_sync(FULL, pf, o);
    px += __shfl_xor_sync(FULL, px, o);
  }
}

// The register form's reads for step k from f of size k (fi = f[i], fk = f[k-i], rk =
// r[k+1-i] for each element i of the lane) and the lane's parts of the next dot products
// that do not wait for e_f: p1 = sum r[i+1] f[k-i], p2 = sum r[i+1] f[i] and c = sum
// r[k+1-i] x[i]. An element past k reads zeros from f (its slots past k, or the zeros
// below it) and a finite r value that multiplies x = 0, so it adds nothing; every index
// is a lane's base plus a constant, with no clamp and no branch.
template <int J>
__device__ __forceinline__ void read_step(const double* f, const double* r, const double* rp, const double* x,
                                          double* fi, double* fk, double* rk, double* sums, int lane, int k) {
  double p1[2] = {0.0, 0.0}, p2[2] = {0.0, 0.0}, c[2] = {0.0, 0.0};
  const double* fl = f + lane;
  const double* fkl = f + (k - lane);
  const double* rkl = r + (k + 1 - lane);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    fi[j] = fl[32 * j];
    fk[j] = fkl[-32 * j];
    rk[j] = rkl[-32 * j];
    p1[j & 1] += rp[j] * fk[j];
    p2[j & 1] += rp[j] * fi[j];
    c[j & 1] += rk[j] * x[j];
  }
  sums[0] = p1[0] + p1[1];
  sums[1] = p2[0] + p2[1];
  sums[2] = c[0] + c[1];
}

// Steps k0 .. k1 - 1 of the register form, over the lane's first JA elements: the phase's
// steps touch no element i >= 32 JA (k + 1 < 32 JA), whose registers stay 0. With
// t_i = f[k-i] - e_f f[i] the next step's dot products are
//   e_f' = inv sum_i r[i+1] t_i = inv (p1 - e_f p2),
//   e_x' = c + (b[k] - e_x) inv sum_i r[k+1-i] t_i = c + (b[k] - e_x) inv (p2 - e_f p1),
// since over all i <= k, sum r[k+1-i] f[k-i] = p2 and sum r[k+1-i] f[i] = p1 (i -> k - i):
// three sums over the old f and x that read_step forms before e_f arrives, so the shuffle
// trees overlap the element updates. Measured on an H100 (PERF.md): ~350 cycles a step at
// one element a lane, where the trees and the reciprocal set it; ~540 averaged up to
// sixteen, where one warp's instruction rate on the element work (~240 instructions a step,
// 96 of them FP64) sets it.
template <int JA>
__device__ __forceinline__ void steps(int k0, int k1, int L, int lane, double* f0, double* f1, const double* r,
                                      const float* b_row, const double* rp, double* x, double* fi, double* fk,
                                      double* rk, double* sums, double& ef, double& ex, double& bk) {
  for (int k = k0; k < k1; ++k) {
    // f of size k + 1 (fn[-i] is slot k - i); the other copy holds f of size k
    double* fn = ((k & 1) ? f0 : f1) + k;
    const double b_next = k + 1 < L ? static_cast<double>(__ldg(b_row + k + 1)) : 0.0;
    const double inv = 1.0 / (1.0 - ef * ef);
    const double gi = (bk - ex) * inv;
    double pf = inv * (sums[0] - ef * sums[1]);
    double px = sums[2] + gi * (sums[1] - ef * sums[0]);
    warp_sum2(pf, px);  // e_f and e_x of step k + 1; nothing below waits for them
    double* fnl = fn - lane;
#pragma unroll
    for (int j = 0; j < JA; ++j) {
      const double t = fk[j] - ef * fi[j];
      fnl[-32 * j] = t * inv;
      x[j] += gi * t;
    }
    __syncwarp();  // fn written by every lane before any lane reads it, and the old copy read
    read_step<JA>(fn - k, r, rp, x, fi, fk, rk, sums, lane, k + 1);
    ef = pf;
    ex = px;
    bk = b_next;
  }
}

// The phases of the register form: JA = 1, 2, 4, .. J elements a lane, each up to the step
// before its last element can turn live, the last to the end.
template <int J, int JA>
__device__ __forceinline__ void run_phases(int k, int L, int lane, double* f0, double* f1, const double* r,
                                           const float* b_row, const double* rp, double* x, double* fi, double* fk,
                                           double* rk, double* sums, double& ef, double& ex, double& bk) {
  const int k1 = JA == J ? L : (32 * JA - 1 < L ? 32 * JA - 1 : L);
  steps<JA>(k, k1, L, lane, f0, f1, r, b_row, rp, x, fi, fk, rk, sums, ef, ex, bk);
  if constexpr (JA < J)
    run_phases<J, 2 * JA>(k1 > k ? k1 : k, L, lane, f0, f1, r, b_row, rp, x, fi, fk, rk, sums, ef, ex, bk);
}

// L <= REGISTER_L = W: a lane's J elements of x, r[i+1] and the step's reads live in registers.
// One form serves every such L: the phases keep a short system's steps to the elements it has.
//
// Shared memory, W doubles each: zeros, f, f again, r (double), and two more that the last
// step's reads (whose values go unused) reach past r. An index below a region lands in the
// one before it: below the first f in the zeros, below the second f in the first f's slots
// past its size (still 0), below r in f (finite). So every element, past k or not, reads and
// writes at its lane's base plus a constant; an element past k writes 0 where 0 already is.
// b is read from global memory a step ahead.
__global__ void __launch_bounds__(32 * MAX_WARPS)
    levinson_registers(const float* __restrict__ r_g, const float* __restrict__ b_g, float* __restrict__ x_g,
                       int64_t batch, int L) {
  constexpr int J = REGISTER_J, W = REGISTER_L, STRIDE = REGISTER_STRIDE;
  extern __shared__ double sh[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t sys = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (sys >= batch) return;  // whole warps only: nothing below waits on another warp
  double* zeros = sh + static_cast<size_t>(warp) * STRIDE;
  double* f0 = zeros + W;
  double* f1 = f0 + W;
  double* r = f1 + W;
  for (int i = lane; i < STRIDE; i += 32) zeros[i] = 0.0;
  __syncwarp();
  const int64_t base = sys * L;
  for (int i = lane; i < L; i += 32) r[i] = static_cast<double>(r_g[base + i]);
  __syncwarp();
  const double f00 = 1.0 / r[0], x00 = static_cast<double>(b_g[base]) / r[0];
  if (lane == 0) f1[0] = f00;  // f of size 1, read by step 1
  double x[J], rp[J], fi[J], fk[J], rk[J], sums[3];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    x[j] = i == 0 ? x00 : 0.0;
    rp[j] = i + 1 < W ? r[i + 1] : 0.0;  // 0 past L, where r is 0
    fi[j] = fk[j] = rk[j] = 0.0;  // an element stays 0 until its phase reads it
  }
  double ef = 0.0, ex = 0.0, bk = 0.0;
  __syncwarp();
  if (L > 1) {
    ef = r[1] * f00;
    ex = r[1] * x00;
    bk = static_cast<double>(b_g[base + 1]);
    read_step<1>(f1, r, rp, x, fi, fk, rk, sums, lane, 1);
    run_phases<J, 1>(1, L, lane, f0, f1, r, b_g + base, rp, x, fi, fk, rk, sums, ef, ex, bk);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int i = lane + 32 * j;
    if (i < L) x_g[base + i] = static_cast<float>(x[j]);
  }
}

// The block recursion for L > REGISTER_L, one block of BLOCK_THREADS threads a system. R and B
// read r and b (a double array in shared memory, or the float32 input row); f and x are 2L
// doubles (shared memory, or the system's global scratch). A thread updates f in pairs
// (i, k - i), reading both before writing both; after a barrier each thread updates its x[i]
// and forms its share of the next step's two dot products, which one warp-shuffle tree and
// one barrier fold into a per-warp slot. The slots alternate between two buffers by step
// parity, so a step needs two barriers.
template <typename R>
__device__ __forceinline__ void levinson_block_body(R r, R b, double* f, double* x, float* x_out, int L,
                                                    double (*red)[2][BLOCK_WARPS]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < L; i += BLOCK_THREADS) {
    f[i] = 0.0;
    x[i] = 0.0;
  }
  __syncthreads();
  if (tid == 0) {
    f[0] = 1.0 / r(0);
    x[0] = b(0) / r(0);
  }
  __syncthreads();
  {  // the dot products of step 1
    double pf = 0.0, px = 0.0;
    if (tid == 0 && L > 1) {
      pf = r(1) * f[0];
      px = r(1) * x[0];
    }
    warp_sum2(pf, px);
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
    for (int w = 0; w < BLOCK_WARPS; ++w) {
      ef += red[slot][0][w];
      ex += red[slot][1][w];
    }
    const double inv = 1.0 / (1.0 - ef * ef);
    // f[k] is still 0, so [f; 0] and [0; rev f] read f[i] and f[k - i] for every i <= k
    for (int p = tid; 2 * p <= k; p += BLOCK_THREADS) {
      const int q = k - p;
      const double fp = f[p], fq = f[q];
      f[p] = (fp - ef * fq) * inv;
      if (q != p) f[q] = (fq - ef * fp) * inv;
    }
    __syncthreads();
    const double g = b(k) - ex;
    double pf = 0.0, px = 0.0;
    const bool next = k + 1 < L;
    for (int i = tid; i <= k; i += BLOCK_THREADS) {
      const double xi = x[i] + g * f[k - i];
      x[i] = xi;
      if (next) {
        pf += r(k + 1 - i) * f[i];
        px += r(k + 1 - i) * xi;
      }
    }
    warp_sum2(pf, px);
    if (lane == 0) {
      red[slot ^ 1][0][warp] = pf;
      red[slot ^ 1][1][warp] = px;
    }
    __syncthreads();
  }
  for (int i = tid; i < L; i += BLOCK_THREADS) x_out[i] = static_cast<float>(x[i]);
}

// A double vector in shared memory, and a float32 input row read as double.
struct SharedVector {
  const double* v;
  __device__ __forceinline__ double operator()(int i) const { return v[i]; }
};
struct InputRow {
  const float* v;
  __device__ __forceinline__ double operator()(int i) const { return static_cast<double>(__ldg(v + i)); }
};

// 512 < L <= MAX_SHARED_L: grid (B); r, b, f and x in shared memory in double (4L doubles).
__global__ void __launch_bounds__(BLOCK_THREADS)
    levinson_block(const float* __restrict__ r_g, const float* __restrict__ b_g, float* __restrict__ x_g,
                   int64_t batch, int L) {
  extern __shared__ double sh[];
  __shared__ double red[2][2][BLOCK_WARPS];  // [step parity][e_f, e_x][warp]
  double* r = sh;
  double* b = sh + L;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L;
  for (int i = threadIdx.x; i < L; i += BLOCK_THREADS) {
    r[i] = static_cast<double>(r_g[base + i]);
    b[i] = static_cast<double>(b_g[base + i]);
  }  // the body's first barrier orders these loads before any read
  levinson_block_body(SharedVector{r}, SharedVector{b}, sh + 2 * L, sh + 3 * L, x_g + base, L, red);
}

// L > MAX_SHARED_L: grid (B); f and x in the system's 2L doubles of global scratch, r and b
// read from the inputs.
__global__ void __launch_bounds__(BLOCK_THREADS)
    levinson_global(const float* __restrict__ r_g, const float* __restrict__ b_g, float* __restrict__ x_g,
                    double* scratch, int64_t batch, int L) {
  __shared__ double red[2][2][BLOCK_WARPS];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * L;
  double* f = scratch + 2 * base;
  levinson_block_body(InputRow{r_g + base}, InputRow{b_g + base}, f, f + L, x_g + base, L, red);
}

// Whether each device has opted each form of the kernel (0 registers, 1 block) in to more than
// 48 KB of dynamic shared memory: a function attribute holds for one device only, so the first
// launch on each device sets it (an eager launch: a capture's warm-up runs first).
constexpr int FORMS = 2;
std::atomic<bool> opted_in[FORMS][MAX_DEVICES];

int opt_in(const void* kernel, int form, int device, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  if (!opted_in[form][device].load()) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[form][device].store(true);
  }
  return 0;
}

int launch_registers(int device, const float* r, const float* b, float* x, int64_t batch, int L,
                     cudaStream_t stream) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t system_smem = REGISTER_STRIDE * static_cast<int64_t>(sizeof(double));
  int64_t warps = (batch + sms - 1) / sms;  // one system a block until the batch outnumbers the SMs
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  const size_t smem = static_cast<size_t>(warps * system_smem);
  const int opt = opt_in(reinterpret_cast<const void*>(levinson_registers), 0, device, smem);
  if (opt != 0) return opt;
  const int64_t blocks = (batch + warps - 1) / warps;
  levinson_registers<<<static_cast<unsigned>(blocks), static_cast<unsigned>(32 * warps), smem, stream>>>(
      r, b, x, batch, L);
  return static_cast<int>(cudaGetLastError());
}

int launch(const float* r, const float* b, float* x, double* scratch, int64_t batch, int L, cudaStream_t stream) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (L <= REGISTER_L) return launch_registers(device, r, b, x, batch, L, stream);
  if (L > MAX_SHARED_L) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    levinson_global<<<static_cast<unsigned>(batch), BLOCK_THREADS, 0, stream>>>(r, b, x, scratch, batch, L);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = 4 * static_cast<size_t>(L) * sizeof(double);
  const int opt = opt_in(reinterpret_cast<const void*>(levinson_block), 1, device, smem);
  if (opt != 0) return opt;
  levinson_block<<<static_cast<unsigned>(batch), BLOCK_THREADS, smem, stream>>>(r, b, x, batch, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The longest system the kernel solves without global scratch.
int toeplitz_shared_length() { return MAX_SHARED_L; }

// x (batch, L) <- T(r)^-1 b for each of the batch's rows; r, b, x contiguous float32;
// L >= 1, 1 <= batch < 2^31. Above toeplitz_shared_length(), scratch holds 2 L batch
// doubles the launch may overwrite (it is not read for shorter systems and may be null).
// Returns a CUDA error code (cudaErrorInvalidValue for arguments out of range).
int toeplitz_solve(const float* r, const float* b, float* x, double* scratch, int64_t batch, int L, void* stream) {
  if (L < 1 || batch < 1 || batch >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(r, b, x, scratch, batch, L, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
