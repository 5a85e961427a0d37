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
// every row block, compare-select-reduces it once per segment. Hopper blocks run in
// no order, so this port sorts the rows by segment and gives each output cell exactly
// one writer. Two launches:
//
//   pass 0  one block of 1024 threads, a stable counting sort of the row indices by
//           segment. It reads ids and mask once, coalesced, and keeps each row's bin in
//           shared memory (up to 4096 rows): the segment, or -1 for a masked row or an
//           id outside [0, S), so a pad row's garbage id is never used as an address.
//           Warp w owns one contiguous range of rows and counts its rows per bin
//           (__match_any_sync) into column w of a (bin, warp) table; one exclusive scan
//           of the table by the whole block gives every warp the position of its first
//           row in every bin, and a second walk over its range scatters the row indices
//           there, ranked among a 32-row chunk's peers: each segment's rows keep row
//           order. The table lives in shared memory up to 7680 entries and in the global
//           scratch past that, so every S works. Pass 0 then cuts every segment of more
//           than R = 64 rows into R-row chunks: it lists the chunks past the first, gives
//           each chunk a partial slot and zeroes one finish counter per (segment, tile).
//   pass 1  grid (S + the most chunks past the first that N rows can make) x 128-column
//           tiles, one thread per column, launched as a programmatic dependent of pass 0:
//           its blocks start while pass 0 sorts, read what pass 0 does not write (block
//           s's seed, K7's decode, the state tile as 16-byte vectors where aligned) and
//           only then wait for pass 0's results (griddepcontrol.wait). A block past S
//           whose chunk does not exist leaves at once. Block s takes segment s.
//           Untouched, it writes its state tile through (K7: a flagged slot its decode).
//           With at most R rows it folds the rows in row order onto the seed and
//           writes the cell. A longer segment
//           is spread over the card: its chunks (the first in block s, the others in
//           the blocks past S) fold into partials in the accumulator type, and the last
//           block of a (segment, tile) to finish, found by an integer counter behind
//           __threadfence(), folds the partials in chunk order, then the seed, and
//           writes the cells.
//
// No float atomics, and the fold order is fixed by the data and R alone, so float
// sums are the same on every run, and a K7 step equals a K6 step on a state decoded
// beforehand, bit for bit. Min and max propagate NaN; int32 sums wrap; bf16 sums
// accumulate in f32 (partials too) and round once before the add to the state, as K1
// does. Out-of-range unmasked ids drop, as the TPU kernel's ids == s compare drops
// them (the JAX package's plain .at[ids] path would wrap a negative id instead).
//
// What bounds it on an H100: bytes. The rows are read once, the (S, F) state read and
// written once (plus codes and scales for K7); the work is one add or compare per row
// element. The engines send one-stream steps, every live row in one segment: the sort
// is then a few 32-row rounds per warp, and the one long segment is folded by
// ceil(rows / 64) blocks per column tile instead of one thread per column walking every
// row. At the paged engine's shapes (S = 128 slots of 3000 f32 columns, at most 64 rows)
// no segment is long, no block past S is launched, and the state dominates: 3 MB in and
// out, ~1 us at HBM rate, against the two launches, whose latencies the early launch of
// pass 1 overlaps.
#include <algorithm>

#include "reduce.cuh"

namespace {

using namespace reduce;

constexpr int MIXED = 3;             // op row not uniform: per-column op
constexpr int TILE = 128;            // columns per pass-1 block
constexpr int R = 64;                // rows per chunk of a long segment
constexpr int SORT_THREADS = 1024;   // pass 0's one block
constexpr int WARPS = SORT_THREADS / 32;
constexpr int STAGE_ROWS = 4096;     // rows whose bins pass 0 keeps in shared memory (16 KB)
constexpr int SHARED_TABLE = 7680;   // (bin, warp) entries kept in shared memory (30 KB)

// Where the passes find their parts of the one int32 scratch buffer the wrapper
// allocates (segment_scratch_ints gives its size), in int32 units.
struct Layout {
  int tiles, max_extra, max_long, warps;
  bool table_shared;
  int64_t info, items, offsets, meta, order, counters, table, partials, total;
  Layout(int n, int s, int f) {
    tiles = (f + TILE - 1) / TILE;
    max_extra = n > 0 ? (n - 1) / R : 0;  // chunks past the first, over all segments
    max_long = n / (R + 1);               // segments of more than R rows
    warps = std::min(WARPS, std::max(1, (n + 31) / 32));
    table_shared = (int64_t)warps * s <= SHARED_TABLE;
    int64_t at = 0;
    info = at, at += 2 * (int64_t)s;  // int2 per long segment: its counter row, first partial
    items = at, at += 2 * (int64_t)max_extra;  // int2 per chunk past the first: segment, chunk
    offsets = at, at += (int64_t)s + 1;
    meta = at, at += 1;  // the number of chunks past the first
    order = at, at += std::max(n, 1);
    counters = at, at += (int64_t)max_long * tiles;
    table = at, at += table_shared ? 0 : (int64_t)warps * s;
    partials = at, at += (int64_t)(max_extra + max_long) * f;
    total = at;
  }
};

struct Scratch {
  int2* info;
  int2* items;
  int32_t* offsets;  // S + 1: offsets[k] is the first position of segment k in order
  int32_t* meta;
  int32_t* order;
  int32_t* counters;
  int32_t* table;  // null: the table lives in shared memory
  void* partials;  // the accumulator type: f32 for float states, int32 for int32
};

__device__ __forceinline__ int row_bin(const int32_t* ids, const int32_t* mask, int r, int s) {
  if (mask[r] == 0) return -1;  // test the mask before the id is trusted
  const int id = ids[r];
  return (id >= 0 && id < s) ? id : -1;
}

// The exclusive prefix of v over the block's 1024 threads in thread order; *total gets
// the sum. Every thread of the block calls it.
__device__ long long block_exclusive_scan(long long v, long long* total) {
  __shared__ long long warp_part[WARPS];
  __shared__ long long sum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += t;
  }
  __syncthreads();  // an earlier call's readers are done with warp_part
  if (lane == 31) warp_part[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long x = warp_part[lane];
    long long xi = x;
    for (int d = 1; d < 32; d <<= 1) {
      const long long t = __shfl_up_sync(0xffffffffu, xi, d);
      if (lane >= d) xi += t;
    }
    warp_part[lane] = xi - x;
    if (lane == 31) sum = xi;
  }
  __syncthreads();
  *total = sum;
  return warp_part[warp] + incl - v;
}

__global__ void __launch_bounds__(SORT_THREADS)
sort_rows(const int32_t* __restrict__ ids, const int32_t* __restrict__ mask, int n, int s,
          int warps, int tiles, Scratch sc) {
  // pass 1 may launch now: its blocks read their state tiles while this block sorts
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ int32_t smem[];
  int32_t* table = sc.table != nullptr ? sc.table : smem;
  int32_t* stage = sc.table != nullptr ? smem : smem + warps * s;
  const bool staged = n <= STAGE_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int entries = warps * s;
  for (int i = tid; i < entries; i += SORT_THREADS) table[i] = 0;
  if (staged)
    for (int r = tid; r < n; r += SORT_THREADS) stage[r] = row_bin(ids, mask, r, s);
  __syncthreads();

  // warp w owns rows [r0, r1): whole 32-row chunks but for the last
  const int span = ((n + warps - 1) / warps + 31) & ~31;
  const int r0 = warp * span, r1 = warp < warps ? min(n, r0 + span) : 0;
  for (int base = r0; base < r1; base += 32) {  // count: one add per distinct bin per chunk
    const int r = base + lane;
    const int bin = r < r1 ? (staged ? stage[r] : row_bin(ids, mask, r, s)) : -1;
    const unsigned live = __ballot_sync(0xffffffffu, bin >= 0);
    if (bin >= 0) {
      const unsigned peers = __match_any_sync(live, bin);
      if (lane == __ffs(peers) - 1) table[bin * warps + warp] += __popc(peers);
    }
    __syncwarp();
  }
  __syncthreads();

  // exclusive scan of the table in (bin, warp) order: entry (b, w) becomes the position
  // of warp w's first row of bin b
  const int per = (entries + SORT_THREADS - 1) / SORT_THREADS;
  const int a = min(entries, tid * per), b = min(entries, a + per);
  long long part = 0;
  for (int i = a; i < b; ++i) part += table[i];
  long long live_rows;
  long long run = block_exclusive_scan(part, &live_rows);
  for (int i = a; i < b; ++i) {
    const int t = table[i];
    table[i] = (int)run;
    run += t;
  }
  __syncthreads();

  // segment offsets, and the chunks of the long segments: each thread a range of segments
  const int per_seg = (s + SORT_THREADS - 1) / SORT_THREADS;
  const int g0 = min(s, tid * per_seg), g1 = min(s, g0 + per_seg);
  auto length = [&](int g) {
    return (g + 1 < s ? table[(g + 1) * warps] : (int)live_rows) - table[g * warps];
  };
  long long mine = 0;  // (chunks << 32) + 1 for each long segment
  for (int g = g0; g < g1; ++g) {
    sc.offsets[g] = table[g * warps];
    const int len = length(g);
    if (len > R) mine += ((long long)((len + R - 1) / R) << 32) + 1;
  }
  if (tid == 0) sc.offsets[s] = (int)live_rows;
  long long totals;
  long long before = block_exclusive_scan(mine, &totals);
  for (int g = g0; g < g1; ++g) {
    const int len = length(g);
    if (len <= R) continue;
    const int counter_row = (int)(before & 0xffffffffll), first = (int)(before >> 32);
    const int chunks = (len + R - 1) / R;
    sc.info[g] = make_int2(counter_row, first);
    for (int c = 1; c < chunks; ++c) sc.items[first - counter_row + c - 1] = make_int2(g, c);
    before += ((long long)chunks << 32) + 1;
  }
  const int long_segments = (int)(totals & 0xffffffffll);
  if (tid == 0) *sc.meta = (int)(totals >> 32) - long_segments;
  for (int i = tid; i < long_segments * tiles; i += SORT_THREADS) sc.counters[i] = 0;
  __syncthreads();  // every read of the scanned table is done before the scatter moves it

  for (int base = r0; base < r1; base += 32) {  // stable scatter, 32 rows at a time
    const int r = base + lane;
    const int bin = r < r1 ? (staged ? stage[r] : row_bin(ids, mask, r, s)) : -1;
    const unsigned live = __ballot_sync(0xffffffffu, bin >= 0);
    unsigned peers = 0;
    if (bin >= 0) {
      peers = __match_any_sync(live, bin);
      // a row's rank among the earlier rows of its bin in this chunk keeps row order
      sc.order[table[bin * warps + warp] + __popc(peers & ((1u << lane) - 1u))] = r;
    }
    __syncwarp();  // every lane has read its cursor before the leader moves it
    if (bin >= 0 && lane == __ffs(peers) - 1) table[bin * warps + warp] += __popc(peers);
    __syncwarp();
  }
}

template <typename T, int FX>
__device__ __forceinline__ typename AccOf<T>::type fold_rows(const T* __restrict__ rows,
                                                             const int32_t* idx, int cnt, int f,
                                                             int c) {
  using A = typename AccOf<T>::type;
  A acc = identity<A, FX>();
#pragma unroll 16
  for (int i = 0; i < cnt; ++i) acc = combine<FX>(acc, to_acc(rows[(int64_t)idx[i] * f + c]));
  return acc;
}

// partials other blocks wrote: read through L2 (__ldcg), never a stale L1 line
template <typename A, int FX>
__device__ __forceinline__ A fold_partials(const A* partials, int first, int cnt, int f, int c) {
  A acc = identity<A, FX>();
#pragma unroll 16
  for (int k = 0; k < cnt; ++k) acc = combine<FX>(acc, __ldcg(partials + (int64_t)(first + k) * f + c));
  return acc;
}

template <typename T>
__device__ __forceinline__ typename AccOf<T>::type fold_rows_op(int op, const T* __restrict__ rows,
                                                                const int32_t* idx, int cnt, int f,
                                                                int c) {
  switch (op) {
    case SUM: return fold_rows<T, SUM>(rows, idx, cnt, f, c);
    case MIN: return fold_rows<T, MIN>(rows, idx, cnt, f, c);
    default: return fold_rows<T, MAX>(rows, idx, cnt, f, c);
  }
}

template <typename A>
__device__ __forceinline__ A fold_partials_op(int op, const A* partials, int first, int cnt, int f,
                                              int c) {
  switch (op) {
    case SUM: return fold_partials<A, SUM>(partials, first, cnt, f, c);
    case MIN: return fold_partials<A, MIN>(partials, first, cnt, f, c);
    default: return fold_partials<A, MAX>(partials, first, cnt, f, c);
  }
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

// a cell's state before the fold: K7 first decodes a flagged slot's quantized columns
template <typename T, bool Q8>
__device__ __forceinline__ T seed_of(const T* __restrict__ state, const int32_t* __restrict__ flags,
                                     const int8_t* __restrict__ codes,
                                     const float* __restrict__ scales,
                                     const int32_t* __restrict__ qcol, int seg, int c, int64_t cell) {
  T v = state[cell];
  if constexpr (Q8) {
    if (flags[seg] != 0 && qcol[c] != 0) v = decode(codes[cell], scales[cell], v);
  }
  return v;
}

template <typename T, int UNI, bool Q8>
__global__ void __launch_bounds__(TILE)
segment_fold(const T* __restrict__ state, const T* __restrict__ rows,
             const int32_t* __restrict__ ops, const int32_t* __restrict__ flags,
             const int8_t* __restrict__ codes, const float* __restrict__ scales,
             const int32_t* __restrict__ qcol, Scratch sc, T* __restrict__ out, int f, int s,
             int tiles, bool vec) {
  using A = typename AccOf<T>::type;
  __shared__ int32_t idx[R];
  __shared__ bool last;
  const int col0 = blockIdx.y * TILE, c = col0 + threadIdx.x;
  const bool on = c < f;
  const int n16 = min(TILE, f - col0) * (int)sizeof(T) / 16;  // the tile in 16-byte vectors

  // launched early (programmatic dependent launch): first read what pass 0 does not
  // write, block s's seed (K7: its decode) and, for a copy, its state tile
  int seg = blockIdx.x, chunk = 0;
  T seed{};
  uint4 tile16{};
  if (seg < s) {
    if (on) seed = seed_of<T, Q8>(state, flags, codes, scales, qcol, seg, c, (int64_t)seg * f + c);
    if (vec && threadIdx.x < n16)
      tile16 = reinterpret_cast<const uint4*>(state + (int64_t)seg * f + col0)[threadIdx.x];
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // pass 0's results are visible from here

  if (seg >= s) {  // a chunk past the first of a long segment, if this step has one
    const int k = seg - s;
    if (k >= *sc.meta) return;
    const int2 item = sc.items[k];
    seg = item.x, chunk = item.y;
  }
  const int64_t cell = (int64_t)seg * f + c;
  const int lo = sc.offsets[seg], len = sc.offsets[seg + 1] - lo;

  if (len == 0) {  // untouched: its seed as it is, the state tile itself unless K7 decoded it
    if (vec && !(Q8 && flags[seg] != 0)) {
      if (threadIdx.x < n16) reinterpret_cast<uint4*>(out + (int64_t)seg * f + col0)[threadIdx.x] = tile16;
    } else if (on) {
      out[cell] = seed;
    }
    return;
  }

  const int a = lo + chunk * R, cnt = min(R, lo + len - a);
  for (int i = threadIdx.x; i < cnt; i += TILE) idx[i] = sc.order[a + i];
  __syncthreads();
  const int op = UNI == MIXED ? (on ? ops[c] : SUM) : UNI;
  A acc = on ? fold_rows_op<T>(op, rows, idx, cnt, f, c) : identity<A, SUM>();
  if (len <= R) {
    if (on) out[cell] = store_op(op, seed, acc);
    return;
  }

  // a long segment: publish this chunk's partial; the tile's last chunk to finish folds
  const int2 info = sc.info[seg];  // counter row, first partial
  A* partials = static_cast<A*>(sc.partials);
  if (on) partials[(int64_t)(info.y + chunk) * f + c] = acc;
  __threadfence();  // the partial is visible card-wide before the counter says so
  __syncthreads();
  const int chunks = (len + R - 1) / R;
  if (threadIdx.x == 0) last = atomicAdd(&sc.counters[info.x * tiles + blockIdx.y], 1) == chunks - 1;
  __syncthreads();
  if (!last || !on) return;
  __threadfence();
  if (chunk != 0)  // the seed read before the wait was segment blockIdx.x's, not seg's
    seed = seed_of<T, Q8>(state, flags, codes, scales, qcol, seg, c, cell);
  out[cell] = store_op(op, seed, fold_partials_op<A>(op, partials, info.y, chunks, f, c));
}

struct Args {
  const void* state;
  const void* rows;
  const int32_t* ops;
  const int32_t* flags;
  const int8_t* codes;
  const float* scales;
  const int32_t* qcol;
  Scratch sc;
  void* out;
  int f, s, tiles, blocks;
  bool vec;
};

// pass 1 goes out with programmatic stream serialization: its blocks may start before
// pass 0 ends and wait for its results at griddepcontrol.wait
template <typename T, int UNI, bool Q8>
cudaError_t launch_fold(const Args& a, cudaStream_t stream) {
  const bool vec = a.vec && ((int64_t)a.f * sizeof(T)) % 16 == 0;
  cudaLaunchAttribute early;
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks, a.tiles);
  cfg.blockDim = dim3(TILE);
  cfg.stream = stream;
  cfg.attrs = &early;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, segment_fold<T, UNI, Q8>, static_cast<const T*>(a.state),
                            static_cast<const T*>(a.rows), a.ops, a.flags, a.codes, a.scales,
                            a.qcol, a.sc, static_cast<T*>(a.out), a.f, a.s, a.tiles, vec);
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

// The int32 scratch elements segment_fold needs for N rows, S segments and F columns.
extern "C" int64_t segment_scratch_ints(int n, int s, int f) { return Layout(n, s, f).total; }

// state, out (S, F) and rows (N, F) share the dtype; ids, mask (N,) int32; ops (F,)
// int32, read only when uniform == 3 (mixed). flags (S,) int32, codes (S, F) int8,
// scales (S, F) f32 and qcol (F,) int32 are all null (K4, K6) or all given (K7, float
// dtypes only). scratch: segment_scratch_ints(n, s, f) int32 elements, any contents.
extern "C" int segment_fold(const void* state, const void* rows, const void* ids,
                            const void* mask, const void* ops, const void* flags,
                            const void* codes, const void* scales, const void* qcol,
                            void* scratch, void* out, int n, int f, int s, int dtype,
                            int uniform, void* stream) {
  const bool q8 = flags != nullptr;
  const Layout lay(n, s, f);
  if (f <= 0 || s <= 0 || n < 0 || lay.tiles > 65535 || (uniform == MIXED && ops == nullptr) ||
      scratch == nullptr ||
      (q8 && (codes == nullptr || scales == nullptr || qcol == nullptr || dtype == I32)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* base = static_cast<int32_t*>(scratch);
  const Scratch sc{reinterpret_cast<int2*>(base + lay.info), reinterpret_cast<int2*>(base + lay.items),
                   base + lay.offsets, base + lay.meta, base + lay.order, base + lay.counters,
                   lay.table_shared ? nullptr : base + lay.table, base + lay.partials};
  const size_t shared = ((lay.table_shared ? (size_t)lay.warps * s : 0) +
                         (n <= STAGE_ROWS ? (size_t)n : 0)) * sizeof(int32_t);
  sort_rows<<<1, SORT_THREADS, shared, st>>>(static_cast<const int32_t*>(ids),
                                              static_cast<const int32_t*>(mask), n, s, lay.warps,
                                              lay.tiles, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const bool aligned = ((reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  Args a{state, rows, static_cast<const int32_t*>(ops), static_cast<const int32_t*>(flags),
         static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
         static_cast<const int32_t*>(qcol), sc, out, f, s, lay.tiles, s + lay.max_extra, aligned};
  switch (dtype) {
    case F32: return (int)(q8 ? launch_op<float, true>(uniform, a, st)
                              : launch_op<float, false>(uniform, a, st));
    case BF16: return (int)(q8 ? launch_op<__nv_bfloat16, true>(uniform, a, st)
                               : launch_op<__nv_bfloat16, false>(uniform, a, st));
    case I32: return (int)launch_op<int32_t, false>(uniform, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
