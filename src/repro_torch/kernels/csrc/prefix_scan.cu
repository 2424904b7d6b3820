// K3 — c3_prefixsum, the row-wise inclusive prefix sum, for Hopper (sm_90a),
// as a single-pass chained scan with decoupled look-back.
//
// Replaces the Pallas kernel
//   K3  src/repro/kernels/prefix_scan.py  prefix_sum_pallas  (_prefix_body)
// which walks each row's column blocks in grid order with the running total
// in VMEM scratch. On the H100 blocks run in no order and nothing carries
// from one to the next, so a long row is cut into tiles that are scanned
// in parallel and chained through per-tile state in device memory.
//
// What bounds it on the H100: device-memory bytes (the input read once, the
// output written once; one add per element). A one-row operand must spread
// over all 132 SMs, which a walk along the row cannot do.
//
// The design:
//
//  * Tiles. A tile is one row's run of up to TILE = 4096 columns (the
//    wrapper's `block_shape` column block for long rows). 256 threads, 16
//    consecutive items each. Loads and stores go through shared memory so
//    that device memory is read and written coalesced, 16 bytes a thread
//    where the row's base allows it and element by element otherwise; one
//    chunk of padding every 8 keeps the per-thread reads free of bank
//    conflicts. The ragged last tile of a row is masked (reads 0).
//  * In-tile scan, in the accumulator type A (float for float32, float16 and
//    bfloat16; double for float64): each thread scans its 16 items serially
//    (15 adds), the lanes scan the thread totals with shuffles (5 levels),
//    each warp scans the 8 warp totals (3 levels); a thread's offset is its
//    lane prefix plus its warp prefix (1 add), added to each item (1 add).
//    So no element passes through more than D_TILE = 25 adds on its way to
//    a tile-local prefix (23 on the way to the tile's aggregate).
//  * Two modes, chosen by the launcher from the shape:
//    - look-back (rows < 2 × SMs, as the prefix-sum app's single row): one
//      tile a block. Each block takes its tile from a global atomicAdd
//      counter, not from blockIdx, so every tile it waits on belongs to a
//      block that is already running (blocks are not scheduled in index
//      order, and a block spinning on one that was never scheduled would
//      deadlock). The first tile of a row publishes its inclusive prefix
//      at once; every other tile publishes its aggregate, then its first
//      warp reads 32 predecessor states of the same row at a time (lane
//      i: tile t-1-i), spins until all are valid, keeps the lanes up to
//      the nearest inclusive prefix and sums them with a shuffle
//      butterfly, moving back 32 tiles while none is inclusive; then it
//      publishes its own inclusive prefix. The look-back sums in double
//      for every type, so its roundings (at most 2^-53 relative) are
//      negligible against float32's and do not grow with its depth, which
//      depends on timing; the tile's exclusive prefix is rounded to A once.
//      A tile's state (scratch the wrapper zero-fills, 8 bytes a tile, as
//      k3_scratch_words says; the walk needs none) is one word: the double
//      value with its two lowest mantissa bits replaced by the status
//      (0 invalid, 1 aggregate, 2 inclusive), so a single store publishes
//      both and a single load reads both.
//    - walk (rows >= 2 × SMs, as the MoE router's 384 rows): one block a
//      row, its tiles in order with the running total in A, the next
//      tile's chunks loaded into registers while the current one is
//      scanned. There are rows enough to fill the card, and a walk keeps
//      every block's loads streaming where a tile per block idles between
//      them (measured on the H100: 0.044 against 0.053 ms at (384, 32768)).
//  * Output: y_i = (local_i + offset) + exclusive prefix (the look-back's,
//    or the walk's running total), rounded once to T.
//
// First-order error bound of both modes (the wrapper's
// `k3_bound_constants`), against the exact prefix y_i, eps = the unit of
// the output type (16-bit outputs: their own eps, looser than float32's):
//   A = float: eps·((D_TILE + 1)·Σ_{j≤i}|x_j| + Σ_{e<i}|y_e| + |y_i|),
//     e over the ends of the row's earlier tiles: the exclusive prefix is
//     rounded once from double near y at the previous tile's end (the
//     walk's running total rounds once a tile, near y at each tile's end);
//     the +1 absorbs every double rounding of the look-back and the status
//     bits (at most 3·2^-52 of an inclusive prefix);
//   A = double: the look-back itself rounds in double: its butterfly adds
//     5 levels and each further window one add on the way, and the status
//     bits take up to 3 units of the last place from each published value
//     (an aggregate: on Σ|x|; an inclusive prefix: on y_e), so
//     eps·((D_TILE + 8 + max(0, W − 2))·Σ_{j≤i}|x_j| + 4·Σ_{e<i}|y_e|
//     + |y_i|) with W = ⌈tiles per row / 32⌉, the most windows a
//     look-back can read.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                      // consecutive items a thread
constexpr int TILE = THREADS * ITEMS;          // 4096 columns
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long ST_AGG = 1, ST_INCL = 2;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename T>
__device__ __forceinline__ typename Acc<T>::type to_acc(T v) { return v; }
template <>
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_acc(typename Acc<T>::type v) { return v; }
template <>
__device__ __forceinline__ __half from_acc<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ __half zero<__half>() {
  return __float2half_rn(0.f);
}
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// the padded shared-memory slot of 16-byte chunk c: one spare every 8
__device__ __forceinline__ int pad(int c) { return c + (c >> 3); }

// A tile's state is one 64-bit word: a double value whose two lowest
// mantissa bits are replaced by the status (0 invalid, 1 aggregate,
// 2 inclusive prefix). One store publishes both and one load reads both,
// so no ordering between two words is needed; the value loses at most
// 3·2^-52 of itself (nothing at all for an aggregate of float32 values).
__device__ __forceinline__ unsigned long long pack_state(
    double v, unsigned long long s) {
  return ((unsigned long long)__double_as_longlong(v) & ~3ULL) | s;
}
__device__ __forceinline__ double state_value(unsigned long long w) {
  return __longlong_as_double((long long)(w & ~3ULL));
}
__device__ __forceinline__ unsigned long long load_state(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_state(unsigned long long* p,
                                            unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

template <typename T>
__host__ __device__ constexpr int buf_elems() {  // one padded tile
  return (TILE / (16 / (int)sizeof(T))) * 9 / 8 * (16 / (int)sizeof(T));
}

// A tile of shared memory, with the per-warp totals of its scan.
template <typename T>
struct Smem {
  __align__(16) unsigned char bytes[buf_elems<T>() * sizeof(T)];
  __device__ __forceinline__ T* buf() { return reinterpret_cast<T*>(bytes); }
  typename Acc<T>::type warp_tot[WARPS];
  typename Acc<T>::type excl;
  long long tile;
};

// The in-tile scan of the tile in ``buf``: each thread's 16 consecutive
// items scanned serially (15 adds) into v; ``off``, the thread's offset
// in the tile (lane prefix + warp prefix: 5 + 3 levels + 1 add); the
// tile's aggregate (23 adds deep). One __syncthreads inside.
template <typename T>
__device__ __forceinline__ void scan_tile(Smem<T>& sm,
                                          typename Acc<T>::type (&v)[ITEMS],
                                          typename Acc<T>::type& off,
                                          typename Acc<T>::type& agg) {
  using A = typename Acc<T>::type;
  constexpr int VEC = 16 / sizeof(T), CPT = ITEMS / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int w = 0; w < VEC; ++w)
      v[j * VEC + w] = to_acc(sm.buf()[pad(CPT * tid + j) * VEC + w]);
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) v[i] += v[i - 1];
  // the lanes' totals: inclusive Hillis–Steele over the warp
  A inc = v[ITEMS - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    A y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  A lane_excl = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) lane_excl = A(0);
  if (lane == 31) sm.warp_tot[warp] = inc;
  __syncthreads();
  // the warps' totals, scanned by every warp alike (3 levels over lanes
  // 0-7): this warp's prefix and the tile's aggregate
  A wv = lane < WARPS ? sm.warp_tot[lane] : A(0);
#pragma unroll
  for (int d = 1; d < WARPS; d <<= 1) {
    A y = __shfl_up_sync(FULL, wv, d);
    if (lane >= d) wv += y;
  }
  agg = __shfl_sync(FULL, wv, WARPS - 1);
  A warp_excl = __shfl_sync(FULL, wv, (warp + WARPS - 1) % WARPS);
  if (warp == 0) warp_excl = A(0);
  off = lane_excl + warp_excl;
}

// n columns of a tile from device memory into buf: 16-byte chunks where
// the tile is whole and aligned, element by element (masked) otherwise
template <typename T>
__device__ __forceinline__ void load_tile(Smem<T>& sm, const T* xr, int n,
                                          bool vec) {
  constexpr int VEC = 16 / sizeof(T), CPT = ITEMS / VEC;
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = k * THREADS + tid;
      *reinterpret_cast<uint4*>(&sm.buf()[pad(c) * VEC]) =
          __ldg(reinterpret_cast<const uint4*>(xr) + c);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = k * THREADS + tid;
      sm.buf()[pad(e / VEC) * VEC + e % VEC] = e < n ? xr[e] : zero<T>();
    }
  }
}

// y = (local prefix + offset) + exclusive prefix, rounded once to T and
// stored through shared memory (one __syncthreads inside; buf is busy
// until the next one)
template <typename T>
__device__ __forceinline__ void store_tile(
    Smem<T>& sm, T* orow, int n, bool vec,
    const typename Acc<T>::type (&v)[ITEMS], typename Acc<T>::type off,
    typename Acc<T>::type excl) {
  constexpr int VEC = 16 / sizeof(T), CPT = ITEMS / VEC;
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int w = 0; w < VEC; ++w)
      sm.buf()[pad(CPT * tid + j) * VEC + w] =
          from_acc<T>((v[j * VEC + w] + off) + excl);
  __syncthreads();
  if (vec) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = k * THREADS + tid;
      reinterpret_cast<uint4*>(orow)[c] =
          *reinterpret_cast<const uint4*>(&sm.buf()[pad(c) * VEC]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int e = k * THREADS + tid;
      if (e < n) orow[e] = sm.buf()[pad(e / VEC) * VEC + e % VEC];
    }
  }
}

template <typename T>
__host__ __device__ constexpr int lookback_blocks() {   // resident an SM
  // 6 of 256 threads (40 registers, no spills) ran faster on the H100
  // than 8 (32 registers, spilling) or 4
  return sizeof(T) == 8 ? 4 : 6;
}

// Look-back mode: one tile a block, taken from the counter.
template <typename T>
__global__ void __launch_bounds__(THREADS, lookback_blocks<T>())
k3_scan_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t cols,
               int64_t stride, int64_t tiles_per_row,
               unsigned long long* counter, unsigned long long* state,
               int vec_in, int vec_out) {
  using A = typename Acc<T>::type;
  __shared__ Smem<T> sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sm.tile = (long long)atomicAdd(counter, 1ULL);
  __syncthreads();
  const long long tile = sm.tile;
  const int64_t row = tile / tiles_per_row, t = tile % tiles_per_row;
  const int n = (int)min((int64_t)TILE, cols - t * TILE);
  const T* xr = x + row * stride + t * TILE;
  load_tile(sm, xr, n, n == TILE && vec_in);
  __syncthreads();
  A v[ITEMS], off, agg;
  scan_tile(sm, v, off, agg);

  // publish, then look back (warp 0)
  if (warp == 0) {
    const int64_t first = row * tiles_per_row;   // the row's tile 0
    if (t == 0) {
      if (lane == 0) {
        store_state(&state[tile], pack_state((double)agg, ST_INCL));
        sm.excl = A(0);
      }
    } else {
      if (lane == 0)
        store_state(&state[tile], pack_state((double)agg, ST_AGG));
      double excl = 0.0;
      for (int64_t back = t - 1;; back -= 32) {
        const int64_t p = back - lane;           // within the row
        unsigned long long w = ST_INCL;          // before the row: 0
        if (p >= 0) {
          do {
            w = load_state(&state[first + p]);
          } while ((w & 3) == 0);
        }
        const unsigned incl = __ballot_sync(FULL, (w & 3) == ST_INCL);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        double sum = lane <= stop ? state_value(w) : 0.0;
#pragma unroll
        for (int d = 16; d >= 1; d >>= 1)
          sum += __shfl_xor_sync(FULL, sum, d);
        excl += sum;
        if (incl) break;
      }
      if (lane == 0) {
        store_state(&state[tile], pack_state(excl + (double)agg, ST_INCL));
        sm.excl = (A)excl;
      }
    }
  }
  __syncthreads();
  store_tile(sm, out + row * cols + t * TILE, n, n == TILE && vec_out, v,
             off, sm.excl);
}

// Walk mode, for operands of enough rows to fill the card: one block a
// row (striding over rows), its tiles in order with the running total in
// registers, the next tile's 16-byte chunks loaded into registers while
// the current one is scanned. y = local + carry; carry += aggregate: the
// carry rounds once a tile, near y at the tile's end, as the look-back's
// exclusive prefix does.
template <typename T>
__global__ void __launch_bounds__(THREADS, sizeof(T) == 8 ? 2 : 4)
k3_walk_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t rows,
               int64_t cols, int64_t stride, int64_t tiles_per_row,
               int vec_in, int vec_out) {
  using A = typename Acc<T>::type;
  constexpr int VEC = 16 / sizeof(T), CPT = ITEMS / VEC;
  __shared__ Smem<T> sm;
  const int tid = threadIdx.x;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xrow = x + row * stride;
    T* orow = out + row * cols;
    uint4 next[CPT];
    bool have = TILE <= cols && vec_in;          // tile 0 prefetched
    if (have)
#pragma unroll
      for (int k = 0; k < CPT; ++k)
        next[k] = __ldg(reinterpret_cast<const uint4*>(xrow) + k * THREADS +
                        tid);
    A carry = A(0);
    for (int64_t t = 0; t < tiles_per_row; ++t) {
      const int n = (int)min((int64_t)TILE, cols - t * TILE);
      if (have) {
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          *reinterpret_cast<uint4*>(
              &sm.buf()[pad(k * THREADS + tid) * VEC]) = next[k];
      } else {
        load_tile(sm, xrow + t * TILE, n, false);
      }
      __syncthreads();
      have = (t + 2) * TILE <= cols && vec_in;   // tile t + 1, whole
      if (have)
#pragma unroll
        for (int k = 0; k < CPT; ++k)
          next[k] = __ldg(reinterpret_cast<const uint4*>(
                              xrow + (t + 1) * TILE) + k * THREADS + tid);
      A v[ITEMS], off, agg;
      scan_tile(sm, v, off, agg);
      store_tile(sm, orow + t * TILE, n, n == TILE && vec_out, v, off, carry);
      carry += agg;
      __syncthreads();                           // buf is free again
    }
  }
}

// The card's SMs, queried once.
int card_sms(int* sms) {
  static int cached = 0;
  if (!cached) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = cached;
  return 0;
}

// The zeroed 8-byte scratch words the launch of a (rows, cols) operand
// needs: for the look-back the tile counter and one state word a tile, for
// the walk (rows >= 2 × SMs and more than one tile a row) none.
int scratch_words(int64_t rows, int64_t cols, int64_t* words) {
  int sms = 0;
  if (int err = card_sms(&sms)) return err;
  const int64_t tpr = (cols + TILE - 1) / TILE;
  *words = rows >= 2 * sms && tpr > 1 ? 0 : 1 + rows * tpr;
  return 0;
}

template <typename T>
int launch(const void* x, void* out, int64_t rows, int64_t cols,
           int64_t stride, void* scratch, cudaStream_t s) {
  const int64_t tpr = (cols + TILE - 1) / TILE;
  const int64_t tiles = rows * tpr;
  if (tiles >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  int64_t words = 0;
  if (int err = scratch_words(rows, cols, &words)) return err;
  const int vec_in = ((uintptr_t)x % 16 == 0) &&
                     ((stride * (int64_t)sizeof(T)) % 16 == 0);
  const int vec_out = ((uintptr_t)out % 16 == 0) &&
                      ((cols * (int64_t)sizeof(T)) % 16 == 0);
  if (words == 0) {
    int sms = 0;
    card_sms(&sms);                            // cached by scratch_words
    const int64_t blocks = rows < 4 * sms ? rows : 4 * sms;
    k3_walk_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const T*)x, (T*)out, rows, cols, stride, tpr, vec_in, vec_out);
  } else {
    if (!scratch) return (int)cudaErrorInvalidValue;
    // scratch: [counter][state × tiles], 8 bytes each
    unsigned long long* base = (unsigned long long*)scratch;
    k3_scan_kernel<T><<<(unsigned)tiles, THREADS, 0, s>>>(
        (const T*)x, (T*)out, cols, stride, tpr, base, base + 1, vec_in,
        vec_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ===========================================================================
// K4 — c4_chunkscan / c4_statescan, the affine carried scan
//   y[c] = a[c]·y[c−1] + b[c], y[−1] = 0, along the chunks
// ===========================================================================
//
// Replaces the Pallas kernel
//   K4  src/repro/kernels/prefix_scan.py  chunk_scan_pallas  (_chunk_body)
// which walks each row's column blocks in grid order, scans a block with
// an affine Hillis–Steele network and carries y's last column in VMEM.
//
// What bounds it on the H100: device-memory bytes (the states read once
// and written once; two operations an element). The recurrence is the
// same two operations whatever the order, so a thread folds its own
// payload elements along the chunks in registers: no tree, no shared-
// memory transpose. The fold is the recurrence as the reference's oracle
// defines it (src/repro/kernels/ref.py, chunk_scan), one product and one
// add an element, each rounded in the output type T (no FMA contraction:
// __fmul_rn / __fadd_rn), the order torch evaluates a * y + b in, so the
// plain walk (prefix_scan.chunk_scan_plain up to 64 columns,
// state_scan_plain) is the kernel's result bit for bit.
//
// Two entries, one fold:
//  * k4_state_kernel, on the SSD states where they lie (c4_statescan):
//    group g = (o, ai) is `rows` contiguous payload elements that share
//    one decay a[o, c, ai] per chunk, its chunk c at stride `inner`.
//    A thread owns VEC contiguous payload elements (16 or 8 bytes, as the
//    wrapper's state_walk chooses), neighbouring threads neighbouring
//    vectors, so each chunk's loads and stores are coalesced as they lie;
//    a group's threads are whole warps. The thread keeps a ring of R
//    chunks' loads in flight (R = RING_BYTES of each operand it loads, at
//    least 4: at K's 8 chunks every load is issued before the walk; a
//    ring of 8 16-byte loads at G's 32): the loads of step j + R are
//    issued before step j is folded and stored, so loads and stores
//    stream together.
//    No shared memory and no barrier: a chunk's decay is a warp-uniform
//    load (one transaction a warp, then L1).
//    With DA (the reverse walk of the backward) it also loads y[c−1], the
//    forward's output, and reduces λ[c]·y[c−1] over the warp's elements:
//    each thread its VEC products in order, the warp by an xor butterfly
//    of shuffles; one partial per warp per (group, chunk), no atomics.
//    k4_da_kernel sums a decay's partials in a fixed order (warps, then
//    chunks and groups where the decay is shared along them), so da is
//    the same bits on every run, and prefix_scan.state_da_plain is the
//    same reduction in torch.
//  * k4_rows_kernel, on (rows, cols) operands (c4_chunkscan) of at most
//    FOLD_COLS columns: a lane a row, a warp's 32 rows moved through
//    shared memory in 16-byte chunks (coalesced, the chunks swizzled so
//    that the lanes' walks along their rows hit distinct banks). Up to
//    FOLD_COLS columns (every chunk count of the model paths) the two
//    entries are one fold, bit for bit. Longer rows take the former
//    Gluon kernel of prefix_scan.py: a fold of segments a thread
//    (experiments/k4_rows_fold.cu) was slower there (PERF.md).
// REVERSE walks the chunks (columns) from the last one: step j of the walk
// reads and writes chunk cols−1−j, decays included, in the same order.

namespace k4 {

template <typename T> struct Acc4 { using type = float; };
template <> struct Acc4<double> { using type = double; };

__device__ __forceinline__ float fold(float a, float y, float b) {
  return __fadd_rn(__fmul_rn(a, y), b);
}
__device__ __forceinline__ double fold(double a, double y, double b) {
  return __dadd_rn(__dmul_rn(a, y), b);
}
__device__ __forceinline__ __nv_bfloat16 fold(__nv_bfloat16 a,
                                              __nv_bfloat16 y,
                                              __nv_bfloat16 b) {
  const __nv_bfloat16 p = __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(y)));
  return __float2bfloat16_rn(
      __fadd_rn(__bfloat162float(p), __bfloat162float(b)));
}
__device__ __forceinline__ __half fold(__half a, __half y, __half b) {
  const __half p = __float2half_rn(__fmul_rn(__half2float(a),
                                             __half2float(y)));
  return __float2half_rn(__fadd_rn(__half2float(p), __half2float(b)));
}

__device__ __forceinline__ float mul_acc(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_acc(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_acc(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_acc(double a, double b) {
  return __dadd_rn(a, b);
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// VEC contiguous elements moved as one 16-, 8-, 4- or 2-byte access
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_stream(const T* p) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  const R r = __ldcs(reinterpret_cast<const R*>(p));   // read once: evict first
  Pack<T, VEC> out;
  *reinterpret_cast<R*>(&out) = r;
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& x) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

constexpr int STATE_THREADS = 256;
constexpr int RING_BYTES = 128;   // of each operand in a thread's ring

// The state walk's ring depth: RING_BYTES of each operand a thread loads
// (the states; with DA y too), 4 to 32 chunks (prefix_scan.state_walk).
template <typename T, int VEC, bool DA>
constexpr int ring_depth() {
  constexpr int r = RING_BYTES / (VEC * (int)sizeof(T) * (DA ? 2 : 1));
  return r < 4 ? 4 : (r > 32 ? 32 : r);
}

// One thread: VEC payload elements of group g = t / sp (sp: the group's
// vector slots rounded up to whole warps, so every warp lies in one
// group), all its chunks in walk order. A ring of R chunks' loads (and
// decays; with DA also y[c−1]) is in flight: the loads of step j + R are
// issued before step j is folded, so a thread never waits on the chunk
// it just stored. No shared memory and no barrier: a chunk's decay is
// one warp-uniform load (a broadcast, then L1).
// partials (DA): (groups, cols, sp / 32) in the accumulator type, one a
// warp: its lanes' λ[c]·y[c−1] summed by an xor butterfly.
template <typename T, int VEC, int R, bool DA>
__global__ void __launch_bounds__(STATE_THREADS)
k4_state_kernel(const T* __restrict__ a, const T* __restrict__ s,
                T* __restrict__ out, const T* __restrict__ y,
                typename Acc4<T>::type* __restrict__ partials,
                int64_t threads, int64_t sp, int64_t slots, int64_t rows,
                int64_t cols, int64_t inner, int64_t a_in, int64_t a_div,
                int64_t a_outer, int64_t a_col, int reverse) {
  using A = typename Acc4<T>::type;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;                  // whole warps: sp % 32 == 0
  const int lane = threadIdx.x & 31;
  const int64_t g = t / sp, slot = t % sp;
  const bool active = slot < slots;
  const int64_t o = g / a_in, ai = g % a_in;
  const int64_t base = o * cols * inner + ai * rows + slot * VEC;
  const T* a_g = a + (o / a_div) * a_outer + ai;
  Pack<T, VEC> v[R];
  Pack<T, VEC> yp[DA ? R : 1];
  T dec[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {              // the ring's first R chunks
    if (k < cols) {
      const int64_t p = reverse ? cols - 1 - k : k;
      dec[k] = a_g[p * a_col];
      if (active) {
        v[k] = load_stream<T, VEC>(s + base + p * inner);
        if constexpr (DA) {
          if (p >= 1) yp[k] = load_stream<T, VEC>(y + base + (p - 1) * inner);
        }
      }
    }
  }
  Pack<T, VEC> carry;
#pragma unroll
  for (int e = 0; e < VEC; ++e) carry.v[e] = T(0.0f);
  for (int64_t c0 = 0; c0 < cols; c0 += R) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int64_t j = c0 + k;
      if (j < cols) {                        // uniform in the grid
        const int64_t p = reverse ? cols - 1 - j : j;
        const Pack<T, VEC> cur = v[k];
        const T dk = dec[k];
        Pack<T, VEC> yc;
        if constexpr (DA) yc = yp[k];
        const int64_t jn = j + R;            // refill the slot: step j + R
        if (jn < cols) {
          const int64_t pn = reverse ? cols - 1 - jn : jn;
          dec[k] = a_g[pn * a_col];
          if (active) {
            v[k] = load_stream<T, VEC>(s + base + pn * inner);
            if constexpr (DA) {
              if (pn >= 1)
                yp[k] = load_stream<T, VEC>(y + base + (pn - 1) * inner);
            }
          }
        }
        A part = A(0);
        if (active) {
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            carry.v[e] = fold(dk, carry.v[e], cur.v[e]);
          store<T, VEC>(out + base + p * inner, carry);
          if constexpr (DA) {
            if (p >= 1) {
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                part = add_acc(part, mul_acc(A(carry.v[e]), A(yc.v[e])));
            }
          }
        }
        if constexpr (DA) {
#pragma unroll
          for (int d = 16; d >= 1; d >>= 1)
            part = add_acc(part, __shfl_xor_sync(0xffffffffu, part, d));
          if (lane == 0) partials[(g * cols + p) * (sp / 32) + slot / 32] = part;
        }
      }
    }
  }
}

// da[e] of each decay element e from the partials (wpg a (group, chunk):
// one a warp), in a fixed order: per_chunk (the decay varies along the
// chunks: e = (o, p, ai), one (group, chunk) each) over the warps; else
// (the decay is shared by a_div consecutive groups and all chunks,
// a_in = 1) over the groups, the chunks and the warps.
template <typename T>
__global__ void k4_da_kernel(const typename Acc4<T>::type* __restrict__ part,
                             T* __restrict__ da, int64_t n_e, int64_t cols,
                             int64_t a_in, int64_t a_div, int64_t wpg,
                             int per_chunk) {
  using A = typename Acc4<T>::type;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_e) return;
  A sum = A(0);
  if (per_chunk) {
    const int64_t o = e / (cols * a_in), p = (e / a_in) % cols,
                  ai = e % a_in;
    const A* q = part + ((o * a_in + ai) * cols + p) * wpg;
    for (int64_t w = 0; w < wpg; ++w) sum = add_acc(sum, q[w]);
  } else {
    const A* q = part + e * a_div * cols * wpg;
    for (int64_t i = 0; i < a_div * cols * wpg; ++i) sum = add_acc(sum, q[i]);
  }
  da[e] = from_acc<T>(sum);
}

constexpr int FOLD_COLS = 64;      // prefix_scan.K4_FOLD_COLS

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// (rows, cols) operands of at most FOLD_COLS columns: a warp a block, 32
// rows; a lane folds its row. The warp's rows move through shared memory
// in chunks of VEC elements (16 bytes where the rows allow): coalesced
// loads, BATCH chunks a lane in flight, into a row pitch of `pitch`
// chunks (a power of two), chunk q of row r at r·pitch + (q ^ r mod
// pitch), so that the lanes' walks along their rows hit distinct banks;
// each lane's results go back over its b chunks, then coalesced stores.
template <typename T, int VEC, bool REV>
__global__ void __launch_bounds__(32)
k4_rows_kernel(const T* __restrict__ a, const T* __restrict__ b,
               T* __restrict__ out, int64_t rows, int cols,
               int64_t stride_a, int64_t stride_b, int pitch) {
  using P = Pack<T, VEC>;
  constexpr int BATCH = 8;
  extern __shared__ __align__(16) unsigned char k4_rows_smem[];
  P* sa = reinterpret_cast<P*>(k4_rows_smem);
  P* sb = sa + 32 * pitch;
  const int lane = threadIdx.x, mask = pitch - 1;
  const int64_t row0 = (int64_t)blockIdx.x * 32;
  const int nr = (int)min((int64_t)32, rows - row0);
  const int cpr = cols / VEC, nch = nr * cpr;
  for (int f0 = 0; f0 < nch; f0 += 32 * BATCH) {
    P ra[BATCH], rb[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int f = f0 + i * 32 + lane;
      if (f < nch) {
        const int r = f / cpr, q = f - r * cpr;
        ra[i] = load_pack<T, VEC>(a + (row0 + r) * stride_a + q * VEC);
        rb[i] = load_pack<T, VEC>(b + (row0 + r) * stride_b + q * VEC);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int f = f0 + i * 32 + lane;
      if (f < nch) {
        const int r = f / cpr, q = f - r * cpr;
        sa[r * pitch + (q ^ (r & mask))] = ra[i];
        sb[r * pitch + (q ^ (r & mask))] = rb[i];
      }
    }
  }
  __syncwarp();
  if (lane < nr) {
    T carry = T(0.0f);
    const int base = lane * pitch, sw = lane & mask;
#pragma unroll 4
    for (int j = 0; j < cpr; ++j) {
      const int at = base + ((REV ? cpr - 1 - j : j) ^ sw);
      const P x = sa[at];
      P y = sb[at];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int ee = REV ? VEC - 1 - e : e;
        carry = fold(x.v[ee], carry, y.v[ee]);
        y.v[ee] = carry;
      }
      sb[at] = y;
    }
  }
  __syncwarp();
  for (int f = lane; f < nch; f += 32) {
    const int r = f / cpr, q = f - r * cpr;
    store<T, VEC>(out + (row0 + r) * cols + q * VEC,
                  sb[r * pitch + (q ^ (r & mask))]);
  }
}

template <typename T, int VEC, bool DA>
int launch_state_v(const void* a, const void* s, void* out, const void* y,
                   void* partials, int64_t groups, int64_t sp, int64_t rows,
                   int64_t cols, int64_t inner, int64_t a_in, int64_t a_div,
                   int64_t a_outer, int64_t a_col, int reverse,
                   cudaStream_t st) {
  const int64_t threads = groups * sp;
  const int64_t blocks = (threads + STATE_THREADS - 1) / STATE_THREADS;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  k4_state_kernel<T, VEC, ring_depth<T, VEC, DA>(), DA>
      <<<(unsigned)blocks, STATE_THREADS, 0, st>>>(
          (const T*)a, (const T*)s, (T*)out, (const T*)y,
          (typename Acc4<T>::type*)partials, threads, sp, rows / VEC, rows,
          cols, inner, a_in, a_div, a_outer, a_col, reverse);
  return (int)cudaGetLastError();
}

// vec: 16 or 8 bytes of T, or one element (prefix_scan.state_walk's)
template <typename T, bool DA>
int launch_state(int vec, const void* a, const void* s, void* out,
                 const void* y, void* partials, int64_t groups, int64_t sp,
                 int64_t rows, int64_t cols, int64_t inner, int64_t a_in,
                 int64_t a_div, int64_t a_outer, int64_t a_col, int reverse,
                 cudaStream_t st) {
  constexpr int V16 = 16 / (int)sizeof(T), V8 = 8 / (int)sizeof(T);
#define K4_VEC(V)                                                           \
  return launch_state_v<T, V, DA>(a, s, out, y, partials, groups, sp, rows, \
                                  cols, inner, a_in, a_div, a_outer, a_col, \
                                  reverse, st)
  if (vec == V16) K4_VEC(V16);
  if constexpr (V8 > 1) {
    if (vec == V8) K4_VEC(V8);
  }
  if (vec == 1) K4_VEC(1);
#undef K4_VEC
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_state_t(int da, int vec, const void* a, const void* s, void* out,
                   const void* y, void* partials, int64_t groups, int64_t sp,
                   int64_t rows, int64_t cols, int64_t inner, int64_t a_in,
                   int64_t a_div, int64_t a_outer, int64_t a_col,
                   int reverse, cudaStream_t st) {
  if (rows % vec || sp % 32 || sp * vec < rows)
    return (int)cudaErrorInvalidValue;
  if (da && !(y && partials)) return (int)cudaErrorInvalidValue;
  return da ? launch_state<T, true>(vec, a, s, out, y, partials, groups, sp,
                                    rows, cols, inner, a_in, a_div, a_outer,
                                    a_col, reverse, st)
            : launch_state<T, false>(vec, a, s, out, y, partials, groups,
                                     sp, rows, cols, inner, a_in, a_div,
                                     a_outer, a_col, reverse, st);
}

// vec: 16 bytes of T (cols, both row strides and both pointers aligned
// to it; prefix_scan's ChunkScanKernel checks) or one element; at most
// FOLD_COLS columns (longer rows take the Gluon kernel of prefix_scan.py)
template <typename T>
int launch_rows(int vec, const void* a, const void* b, void* out,
                int64_t rows, int64_t cols, int64_t stride_a,
                int64_t stride_b, int reverse, cudaStream_t st) {
  constexpr int V16 = 16 / (int)sizeof(T);
  if (cols > FOLD_COLS || (vec != V16 && vec != 1) ||
      (vec == V16 && (cols % V16 || stride_a % V16 || stride_b % V16)))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + 31) / 32;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  int pitch = 1;
  while (pitch < cols / vec) pitch *= 2;
#define K4_ROWS(V, R)                                                       \
  k4_rows_kernel<T, V, R><<<(unsigned)blocks, 32,                           \
                            2 * 32 * pitch * sizeof(Pack<T, V>), st>>>(     \
      (const T*)a, (const T*)b, (T*)out, rows, (int)cols, stride_a,         \
      stride_b, pitch)
  if (vec == V16) {
    if (reverse) K4_ROWS(V16, true);
    else K4_ROWS(V16, false);
  } else if constexpr (V16 > 1) {
    if (reverse) K4_ROWS(1, true);
    else K4_ROWS(1, false);
  }
#undef K4_ROWS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_da(const void* part, void* da, int64_t n_e, int64_t cols,
              int64_t a_in, int64_t a_div, int64_t wpg, int per_chunk,
              cudaStream_t st) {
  const int64_t blocks = (n_e + 255) / 256;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  k4_da_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      (const typename Acc4<T>::type*)part, (T*)da, n_e, cols, a_in, a_div,
      wpg, per_chunk);
  return (int)cudaGetLastError();
}

}  // namespace k4

// *words: how many zeroed 8-byte words k3_prefix_sum needs as scratch for
// a (rows, cols) operand (0: it may be null).
extern "C" int k3_scratch_words(int64_t rows, int64_t cols, int64_t* words) {
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  return scratch_words(rows, cols, words);
}

// x (rows, cols) with row stride `stride` (elements) and a unit column
// stride; out (rows, cols) contiguous; scratch: k3_scratch_words zeroed
// 8-byte words. dtype codes: 0 float32, 1 float64, 2 bfloat16, 3 float16.
extern "C" int k3_prefix_sum(int dtype, const void* x, void* out,
                             int64_t rows, int64_t cols, int64_t stride,
                             void* scratch, void* stream) {
  if (rows < 0 || cols < 0 || stride < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch<float>(x, out, rows, cols, stride, scratch, s);
    case 1: return launch<double>(x, out, rows, cols, stride, scratch, s);
    case 2:
      return launch<__nv_bfloat16>(x, out, rows, cols, stride, scratch, s);
    case 3: return launch<__half>(x, out, rows, cols, stride, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K4 on (rows, cols) operands of at most 64 columns, a and b of one
// dtype with row strides stride_a, stride_b (elements) and a unit column
// stride; out contiguous. vec: 16 bytes of elements or 1 (launch_rows).
// dtype codes as K3's.
extern "C" int k4_chunk_scan(int dtype, const void* a, const void* b,
                             void* out, int64_t rows, int64_t cols,
                             int64_t stride_a, int64_t stride_b, int vec,
                             int reverse, void* stream) {
  if (rows < 0 || cols < 0 || stride_a < 0 || stride_b < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define K4_ARGS vec, a, b, out, rows, cols, stride_a, stride_b, reverse, s
  switch (dtype) {
    case 0: return k4::launch_rows<float>(K4_ARGS);
    case 1: return k4::launch_rows<double>(K4_ARGS);
    case 2: return k4::launch_rows<__nv_bfloat16>(K4_ARGS);
    case 3: return k4::launch_rows<__half>(K4_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K4_ARGS
}

// K4 on the states where they lie (prefix_scan.state_scan_map's walk):
// groups × rows payload elements, chunk c of group (o, ai) at
// (o·cols + c)·inner + ai·rows, its decay at (o / a_div)·a_outer + ai +
// c·a_col. vec, sp (a group's vector slots, whole warps):
// prefix_scan.state_walk's. da: the reverse walk of the backward also
// reads y (the forward's output) and writes partials (groups × cols ×
// sp / 32 accumulators, one a warp) for k4_da_sum.
extern "C" int k4_state_scan(int dtype, const void* a, const void* s,
                             void* out, const void* y, void* partials,
                             int64_t groups, int64_t rows, int64_t cols,
                             int64_t inner, int64_t a_in, int64_t a_div,
                             int64_t a_outer, int64_t a_col, int vec,
                             int64_t sp, int reverse, int da,
                             void* stream) {
  if (groups < 0 || rows < 0 || cols < 0 || a_in < 1 || a_div < 1 ||
      vec < 1 || sp < 0)
    return (int)cudaErrorInvalidValue;
  if (groups == 0 || rows == 0 || cols == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define K4_ARGS                                                             \
  da, vec, a, s, out, y, partials, groups, sp, rows, cols, inner, a_in,     \
      a_div, a_outer, a_col, reverse, st
  switch (dtype) {
    case 0: return k4::launch_state_t<float>(K4_ARGS);
    case 1: return k4::launch_state_t<double>(K4_ARGS);
    case 2: return k4::launch_state_t<__nv_bfloat16>(K4_ARGS);
    case 3: return k4::launch_state_t<__half>(K4_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K4_ARGS
}

// da (n_e decay elements, the decay's dtype) from k4_state_scan's
// partials (wpg a (group, chunk)); per_chunk: the decay varies along the
// chunks.
extern "C" int k4_da_sum(int dtype, const void* partials, void* da,
                         int64_t n_e, int64_t cols, int64_t a_in,
                         int64_t a_div, int64_t wpg, int per_chunk,
                         void* stream) {
  if (n_e < 0 || cols < 1 || a_in < 1 || a_div < 1 || wpg < 1)
    return (int)cudaErrorInvalidValue;
  if (n_e == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return k4::launch_da<float>(partials, da, n_e, cols, a_in, a_div,
                                        wpg, per_chunk, st);
    case 1: return k4::launch_da<double>(partials, da, n_e, cols, a_in,
                                         a_div, wpg, per_chunk, st);
    case 2: return k4::launch_da<__nv_bfloat16>(partials, da, n_e, cols,
                                                a_in, a_div, wpg, per_chunk,
                                                st);
    case 3: return k4::launch_da<__half>(partials, da, n_e, cols, a_in,
                                         a_div, wpg, per_chunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
