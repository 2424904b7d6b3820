// K5 and K6 — the bitonic sorting networks of c2_sort and c1_merge, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels
//   K5  src/repro/kernels/sortnet.py  sort_chunks_pallas   (_sort_body)
//   K6  src/repro/kernels/sortnet.py  merge_sorted_pallas  (_merge_body)
// and computes exactly what their networks compute (bitonic_sort_network,
// bitonic_merge_network, _cas_layer without payload): every lane takes
// its own value or its partner's (lane XOR j) by the same comparisons and
// the same lane tiebreak (cas), so the output is bit-identical to the
// plain PyTorch network in sortnet.py, ties, ±0.0 and NaN included.
//
// What bounds it on the H100: device-memory bytes. A launch reads each
// key once and writes it once (2 · N · sizeof(key)); a network of L
// compare-and-select layers does about L operations per key (L = 6 for
// width 8, 12 for a 4096-element merge), far below the card's ~20
// operations per byte. Both keep every layer on chip:
//
//  * Sort and merge carry nothing between chunks, so a launch is one grid
//    over all TILE-element tiles of the flattened operand (a 2^26-key row
//    spreads over 16384 blocks). The TPU kernel's row-block walk is not
//    carried over.
//  * Chunks never straddle tiles (TILE is a multiple of every supported
//    chunk), so a ragged last tile just pads whole chunks it never stores.
//  * bf16 keys are compared as float (__bfloat162float is exact), so a
//    tile holds 4-byte keys for every type: 16 KiB of shared memory (in
//    K5 every instance, for its staged loads; in K6 from L = 5).
//  * Offsets are 64-bit.
//
// Both are specialised on the network's size: one instance per L =
// log2(width) for K5 and per L = log2(2w) for K6, 1 … 12, so every
// layer's partner, and its direction wherever that is a register bit, is
// known at compile time. A thread holds 16 keys of a 4096-key tile in
// one of three layouts (the K6 section below); a layer on a register bit
// runs on keys the thread holds, one on a lane bit through
// __shfl_xor_sync (K5), and a swizzled shared-memory transpose moves the
// tile between layouts. K5 loads and stores each warp's 512 keys as
// 16-byte vectors on consecutive addresses. K6 reads b reversed within
// each chunk while loading, so the tile holds the bitonic sequence
// (a, reverse(b)) and only the merge layers run; it writes the lower
// half to lo and the upper half to hi.
#include "bitonic_tile.cuh"

namespace {

// One lane of one compare-and-swap layer (_cas_layer, keys only).
// lower: this lane's bit j is clear; up: the pair is ordered ascending
// (asc XOR descending), i.e. its lower lane keeps the smaller key.
template <typename C>
__device__ __forceinline__ C cas(C self, C other, bool lower, bool up) {
  bool keep_lo = lower ? up : !up;
  bool self_is_lo = lower ? (self <= other) : (self < other);
  return keep_lo == self_is_lo ? self : other;
}

// ---------------------------------------------------------------------------
// K6: the merge, specialised on its size
// ---------------------------------------------------------------------------
// A merge of 2w = 2^L keys runs L layers, on index bits L-1 … 0 of the
// merged chunk, every pair in one direction. A 4096-key tile holds
// 4096 / 2^L chunks; its 12 index bits sit in one of three layouts:
// in layout q, bits 4q … 4q+3 select a thread's 16 registers, so every
// layer on one of those bits pairs keys that the thread already holds;
// the other 8 bits are the lane (5) and warp (3) bits:
//   q = 2: registers 8–11, lanes 0–4,       warps 5–7
//   q = 1: registers 4–7,  lanes 0–3 and 8, warps 9–11
//   q = 0: registers 0–3,  lanes 4–8,       warps 9–11
// A merge runs q = ⌈L/4⌉−1 … 0 in turn, each its layers on bits
// min(4q+3, L−1) … 4q, with one transpose of the tile through shared
// memory between two layouts: at L = 12 two transposes and three
// barriers. At L ≤ 4 a whole chunk lies in one thread and nothing is
// exchanged. The shared tile is XOR-swizzled (swz) so that every warp
// access of every layout touches 32 distinct banks.
//
// Keys enter in the first layout and leave from layout 0, where a
// thread's registers are 16 consecutive merged keys: 16 consecutive keys
// of lo or of hi (L ≥ 5), or 8 of each (L ≤ 4), stored as 16-byte
// vectors. At L ≤ 4 they are also loaded so, 8 keys of a and 8 of b (b's
// reversed in registers), where rows, strides and pointers allow it
// (`vec`); elsewhere each key is loaded alone, a warp's 32 loads on
// consecutive addresses.

// Word of tile index i in the shared tile: bits 0–3 XOR bits 5–8, bit 4
// XOR bit 8. Linear over XOR, so swz(a | b) = swz(a) ^ swz(b) for
// disjoint a and b.
__device__ __forceinline__ int swz(int i) {
  return i ^ ((i >> 5) & 15) ^ ((i >> 4) & 16);
}

// Tile index of this thread's register 0 in layout Q (register e adds
// e << 4Q).
template <int Q>
__device__ __forceinline__ int layout_base() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (Q == 2) return lane | (warp << 5);
  else if constexpr (Q == 1)
    return (lane & 15) | ((lane >> 4) << 8) | (warp << 9);
  else return (lane << 4) | (warp << 9);
}

// The layers of layout Q: bits min(4Q+3, L-1) … 4Q, each pairing register
// e (bit clear) with e | 1 << (bit - 4Q), by cas() on both keys.
template <int Q, int L, typename C>
__device__ __forceinline__ void merge_layers(C (&v)[PER_THREAD], bool up) {
  constexpr int top = (4 * Q + 3 < L - 1) ? 4 * Q + 3 : L - 1;
#pragma unroll
  for (int bit = top; bit >= 4 * Q; --bit) {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int f = e | (1 << (bit - 4 * Q));
      if (f == e) continue;
      const C x = v[e], y = v[f];
      v[e] = cas(x, y, true, up);
      v[f] = cas(y, x, false, up);
    }
  }
}

// From layout QF to layout QT through the shared tile.
template <int QF, int QT, bool SYNC_FIRST, typename C>
__device__ __forceinline__ void transpose(C (&v)[PER_THREAD], C* smem) {
  const int from = swz(layout_base<QF>()), to = swz(layout_base<QT>());
  if (SYNC_FIRST) __syncthreads();    // the last transpose's reads are done
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) smem[from ^ swz(e << (4 * QF))] = v[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) v[e] = smem[to ^ swz(e << (4 * QT))];
}

// N consecutive keys at p (16-byte aligned), as 16-byte loads / stores.
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* p,
                                         typename Key<T>::C (&out)[N]) {
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte vectors");
  alignas(16) T raw[N];
#pragma unroll
  for (int k = 0; k < int(N * sizeof(T) / 16); ++k)
    reinterpret_cast<uint4*>(raw)[k] = reinterpret_cast<const uint4*>(p)[k];
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = Key<T>::in(raw[k]);
}

template <typename T, int N>
__device__ __forceinline__ void store_run(T* p,
                                          const typename Key<T>::C (&in)[N]) {
  static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte vectors");
  alignas(16) T raw[N];
#pragma unroll
  for (int k = 0; k < N; ++k) raw[k] = Key<T>::out(in[k]);
#pragma unroll
  for (int k = 0; k < int(N * sizeof(T) / 16); ++k)
    reinterpret_cast<uint4*>(p)[k] = reinterpret_cast<const uint4*>(raw)[k];
}

// ---------------------------------------------------------------------------
// K5: the sort, specialised on its width
// ---------------------------------------------------------------------------
// A sort of 2^L keys runs stages S = 1 … L (the network's k = 2^S), stage
// S its layers on index bits S-1 … 0; a pair's direction is bit S of its
// index (up when clear, XOR descending), and at S = L every pair is up.
// Keys enter and leave in layout 0, 16 consecutive keys a thread (staged
// through shared memory, k5_sort_kernel): bits 0–3 are registers, 4–8
// lanes, 9–11 warps. A layer on bits 0–3 pairs
// keys the thread holds, one on bits 4–8 pairs lane l with lane
// l ^ 2^(bit-4) (__shfl_xor_sync), so every stage up to S = 9 runs in
// layout 0. Stages S ≥ 10 also touch the warp bits: their layers on bits
// S-1 … 8 run in layout 2 (registers 8–11), one transpose there and one
// back, then bits 7 … 0 in layout 0 (at L = 12, six transposes). At
// L ≤ 4 a thread holds whole chunks: every layer runs in registers.

// The layer on tile-index bit B of stage S in layout Q (base: this
// thread's register 0 in Q).
template <int Q, int B, int S, int L, typename C>
__device__ __forceinline__ void sort_layer(C (&v)[PER_THREAD], int base,
                                           bool descending) {
  if constexpr (B >= 4 * Q && B < 4 * Q + 4) {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const int f = e | (1 << (B - 4 * Q));
      if (f == e) continue;
      const bool up =
          (S == L || (((base | (e << (4 * Q))) >> S) & 1) == 0) != descending;
      const C x = v[e], y = v[f];
      v[e] = cas(x, y, true, up);
      v[f] = cas(y, x, false, up);
    }
  } else {
    static_assert(Q == 0 && B >= 4 && B <= 8, "a lane bit of layout 0");
    const int m = 1 << (B - 4);
    const bool lower = (threadIdx.x & m) == 0;
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const bool up = (S == L || (((base | e) >> S) & 1) == 0) != descending;
      v[e] = cas(v[e], __shfl_xor_sync(0xffffffffu, v[e], m), lower, up);
    }
  }
}

// Layers on bits HI … LO of stage S in layout Q.
template <int Q, int S, int HI, int LO, int L, typename C>
__device__ __forceinline__ void sort_layers(C (&v)[PER_THREAD], int base,
                                            bool descending) {
  if constexpr (HI >= LO) {
    sort_layer<Q, HI, S, L>(v, base, descending);
    sort_layers<Q, S, HI - 1, LO, L>(v, base, descending);
  }
}

// Stages S … L.
template <int S, int L, typename C>
__device__ __forceinline__ void sort_stages(C (&v)[PER_THREAD], C* smem,
                                            bool descending) {
  if constexpr (S <= L) {
    if constexpr (S <= 9) {
      sort_layers<0, S, S - 1, 0, L>(v, layout_base<0>(), descending);
    } else {
      transpose<0, 2, true>(v, smem);      // after the stage's reads
      sort_layers<2, S, S - 1, 8, L>(v, layout_base<2>(), descending);
      transpose<2, 0, true>(v, smem);
      sort_layers<0, S, 7, 0, L>(v, layout_base<0>(), descending);
    }
    sort_stages<S + 1, L>(v, smem, descending);
  }
}

// Where vector u (16 bytes) of a warp's 512 keys sits in its stage: the
// U vectors of thread u / U, their order XOR-swizzled by that thread's
// index so that the eight 16-byte accesses of each quarter-warp (each
// phase of a 128-bit shared access) touch eight distinct bank groups,
// both when lanes store consecutive vectors and when each lane reads its
// own U.
template <int U>
__device__ __forceinline__ int stage_slot(int u) {
  const int t = u / U;
  return t * U + ((u % U) ^ ((t / (8 / U)) & (U - 1)));
}

// K5: sort every 2^L-key chunk of x (n keys, contiguous) into out; vec:
// both 16-byte aligned. A warp whose 512 keys all exist loads them as
// 16-byte vectors on consecutive addresses (a warp's load: 512
// contiguous bytes) and hands each lane its 16 keys of layout 0 through
// a swizzled stage in shared memory; the stores go back the same way.
// Other warps (the ragged end) move key by key.
template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
k5_sort_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
               bool descending, bool vec) {
  using K = Key<T>;
  using C = typename K::C;
  constexpr int U = PER_THREAD * sizeof(T) / 16;     // vectors a thread
  __shared__ uint4 buf[TILE * sizeof(C) / 16];       // stage, transposes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * TILE + warp * 32 * PER_THREAD;
  const int64_t g0 = w0 + lane * PER_THREAD;         // layout 0
  const bool whole = vec && w0 + 32 * PER_THREAD <= n;   // warp-uniform
  uint4* stage = buf + warp * 32 * U;
  C v[PER_THREAD];
  if (whole) {
    const uint4* src = reinterpret_cast<const uint4*>(x + w0);
#pragma unroll
    for (int j = 0; j < U; ++j)
      stage[stage_slot<U>(j * 32 + lane)] = src[j * 32 + lane];
    __syncwarp();
    alignas(16) T raw[PER_THREAD];
#pragma unroll
    for (int j = 0; j < U; ++j)
      reinterpret_cast<uint4*>(raw)[j] = stage[stage_slot<U>(lane * U + j)];
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) v[t] = K::in(raw[t]);
  } else {
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t)
      v[t] = g0 + t < n ? K::in(x[g0 + t]) : C(0);
  }
  if constexpr (L >= 10) {
    sort_stages<1, L>(v, reinterpret_cast<C*>(buf), descending);
    __syncthreads();                  // the last transpose's reads are done
  } else {
    sort_stages<1, L>(v, (C*)nullptr, descending);
  }
  if (whole) {
    alignas(16) T raw[PER_THREAD];
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) raw[t] = K::out(v[t]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < U; ++j)
      stage[stage_slot<U>(lane * U + j)] = reinterpret_cast<uint4*>(raw)[j];
    __syncwarp();
    uint4* dst = reinterpret_cast<uint4*>(out + w0);
#pragma unroll
    for (int j = 0; j < U; ++j)
      dst[j * 32 + lane] = stage[stage_slot<U>(j * 32 + lane)];
  } else {
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t)
      if (g0 + t < n) out[g0 + t] = K::out(v[t]);
  }
}

// Where chunk c's row starts: (row, first column of the chunk).
struct ChunkRows {
  uint32_t chunks_per_row;
  int shift;      // log2(chunks_per_row) when a power of two, else -1
  __device__ __forceinline__ void locate(uint32_t c, int64_t& row,
                                         int64_t& col, int log2_w) const {
    const uint32_t r = shift >= 0 ? c >> shift : c / chunks_per_row;
    row = r;
    col = (int64_t)(c - r * chunks_per_row) << log2_w;
  }
};

// K6: for every chunk c of w = 2^(L-1) keys (rows of a and b start every
// lda / ldb keys), merge a's chunk with b's chunk reversed; the lower w
// keys go to lo, the upper w to hi (both contiguous). The tile is a view
// of the 2·n_chunks·w merged keys, 2w per chunk.
template <typename T, int L>
__global__ void __launch_bounds__(THREADS)
k6_merge_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ lo, T* __restrict__ hi, int64_t n_virtual,
                ChunkRows rowmap, int64_t lda, int64_t ldb, bool descending,
                bool vec) {
  using K = Key<T>;
  using C = typename K::C;
  constexpr int W = 1 << (L - 1);
  constexpr int Q0 = (L - 1) / 4;              // the first layout
  const bool up = !descending;
  const int64_t tile = (int64_t)blockIdx.x * TILE;
  C v[PER_THREAD];

  // one key of the merged sequence: a's chunk, then b's reversed
  auto key_at = [&](int64_t g) -> C {
    if (g >= n_virtual) return C(0);           // a chunk past the end
    int64_t row, col;
    rowmap.locate((uint32_t)(g >> L), row, col, L - 1);
    const int m = (int)(g & (2 * W - 1));
    return m < W ? K::in(a[row * lda + col + m])
                 : K::in(b[row * ldb + col + (2 * W - 1 - m)]);
  };

  const int base = layout_base<Q0>();
  if constexpr (L <= 4) {
    // 16 / 2^L whole chunks: 8 consecutive keys of a, 8 of b
    const int64_t g0 = tile + base;
    if (vec && g0 + PER_THREAD <= n_virtual) {
      int64_t row, col;
      rowmap.locate((uint32_t)(g0 >> L), row, col, L - 1);
      C ra[8], rb[8];
      load_run<T, 8>(a + row * lda + col, ra);
      load_run<T, 8>(b + row * ldb + col, rb);
#pragma unroll
      for (int t = 0; t < PER_THREAD; ++t) {
        const int j = t >> L, m = t & (2 * W - 1);
        v[t] = m < W ? ra[j * W + m] : rb[j * W + 2 * W - 1 - m];
      }
    } else {
#pragma unroll
      for (int t = 0; t < PER_THREAD; ++t) v[t] = key_at(g0 + t);
    }
  } else {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e)
      v[e] = key_at(tile + (base | (e << (4 * Q0))));
  }

  merge_layers<Q0, L>(v, up);
  if constexpr (Q0 >= 1) {
    __shared__ C smem[TILE];
    if constexpr (Q0 == 2) {
      transpose<2, 1, false>(v, smem);
      merge_layers<1, L>(v, up);
    }
    transpose<1, 0, Q0 == 2>(v, smem);
    merge_layers<0, L>(v, up);
  }

  // layout 0: 16 consecutive merged keys a thread
  const int64_t g0 = tile + layout_base<0>();
  if (g0 >= n_virtual) return;
  if constexpr (L >= 5) {
    // one half of one chunk: 16 consecutive keys of lo or of hi
    const int m0 = (int)(g0 & (2 * W - 1));
    const int64_t at = ((g0 >> L) << (L - 1)) + (m0 & (W - 1));
    store_run<T, PER_THREAD>((m0 < W ? lo : hi) + at, v);
  } else if (g0 + PER_THREAD <= n_virtual) {
    // 16 / 2^L whole chunks: 8 consecutive keys of lo and 8 of hi
    C rl[8], rh[8];
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int j = t >> L, m = t & (2 * W - 1);
      if (m < W) rl[j * W + m] = v[t];
      else rh[j * W + m - W] = v[t];
    }
    store_run<T, 8>(lo + (g0 >> 1), rl);
    store_run<T, 8>(hi + (g0 >> 1), rh);
  } else {
#pragma unroll
    for (int t = 0; t < PER_THREAD; ++t) {
      const int64_t g = g0 + t;
      if (g >= n_virtual) break;
      const int m = t & (2 * W - 1);
      const int64_t at = ((g >> L) << (L - 1)) + (m & (W - 1));
      (m < W ? lo : hi)[at] = K::out(v[t]);
    }
  }
}

template <typename T, int L>
int launch_sort_l(const T* x, T* out, int64_t n, bool descending, bool vec,
                  cudaStream_t s) {
  k5_sort_kernel<T, L><<<(unsigned)((n + TILE - 1) / TILE), THREADS, 0, s>>>(
      x, out, n, descending, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sort(const void* x, void* out, int64_t n, int width,
                int descending, cudaStream_t s) {
  if (width < 2 || width > TILE || (width & (width - 1)) || n % width)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool vec = (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0;
  const T* tx = (const T*)x;
  T* to = (T*)out;
  const bool desc = descending != 0;
  switch (log2_of(width)) {
#define K5_CASE(L) \
  case L: return launch_sort_l<T, L>(tx, to, n, desc, vec, s);
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4) K5_CASE(5) K5_CASE(6)
    K5_CASE(7) K5_CASE(8) K5_CASE(9) K5_CASE(10) K5_CASE(11) K5_CASE(12)
#undef K5_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int L>
int launch_merge_l(const T* a, const T* b, T* lo, T* hi, int64_t n_virtual,
                   ChunkRows rowmap, int64_t lda, int64_t ldb, bool descending,
                   bool vec, cudaStream_t s) {
  k6_merge_kernel<T, L><<<(unsigned)((n_virtual + TILE - 1) / TILE), THREADS,
                          0, s>>>(a, b, lo, hi, n_virtual, rowmap, lda, ldb,
                                  descending, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(const void* a, const void* b, void* lo, void* hi,
                 int64_t rows, int64_t cols, int64_t lda, int64_t ldb, int w,
                 int descending, cudaStream_t s) {
  if (w < 1 || 2 * w > TILE || (w & (w - 1)) || cols % w)
    return (int)cudaErrorInvalidValue;
  // lo and hi are written as 16-byte vectors
  if ((uintptr_t)lo % 16 || (uintptr_t)hi % 16)
    return (int)cudaErrorMisalignedAddress;
  int64_t chunks_per_row = cols / w;
  int64_t n_chunks = rows * chunks_per_row;
  if (n_chunks == 0) return 0;
  if (n_chunks >= (int64_t(1) << 32)) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((int64_t(1) << shift) < chunks_per_row) ++shift;
  if ((int64_t(1) << shift) != chunks_per_row) shift = -1;
  const ChunkRows rowmap{(uint32_t)chunks_per_row, shift};
  // L ≤ 4 loads 8 keys of a and of b as 16-byte vectors where each run
  // of 8 keys lies in one row, 16-byte aligned
  const int64_t per_vec = 16 / sizeof(T);
  const bool vec = (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   cols % 8 == 0 && lda % per_vec == 0 && ldb % per_vec == 0;
  const int64_t n_virtual = 2 * n_chunks * w;
  const T *ta = (const T*)a, *tb = (const T*)b;
  T *tl = (T*)lo, *th = (T*)hi;
  const bool desc = descending != 0;
  switch (log2_of(w) + 1) {
#define K6_CASE(L)                                                        \
  case L:                                                                 \
    return launch_merge_l<T, L>(ta, tb, tl, th, n_virtual, rowmap, lda,   \
                                ldb, desc, vec, s);
    K6_CASE(1) K6_CASE(2) K6_CASE(3) K6_CASE(4) K6_CASE(5) K6_CASE(6)
    K6_CASE(7) K6_CASE(8) K6_CASE(9) K6_CASE(10) K6_CASE(11) K6_CASE(12)
#undef K6_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 int32, 2 bfloat16.
extern "C" int k5_sort_chunks(int dtype, const void* x, void* out, int64_t n,
                              int width, int descending, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_sort<float>(x, out, n, width, descending, s);
    case 1: return launch_sort<int32_t>(x, out, n, width, descending, s);
    case 2: return launch_sort<__nv_bfloat16>(x, out, n, width, descending, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int k6_merge_sorted(int dtype, const void* a, const void* b,
                               void* lo, void* hi, int64_t rows, int64_t cols,
                               int64_t lda, int64_t ldb, int w, int descending,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_merge<float>(a, b, lo, hi, rows, cols, lda, ldb, w,
                                 descending, s);
    case 1:
      return launch_merge<int32_t>(a, b, lo, hi, rows, cols, lda, ldb, w,
                                   descending, s);
    case 2:
      return launch_merge<__nv_bfloat16>(a, b, lo, hi, rows, cols, lda, ldb,
                                         w, descending, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
