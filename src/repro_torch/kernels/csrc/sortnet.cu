// K5 and K6 — the bitonic sorting networks of c2_sort and c1_merge, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernels
//   K5  src/repro/kernels/sortnet.py  sort_chunks_pallas   (_sort_body)
//   K6  src/repro/kernels/sortnet.py  merge_sorted_pallas  (_merge_body)
// and computes exactly what their networks compute (bitonic_sort_network,
// bitonic_merge_network, _cas_layer without payload): every lane takes
// its own value or its partner's (lane XOR j) by the same comparisons and
// the same lane tiebreak, so the output is bit-identical to the plain
// PyTorch network in sortnet.py.
//
// What bounds it on the H100: device-memory bytes. A launch reads each
// key once and writes it once (2 · N · sizeof(key)); a network of L
// compare-and-select layers does about L operations per key (L = 6 for
// width 8, 12 for a 4096-element merge), far below the card's ~20
// operations per byte. The design keeps every layer on chip:
//
//  * Sort and merge carry nothing between chunks, so a launch is one grid
//    over all TILE-element tiles of the flattened operand (a 2^26-key row
//    spreads over 16384 blocks). The TPU kernel's row-block walk is not
//    carried over.
//  * A tile lives in registers, PER_THREAD keys a thread. Key e of a
//    thread sits at tile index ((warp * PER_THREAD + e) << 5) | lane, so a
//    partner at distance j < 32 is lane ^ j of the same warp: those layers
//    run through __shfl_xor_sync. Layers with j >= 32 go through one
//    shared-memory copy of the tile between two __syncthreads.
//  * Chunks never straddle tiles (TILE is a multiple of every supported
//    chunk), so a ragged last tile just pads whole chunks it never stores.
//  * K6 reads b reversed within each chunk while loading, so the tile
//    holds the bitonic sequence (a, reverse(b)) and only the merge layers
//    run; it writes the lower half to lo and the upper half to hi.
//  * bf16 keys are compared as float (__bfloat162float is exact), so a
//    tile holds 4-byte keys for every type: 16 KiB of shared memory.
//  * Offsets are 64-bit.
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

// The layers (k, j) for k = k_first .. width (doubling), j = k/2 .. 1.
// Sort: k_first = 2. Merge of a bitonic chunk: k_first = width.
template <typename C>
__device__ __forceinline__ void network(C (&v)[PER_THREAD], C* smem,
                                        int width, int k_first,
                                        bool descending) {
  for (int k = k_first; k <= width; k <<= 1) {
    for (int j = k >> 1; j >= 1; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) smem[tile_index(e)] = v[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
          int i = tile_index(e);
          bool up = (((i & (width - 1)) & k) == 0) != descending;
          v[e] = cas(v[e], smem[i ^ j], (i & j) == 0, up);
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
          int i = tile_index(e);
          bool up = (((i & (width - 1)) & k) == 0) != descending;
          C other = __shfl_xor_sync(0xffffffffu, v[e], j);
          v[e] = cas(v[e], other, (i & j) == 0, up);
        }
      }
    }
  }
}

// K5: sort every `width`-chunk of x (n keys, contiguous) into out.
template <typename T>
__global__ void __launch_bounds__(THREADS)
k5_sort_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n,
               int width, bool descending) {
  using K = Key<T>;
  using C = typename K::C;
  __shared__ C smem[TILE];
  C v[PER_THREAD];
  const int64_t base = (int64_t)blockIdx.x * TILE;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int64_t g = base + tile_index(e);
    v[e] = g < n ? K::in(x[g]) : C(0);
  }
  network(v, smem, width, 2, descending);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int64_t g = base + tile_index(e);
    if (g < n) out[g] = K::out(v[e]);
  }
}

// K6: for every chunk c of w keys (chunks_per_row per row; rows of a and b
// start every lda / ldb keys), merge a's chunk with b's chunk reversed;
// the lower w keys go to lo, the upper w to hi (both contiguous). The
// tile is a view of the 2·n_chunks·w merged keys, 2w per chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS)
k6_merge_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ lo, T* __restrict__ hi, int64_t n_chunks,
                int w, int log2_w, uint32_t chunks_per_row, int64_t lda,
                int64_t ldb, bool descending) {
  using K = Key<T>;
  using C = typename K::C;
  __shared__ C smem[TILE];
  C v[PER_THREAD];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int64_t n_virtual = n_chunks << (log2_w + 1);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int64_t g = base + tile_index(e);
    C key = C(0);
    if (g < n_virtual) {
      uint32_t c = (uint32_t)(g >> (log2_w + 1));
      int m = (int)(g & (2 * w - 1));
      uint32_t row = c / chunks_per_row;
      int64_t col = (int64_t)(c - row * chunks_per_row) << log2_w;
      key = m < w ? K::in(a[row * lda + col + m])
                  : K::in(b[row * ldb + col + (2 * w - 1 - m)]);
    }
    v[e] = key;
  }
  network(v, smem, 2 * w, 2 * w, descending);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int64_t g = base + tile_index(e);
    if (g < n_virtual) {
      int64_t c = g >> (log2_w + 1);
      int m = (int)(g & (2 * w - 1));
      if (m < w)
        lo[(c << log2_w) + m] = K::out(v[e]);
      else
        hi[(c << log2_w) + m - w] = K::out(v[e]);
    }
  }
}

template <typename T>
int launch_sort(const void* x, void* out, int64_t n, int width,
                int descending, cudaStream_t s) {
  if (width < 2 || width > TILE || (width & (width - 1)) || n % width)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  k5_sort_kernel<T><<<(unsigned)((n + TILE - 1) / TILE), THREADS, 0, s>>>(
      (const T*)x, (T*)out, n, width, descending != 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_merge(const void* a, const void* b, void* lo, void* hi,
                 int64_t rows, int64_t cols, int64_t lda, int64_t ldb, int w,
                 int descending, cudaStream_t s) {
  if (w < 1 || 2 * w > TILE || (w & (w - 1)) || cols % w)
    return (int)cudaErrorInvalidValue;
  int64_t chunks_per_row = cols / w;
  int64_t n_chunks = rows * chunks_per_row;
  if (n_chunks == 0) return 0;
  if (n_chunks >= (int64_t(1) << 32)) return (int)cudaErrorInvalidValue;
  int64_t n_virtual = 2 * n_chunks * w;
  k6_merge_kernel<T><<<(unsigned)((n_virtual + TILE - 1) / TILE), THREADS, 0,
                       s>>>((const T*)a, (const T*)b, (T*)lo, (T*)hi,
                            n_chunks, w, log2_of(w), (uint32_t)chunks_per_row,
                            lda, ldb, descending != 0);
  return (int)cudaGetLastError();
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
