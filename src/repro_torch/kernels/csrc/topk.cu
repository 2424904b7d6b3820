// K7 — c5_topk, the MoE router's top-k, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   K7  src/repro/kernels/topk.py  topk_pallas  (_topk_body)
// and computes the top k of each row in lax.top_k's order (the oracle
// ref.topk): keys descending in their sortable integer form (Order<T>:
// for floats the bits b map to b ^ ((b >> 31) & 0x7fffffff), on 16 bits
// for bf16, so +0.0 ranks above -0.0 and a NaN ranks by its sign bit
// above +inf or below -inf), equal keys in ascending lane index. That is
// a strict total order, so the top k of a row is unique: both routes
// below give the oracle's values and indices, and on rows without NaN
// and without both signed zeros the JAX kernel's network gives the same.
// Values leave by their own bits (the key map is its own inverse).
//
// A row is read in place: it holds n keys at a row stride ld, and stands
// for a row of npow (a power of two) whose lanes n … npow-1 hold the
// dtype's minimum, each with its own index, as the padded operand of the
// reference's ops._topk_kernel would; no padded copy is made.
//
// What bounds it on the H100: device-memory bytes. A launch reads each key
// once (rows · n · sizeof(key)) and writes k keys and k int32 indices per
// row. Two routes, chosen by k:
//
//  * k ≤ 32, k7_topk_partial_kernel: a partial top-k, one instance per
//    padded k (KP = 1, 2, 4, 8, 16, 32). A group of G lanes of one warp
//    owns a row: G = 32 for few rows (the decode step's 4: latency), 16
//    or 8 once the rows keep more than 32768 lanes busy (the prefill's
//    4096: fewer shuffle rounds, less work), and for narrow rows at most
//    npow over the keys of one 16-byte vector. Each lane streams its
//    part of the row in batches of B keys (KP, at least one vector, at
//    most 16): 16-byte vectors where the row start and stride allow,
//    else key by key. It sorts each batch in registers and merges it
//    into its descending list of KP (key, index) pairs, each packed into
//    one 64-bit word (key ^ 0x80000000 above, ~index below, so one
//    unsigned compare orders both). Of the pad lanes only the first KP
//    can rank in a top KP (they tie on the key), so only those are
//    inserted, one by one. Then log2(G) rounds of __shfl_xor_sync merge
//    two lanes' lists into their top KP: the elementwise max of one list
//    and the other reversed is a bitonic sequence holding the top KP,
//    which half-cleaners sort in registers. No shared memory, no
//    barrier; rows of any width take the same walk.
//  * k > 32, k7_topk_network_kernel: the full descending bitonic network
//    with the lane index as payload (the JAX kernel's _topk_body, on the
//    sortable keys), on the tile of bitonic_tile.cuh: a block holds 4096
//    keys, 4096 / npow whole rows (npow ≤ 4096); layers with j < 32
//    through __shfl_xor_sync, larger ones through one shared-memory copy
//    of the tile (32 KiB). Only the first k keys and indices of each row
//    are written.
//
// Offsets are 64-bit.
#include "bitonic_tile.cuh"

namespace {

// Storage type <-> sortable int32 key (the order of the oracle).
template <typename T>
struct Order;

template <>
struct Order<float> {
  static __device__ __forceinline__ int32_t key(float v) {
    const int32_t b = __float_as_int(v);
    return b ^ ((b >> 31) & 0x7fffffff);
  }
  static __device__ __forceinline__ float value(int32_t k) {
    return __int_as_float(k ^ ((k >> 31) & 0x7fffffff));
  }
  static __device__ __forceinline__ int32_t lowest() {   // finfo.min
    return key(-3.40282347e38f);
  }
};

template <>
struct Order<int32_t> {
  static __device__ __forceinline__ int32_t key(int32_t v) { return v; }
  static __device__ __forceinline__ int32_t value(int32_t k) { return k; }
  static __device__ __forceinline__ int32_t lowest() { return INT32_MIN; }
};

template <>
struct Order<__nv_bfloat16> {
  // the 16-bit key, sign-extended (the order is kept)
  static __device__ __forceinline__ int32_t key(__nv_bfloat16 v) {
    const int32_t b = (int16_t)__bfloat16_as_ushort(v);
    return (int16_t)(b ^ ((b >> 15) & 0x7fff));
  }
  static __device__ __forceinline__ __nv_bfloat16 value(int32_t k) {
    const int32_t b = (int16_t)k;
    return __ushort_as_bfloat16((unsigned short)(b ^ ((b >> 15) & 0x7fff)));
  }
  static __device__ __forceinline__ int32_t lowest() {   // finfo.min, 0xff7f
    return key(__ushort_as_bfloat16(0xff7f));
  }
};

// ---------------------------------------------------------------------------
// k ≤ 32: the partial top-k
// ---------------------------------------------------------------------------

// (key, index) as one word: a larger word ranks first. 0 ranks below
// every pair (it would need index 0xffffffff), so it marks an empty slot.
using Pair = unsigned long long;

__device__ __forceinline__ Pair pack(int32_t key, int index) {
  return ((Pair)((uint32_t)key ^ 0x80000000u) << 32) |
         (uint32_t)~(uint32_t)index;
}

__device__ __forceinline__ int32_t key_of(Pair p) {
  return (int32_t)((uint32_t)(p >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int index_of(Pair p) {
  return (int)~(uint32_t)p;
}

__device__ __forceinline__ Pair first(Pair a, Pair b) {
  return a > b ? a : b;
}

__device__ __forceinline__ Pair second(Pair a, Pair b) {
  return a > b ? b : a;
}

// Insert p into the descending list (the last pair falls out).
template <int KP>
__device__ __forceinline__ void insert(Pair (&list)[KP], Pair p) {
  if (p > list[KP - 1]) {
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const Pair hi = first(list[j], p);
      p = second(list[j], p);
      list[j] = hi;
    }
  }
}

// list := the top KP of list ∪ b[0 … M-1] (both descending, M ≤ KP):
// list[j] ∨ b[KP-1-j] (b padded with empty slots) is a bitonic sequence
// holding the top KP, which half-cleaners sort.
template <int KP, int M, int N>
__device__ __forceinline__ void merge_top(Pair (&list)[KP],
                                          const Pair (&b)[N]) {
  static_assert(M <= KP && M <= N, "M pairs of b merge into the list");
#pragma unroll
  for (int j = KP - M; j < KP; ++j) list[j] = first(list[j], b[KP - 1 - j]);
#pragma unroll
  for (int h = KP / 2; h >= 1; h >>= 1) {     // half-cleaners, descending
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      if (j & h) continue;
      const Pair a = list[j], c = list[j + h];
      list[j] = first(a, c);
      list[j + h] = second(a, c);
    }
  }
}

// b sorted descending (a bitonic network in registers).
template <int B>
__device__ __forceinline__ void sort_desc(Pair (&b)[B]) {
#pragma unroll
  for (int k = 2; k <= B; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j >= 1; j >>= 1) {
#pragma unroll
      for (int i = 0; i < B; ++i) {
        if ((i ^ j) <= i) continue;
        const Pair a = b[i], c = b[i ^ j];
        const bool desc = (i & k) == 0;
        b[i] = desc ? first(a, c) : second(a, c);
        b[i ^ j] = desc ? second(a, c) : first(a, c);
      }
    }
  }
}

// list := the top KP of list ∪ a batch of B pairs.
template <int KP, int B>
__device__ __forceinline__ void take_batch(Pair (&list)[KP], Pair (&b)[B]) {
  sort_desc(b);
  merge_top<KP, (B < KP ? B : KP)>(list, b);
}

// Rows of n keys at stride ld standing for rows of npow; G = 2^log2_g
// lanes a row. vals/idx: rows of k (contiguous).
template <typename T, int KP>
__global__ void __launch_bounds__(THREADS)
k7_topk_partial_kernel(const T* __restrict__ x, T* __restrict__ vals,
                       int32_t* __restrict__ idx, int64_t rows, int64_t ld,
                       int n, int npow, int k, int log2_g, bool vec) {
  using O = Order<T>;
  constexpr int V = 16 / sizeof(T);           // keys of one 16-byte vector
  // a batch: whole vectors, KP keys (at most 16)
  constexpr int B = KP < V ? V : KP > 16 ? 16 : KP;
  const int g = 1 << log2_g;
  const int sub = threadIdx.x & (g - 1);
  const int64_t row =
      ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> log2_g;
  Pair list[KP];
#pragma unroll
  for (int j = 0; j < KP; ++j) list[j] = 0;
  if (row < rows) {
    const T* xr = x + row * ld;
    int done = 0;
    if (vec) {                       // batches of B / V vectors a lane
      const int nv = n / V;
      for (int v0 = sub; v0 < nv; v0 += g * (B / V)) {
        Pair b[B];
#pragma unroll
        for (int u = 0; u < B / V; ++u) {
          const int v = v0 + u * g;
          alignas(16) T raw[V];
          if (v < nv)
            *reinterpret_cast<uint4*>(raw) =
                reinterpret_cast<const uint4*>(xr)[v];
#pragma unroll
          for (int t = 0; t < V; ++t)
            b[u * V + t] = v < nv ? pack(O::key(raw[t]), v * V + t) : 0;
        }
        take_batch(list, b);
      }
      done = nv * V;
    }
    for (int i0 = done + sub; i0 < n; i0 += g * B) {   // batches of B keys
      Pair b[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int i = i0 + u * g;
        b[u] = i < n ? pack(O::key(xr[i]), i) : 0;
      }
      take_batch(list, b);
    }
    const int pad_end = min(npow, n + KP);
    for (int i = n + sub; i < pad_end; i += g)
      insert(list, pack(O::lowest(), i));
  }
  // every lane of the warp takes part (rows past the end hold empty lists)
  for (int off = 1; off < g; off <<= 1) {
    Pair other[KP];
#pragma unroll
    for (int j = 0; j < KP; ++j)
      other[j] = __shfl_xor_sync(0xffffffffu, list[j], off);
    merge_top<KP, KP>(list, other);
  }
  if (row < rows) {
    for (int j = sub; j < k; j += g) {
      Pair p = list[0];
#pragma unroll
      for (int t = 1; t < KP; ++t) p = t == j ? list[t] : p;
      vals[row * k + j] = O::value(key_of(p));
      idx[row * k + j] = index_of(p);
    }
  }
}

// ---------------------------------------------------------------------------
// k > 32: the full network (npow ≤ 4096)
// ---------------------------------------------------------------------------

// One lane of one descending compare-and-swap layer with payload
// (_cas_layer): lower = this lane's bit j is clear; asc = its k-block is
// an ascending one of the bitonic schedule. Equal keys are ordered by the
// payload (the lane index), the smaller index first.
__device__ __forceinline__ void cas(int32_t& key, int& idx, int32_t okey,
                                    int oidx, bool lower, bool asc) {
  bool keep_lo = asc != lower;             // descending
  bool self_is_lo = key < okey || (key == okey && idx > oidx);
  if (keep_lo != self_is_lo) {
    key = okey;
    idx = oidx;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k7_topk_network_kernel(const T* __restrict__ x, T* __restrict__ vals,
                       int32_t* __restrict__ idx, int64_t rows, int64_t ld,
                       int n, int log2_npow, int k) {
  using O = Order<T>;
  __shared__ int32_t skey[TILE];
  __shared__ int sidx[TILE];
  const int npow = 1 << log2_npow;
  int32_t v[PER_THREAD];
  int p[PER_THREAD];
  const int64_t base = (int64_t)blockIdx.x * TILE;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = tile_index(e);
    const int64_t row = (base + i) >> log2_npow;
    const int lane = i & (npow - 1);
    v[e] = row < rows && lane < n ? O::key(x[row * ld + lane]) : O::lowest();
    p[e] = lane;
  }
  for (int kk = 2; kk <= npow; kk <<= 1) {
    for (int j = kk >> 1; j >= 1; j >>= 1) {
      if (j >= 32) {
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
          int i = tile_index(e);
          skey[i] = v[e];
          sidx[i] = p[e];
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
          int i = tile_index(e);
          cas(v[e], p[e], skey[i ^ j], sidx[i ^ j], (i & j) == 0,
              ((i & (npow - 1)) & kk) == 0);
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
          int i = tile_index(e);
          int32_t okey = __shfl_xor_sync(0xffffffffu, v[e], j);
          int oidx = __shfl_xor_sync(0xffffffffu, p[e], j);
          cas(v[e], p[e], okey, oidx, (i & j) == 0,
              ((i & (npow - 1)) & kk) == 0);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const int i = tile_index(e);
    const int64_t row = (base + i) >> log2_npow;
    const int lane = i & (npow - 1);
    if (row < rows && lane < k) {
      vals[row * k + lane] = O::value(v[e]);
      idx[row * k + lane] = p[e];
    }
  }
}

bool bad_shape(int64_t rows, int64_t ld, int n, int npow, int k) {
  return npow < 1 || (npow & (npow - 1)) || n < 1 || n > npow || k < 1 ||
         k > npow || rows < 0 || ld < 0;
}

template <typename T, int KP>
int launch_partial_kp(const T* x, T* vals, int32_t* idx, int64_t rows,
                      int64_t ld, int n, int npow, int k, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  // lanes a row: 32, down to 8 while the rows keep more than 32768 lanes
  // busy (there fewer shuffle rounds do less work), and at most the
  // row's vectors
  int log2_g = 5;
  while (log2_g > 3 && (rows << log2_g) > 32768) --log2_g;
  const int narrow = log2_of(npow) - log2_of(V);
  if (narrow < log2_g) log2_g = narrow < 0 ? 0 : narrow;
  const bool vec = (uintptr_t)x % 16 == 0 && ld % V == 0;
  const int64_t threads = rows << log2_g;
  k7_topk_partial_kernel<T, KP>
      <<<(unsigned)((threads + THREADS - 1) / THREADS), THREADS, 0, s>>>(
          x, vals, idx, rows, ld, n, npow, k, log2_g, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_partial(const void* x, void* vals, void* idx, int64_t rows,
                   int64_t ld, int n, int npow, int k, cudaStream_t s) {
  if (bad_shape(rows, ld, n, npow, k) || k > 32)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const T* tx = (const T*)x;
  T* tv = (T*)vals;
  int32_t* ti = (int32_t*)idx;
  switch (log2_of(k)) {
#define K7_CASE(L)                                                          \
  case L:                                                                   \
    return launch_partial_kp<T, 1 << L>(tx, tv, ti, rows, ld, n, npow, k, s);
    K7_CASE(0) K7_CASE(1) K7_CASE(2) K7_CASE(3) K7_CASE(4) K7_CASE(5)
#undef K7_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_network(const void* x, void* vals, void* idx, int64_t rows,
                   int64_t ld, int n, int npow, int k, cudaStream_t s) {
  if (bad_shape(rows, ld, n, npow, k) || npow < 2 || npow > TILE)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t n_keys = rows * npow;
  k7_topk_network_kernel<T>
      <<<(unsigned)((n_keys + TILE - 1) / TILE), THREADS, 0, s>>>(
          (const T*)x, (T*)vals, (int32_t*)idx, rows, ld, n, log2_of(npow),
          k);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 int32, 2 bfloat16. x: rows of n keys at
// stride ld (elements), standing for rows of npow; vals/idx: (rows, k).
extern "C" int k7_topk_partial(int dtype, const void* x, void* vals,
                               void* idx, int64_t rows, int64_t ld, int n,
                               int npow, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_partial<float>(x, vals, idx, rows, ld, n, npow, k, s);
    case 1:
      return launch_partial<int32_t>(x, vals, idx, rows, ld, n, npow, k, s);
    case 2:
      return launch_partial<__nv_bfloat16>(x, vals, idx, rows, ld, n, npow,
                                           k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int k7_topk_network(int dtype, const void* x, void* vals,
                               void* idx, int64_t rows, int64_t ld, int n,
                               int npow, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_network<float>(x, vals, idx, rows, ld, n, npow, k, s);
    case 1:
      return launch_network<int32_t>(x, vals, idx, rows, ld, n, npow, k, s);
    case 2:
      return launch_network<__nv_bfloat16>(x, vals, idx, rows, ld, n, npow,
                                           k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
