// K7 — c5_topk, the MoE router's top-k as a key/payload bitonic sorting
// network, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   K7  src/repro/kernels/topk.py  topk_pallas  (_topk_body)
// and computes exactly what its network computes (bitonic_sort_network
// with payload = lane index, descending; _cas_layer with payload): every
// lane takes its own (key, index) pair or its partner's (lane XOR j) by
// the same comparisons, equal keys ordered by ascending index, so the
// first k pairs of a row are bit-identical to the plain PyTorch network
// in sortnet.py and to lax.top_k.
//
// What bounds it on the H100: device-memory bytes. A launch reads each key
// once (rows · n · sizeof(key)) and writes k keys and k int32 indices per
// row; the network does about log2(n)·(log2(n)+1)/2 compare-and-selects
// per key (45 at the router's n = 512), far below the card's operations
// per byte. The design keeps every layer on chip, as K5 does
// (csrc/sortnet.cu):
//
//  * A block owns a TILE of 4096 keys: 4096 / n whole rows (n ≤ 4096 is a
//    power of two, so rows never straddle tiles). The grid covers all
//    rows; a ragged last tile pads whole rows it never stores.
//  * The tile sits in registers (bitonic_tile.cuh): layers with j < 32
//    run through __shfl_xor_sync, the key and its index together; layers
//    with j >= 32 through one shared-memory copy of the tile's keys and
//    indices between two __syncthreads (32 KiB).
//  * Only the first k keys and indices of each row are written (the TPU
//    kernel writes the whole sorted row and slices it afterwards).
//  * Offsets are 64-bit.
#include "bitonic_tile.cuh"

namespace {

// One lane of one descending compare-and-swap layer with payload
// (_cas_layer): lower = this lane's bit j is clear; asc = its k-block is
// an ascending one of the bitonic schedule. Equal keys are ordered by the
// payload (the lane index), the smaller index first.
template <typename C>
__device__ __forceinline__ void cas(C& key, int& idx, C okey, int oidx,
                                    bool lower, bool asc) {
  bool keep_lo = asc != lower;             // descending
  bool self_is_lo = key < okey || (key == okey && idx > oidx);
  if (keep_lo != self_is_lo) {
    key = okey;
    idx = oidx;
  }
}

// K7: x holds rows of n keys (contiguous); vals/idx get the first k of
// each row's descending sort, rows of k (contiguous).
template <typename T>
__global__ void __launch_bounds__(THREADS)
k7_topk_kernel(const T* __restrict__ x, T* __restrict__ vals,
               int32_t* __restrict__ idx, int64_t n_keys, int n, int log2_n,
               int k) {
  using K = Key<T>;
  using C = typename K::C;
  __shared__ C skey[TILE];
  __shared__ int sidx[TILE];
  C v[PER_THREAD];
  int p[PER_THREAD];
  const int64_t base = (int64_t)blockIdx.x * TILE;
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int i = tile_index(e);
    int64_t g = base + i;
    v[e] = g < n_keys ? K::in(x[g]) : C(0);
    p[e] = i & (n - 1);                    // the lane within its row
  }
  for (int kk = 2; kk <= n; kk <<= 1) {
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
              ((i & (n - 1)) & kk) == 0);
        }
        __syncthreads();
      } else {
#pragma unroll
        for (int e = 0; e < PER_THREAD; ++e) {
          int i = tile_index(e);
          C okey = __shfl_xor_sync(0xffffffffu, v[e], j);
          int oidx = __shfl_xor_sync(0xffffffffu, p[e], j);
          cas(v[e], p[e], okey, oidx, (i & j) == 0,
              ((i & (n - 1)) & kk) == 0);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    int i = tile_index(e);
    int64_t g = base + i;
    int lane = i & (n - 1);
    if (g < n_keys && lane < k) {
      int64_t o = (g >> log2_n) * k + lane;
      vals[o] = K::out(v[e]);
      idx[o] = p[e];
    }
  }
}

template <typename T>
int launch_topk(const void* x, void* vals, void* idx, int64_t rows, int n,
                int k, cudaStream_t s) {
  if (n < 2 || n > TILE || (n & (n - 1)) || k < 1 || k > n || rows < 0)
    return (int)cudaErrorInvalidValue;
  int64_t n_keys = rows * n;
  if (n_keys == 0) return 0;
  k7_topk_kernel<T><<<(unsigned)((n_keys + TILE - 1) / TILE), THREADS, 0,
                      s>>>((const T*)x, (T*)vals, (int32_t*)idx, n_keys, n,
                           log2_of(n), k);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes: 0 float32, 1 int32, 2 bfloat16.
extern "C" int k7_topk(int dtype, const void* x, void* vals, void* idx,
                       int64_t rows, int n, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_topk<float>(x, vals, idx, rows, n, k, s);
    case 1: return launch_topk<int32_t>(x, vals, idx, rows, n, k, s);
    case 2: return launch_topk<__nv_bfloat16>(x, vals, idx, rows, n, k, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
