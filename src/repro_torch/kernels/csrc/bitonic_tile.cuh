// The tile of the bitonic-network kernels (sortnet.cu: K5, K6; topk.cu:
// K7's full network). A block holds TILE keys in registers, PER_THREAD a
// thread. In K7's full network key e of a thread sits at tile index
// ((warp * PER_THREAD + e) << 5) | lane (tile_index), so a partner at
// distance j < 32 is lane ^ j of the same warp (__shfl_xor_sync) and
// larger distances go through shared memory; K5 and K6 have layouts of
// their own (sortnet.cu). K5 and K6 compare keys in Key<T>::C: bf16 as
// float (__bfloat162float is exact, and Key::out takes the bits back, so
// keys leave as they came, NaN too); K7 compares their sortable integer
// form (topk.cu, Order<T>).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 4096;       // keys per block: the largest chunk or row
constexpr int PER_THREAD = TILE / THREADS;

template <typename T>
struct Key {                               // storage type -> compare type
  using C = T;
  static __device__ __forceinline__ C in(T v) { return v; }
  static __device__ __forceinline__ T out(C v) { return v; }
};

template <>
struct Key<__nv_bfloat16> {
  using C = float;
  static __device__ __forceinline__ C in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(C v) {
    // v came from a bf16: its upper 16 bits are that bf16, NaN payloads
    // included (__float2bfloat16 would make every NaN the canonical one)
    return __ushort_as_bfloat16((unsigned short)(__float_as_uint(v) >> 16));
  }
};

__device__ __forceinline__ int tile_index(int e) {
  return (((threadIdx.x >> 5) * PER_THREAD + e) << 5) | (threadIdx.x & 31);
}

int log2_of(int w) {
  int l = 0;
  while ((1 << l) < w) ++l;
  return l;
}

}  // namespace
