// K4's contiguous-rows entry past 64 columns as a fold in CUDA C++: the
// design timed against the port's route for those rows (the former
// Gluon kernel of src/repro_torch/kernels/prefix_scan.py) and not kept,
// because it was slower at every such shape
// (experiments/k1_k4_redesign.py --k4-rows builds and times it; PERF.md).
//
// A row is cut into segments of SEG columns, a thread each, folded alone
// and joined by a carry folded over the segment ends; y = a·y + b, each
// product and add rounded alone in T.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace k4rows {

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

// a·b rounded once in T (the segments' running decay product)
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a), __bfloat162float(b)));
}
__device__ __forceinline__ __half mul(__half a, __half b) {
  return __float2half_rn(__fmul_rn(__half2float(a), __half2float(b)));
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
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& x) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = x;
}

constexpr int SEG = 32;            // columns of a segment
constexpr int SEG_THREADS = 128;

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

// (rows, cols) operands past 64 columns: a block a row, nt threads
// (whole warps, at most SEG_THREADS), the walk (walk order, REV from the
// last column) cut into segments of SEG columns, thread k of a window of
// nt segments taking segment k. The window moves through shared memory
// in chunks of VEC elements (16 bytes where the row allows): coalesced
// loads and stores, chunk v of segment k at k·CPS + (v ^ k mod CPS) (CPS
// chunks a segment), so that each thread reads its own segment without
// bank conflicts. Pass 1: a thread folds its segment from 0 (l) beside
// the running product of its decays (q), keeping both, and puts the last
// (q, l) in shared memory. Thread 0 folds them in order into the carry
// entering each segment, c = q·c + l (the fold's value at the segment's
// end; segment 0's is its l), carried on to the next window. Pass 2:
// y = q·c + l over the thread's segment, and in segment 0 y = l (the
// fold itself), back through shared memory to coalesced stores.
template <typename T, int VEC, bool REV>
__global__ void __launch_bounds__(SEG_THREADS)
k4_seg_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ out, int64_t cols, int64_t stride_a,
              int64_t stride_b) {
  using P = Pack<T, VEC>;
  constexpr int CPS = SEG / VEC, BATCH = 8;
  extern __shared__ __align__(16) unsigned char k4_seg_smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  P* sa = reinterpret_cast<P*>(k4_seg_smem);
  P* sb = sa + nt * CPS;
  T* sq = reinterpret_cast<T*>(sb + nt * CPS);
  T* sl = sq + nt;
  T* sc = sl + nt;
  const int64_t row = blockIdx.x;
  const T* ar = a + row * stride_a;
  const T* br = b + row * stride_b;
  T* orow = out + row * cols;
  const int64_t nseg = (cols + SEG - 1) / SEG;
  const int mine = tid * CPS, sw = tid & (CPS - 1);
  T carry = T(0.0f);                          // thread 0's
  for (int64_t k0 = 0; k0 < nseg; k0 += nt) {
    const int64_t w0 = k0 * SEG;             // the window's first step
    const int nch =
        (int)((min((int64_t)nt * SEG, cols - w0) + VEC - 1) / VEC);
    for (int g0 = 0; g0 < nch; g0 += nt * BATCH) {
      P ra[BATCH], rb[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int g = g0 + i * nt + tid;
        if (g < nch) {
          const int64_t c = REV ? cols - w0 - (int64_t)(g + 1) * VEC
                                : w0 + (int64_t)g * VEC;
          ra[i] = load_pack<T, VEC>(ar + c);
          rb[i] = load_pack<T, VEC>(br + c);
        }
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int g = g0 + i * nt + tid;
        if (g < nch) {
          const int k = g / CPS, v = g % CPS;
          sa[k * CPS + (v ^ (k & (CPS - 1)))] = ra[i];
          sb[k * CPS + (v ^ (k & (CPS - 1)))] = rb[i];
        }
      }
    }
    __syncthreads();
    const int64_t k = k0 + tid;
    const int n = k < nseg ? (int)min((int64_t)SEG, cols - k * SEG) : 0;
    T lv[SEG], qv[SEG];
    T q = T(1.0f), l = T(0.0f);
#pragma unroll
    for (int v = 0; v < CPS; ++v) {
      if (v * VEC < n) {
        const P x = sa[mine + (v ^ sw)], y = sb[mine + (v ^ sw)];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const int i = v * VEC + e, ee = REV ? VEC - 1 - e : e;
          l = fold(x.v[ee], l, y.v[ee]);
          q = i ? mul(q, x.v[ee]) : x.v[ee];
          lv[i] = l;
          qv[i] = q;
        }
      }
    }
    sq[tid] = q;
    sl[tid] = l;
    __syncthreads();
    if (tid == 0) {
      const int m = (int)min((int64_t)nt, nseg - k0);
      for (int u0 = 0; u0 < m; u0 += 8) {
        T qq[8], ll[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (u0 + i < m) {
            qq[i] = sq[u0 + i];
            ll[i] = sl[u0 + i];
          }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (u0 + i < m) {
            sc[u0 + i] = carry;
            carry = k0 + u0 + i ? fold(qq[i], carry, ll[i]) : ll[i];
          }
        }
      }
    }
    __syncthreads();
    if (n) {
      const T c = sc[tid];
#pragma unroll
      for (int v = 0; v < CPS; ++v) {
        if (v * VEC < n) {
          P o;
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int i = v * VEC + e;
            o.v[REV ? VEC - 1 - e : e] = k ? fold(qv[i], c, lv[i]) : lv[i];
          }
          sb[mine + (v ^ sw)] = o;
        }
      }
    }
    __syncthreads();
    for (int g = tid; g < nch; g += nt) {
      const int kk = g / CPS, v = g % CPS;
      store<T, VEC>(orow + (REV ? cols - w0 - (int64_t)(g + 1) * VEC
                                : w0 + (int64_t)g * VEC),
                    sb[kk * CPS + (v ^ (kk & (CPS - 1)))]);
    }
    __syncthreads();                          // the next window's buffers
  }
}

template <typename T, int VEC, bool REV>
int launch_seg(const void* a, const void* b, void* out, int64_t rows,
               int64_t cols, int64_t stride_a, int64_t stride_b,
               cudaStream_t st) {
  // a block a row: threads for its segments, whole warps, at most
  // SEG_THREADS, or 64 for 8-byte elements (the window's shared memory)
  const int64_t nseg = (cols + SEG - 1) / SEG;
  const int most = sizeof(T) == 8 ? SEG_THREADS / 2 : SEG_THREADS;
  int nt = 32;
  while (nt < nseg && nt < most) nt *= 2;
  if (rows >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * nt * SEG * sizeof(T) + 3 * nt * sizeof(T);
  k4_seg_kernel<T, VEC, REV><<<(unsigned)rows, nt, smem, st>>>(
      (const T*)a, (const T*)b, (T*)out, cols, stride_a, stride_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(int vec, const void* a, const void* b, void* out, int64_t rows,
           int64_t cols, int64_t stride_a, int64_t stride_b, int reverse,
           cudaStream_t st) {
  constexpr int V16 = 16 / (int)sizeof(T);
  if (vec == V16 && (cols % V16 || stride_a % V16 || stride_b % V16))
    return (int)cudaErrorInvalidValue;
#define SEG_LAUNCH(V, R)                                                    \
  return launch_seg<T, V, R>(a, b, out, rows, cols, stride_a, stride_b, st)
  if (vec == V16) {
    if (reverse) SEG_LAUNCH(V16, true);
    SEG_LAUNCH(V16, false);
  }
  if constexpr (V16 > 1) {
    if (vec == 1) {
      if (reverse) SEG_LAUNCH(1, true);
      SEG_LAUNCH(1, false);
    }
  }
#undef SEG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace k4rows

// The segmented fold on (rows, cols) operands, a and b of one dtype with
// row strides stride_a, stride_b and a unit column stride; out
// contiguous. vec: 16 bytes of elements or 1. dtype codes: 0 float32,
// 1 float64, 2 bfloat16, 3 float16.
extern "C" int k4_seg_scan(int dtype, const void* a, const void* b,
                           void* out, int64_t rows, int64_t cols,
                           int64_t stride_a, int64_t stride_b, int vec,
                           int reverse, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define SEG_ARGS vec, a, b, out, rows, cols, stride_a, stride_b, reverse, s
  switch (dtype) {
    case 0: return k4rows::launch<float>(SEG_ARGS);
    case 1: return k4rows::launch<double>(SEG_ARGS);
    case 2: return k4rows::launch<__nv_bfloat16>(SEG_ARGS);
    case 3: return k4rows::launch<__half>(SEG_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SEG_ARGS
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
