// K8 — c6_flashattn, fused blockwise attention with a carried online
// softmax, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   K8  src/repro/kernels/flashattn.py  flash_attention_pallas  (_attn_body)
// and computes what its body computes: q and k in fp32, logits
// s = (q·kᵀ)·scale, causal positions set to -1e30, a running max m that
// starts at -1e30, a running normaliser l and accumulator acc in fp32
// (m_new = max(m, max s); p = exp(s - m_new); alpha = exp(m - m_new);
// l = l·alpha + Σp; acc = acc·alpha + p·v), and out = acc / max(l, 1e-30)
// cast to q's dtype. The causal mask is aligned bottom-right (key j is
// visible to query i iff j <= i + sk - sq), as ref.flash_attention aligns
// it; the TPU kernel takes causal attention only at sq == sk.
//
// What bounds it on the H100: at the LM prefill's shapes, device-memory
// bytes (q, k, v read once, o written once) if the products ran on the
// tensor cores; this first version runs them as fp32 FMAs on the CUDA
// cores out of shared memory, so its time is set by shared-memory loads
// (about one per FMA). Tensor cores (wgmma) are later work. The design:
//
//  * One block per (batch·head, 64-row q tile); its q tile stays in shared
//    memory, and it loops over 64-row k/v tiles staged in shared memory
//    (fp32, rows padded by one word so column walks hit distinct banks).
//  * 256 threads: thread (r, g) = (tid / 4, tid % 4) owns q row r, logits
//    of columns g + 4·jj and output columns g + 4·jj; m and l live in the
//    registers of the row's four threads and are reduced over them with
//    __shfl_xor_sync.
//  * k/v tiles wholly above the causal diagonal are skipped: there the TPU
//    kernel's p is exactly 0 and alpha exactly 1, so the result is the same.
//    Keys past sk (a ragged last tile) get -inf, so their p is exactly 0.
//  * q, k, v and o are addressed through (batch, head, seq) strides with a
//    unit head-dim stride, so (B, S, H, D) activations viewed as
//    (B, H, S, D) are read in place, without a transposing copy.
//  * Head dims 16, 32, 64 and 128 are compile-time instances.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                     // q rows of a block
constexpr int BK = 64;                     // k/v rows of a tile
constexpr int THREADS = 256;               // 4 threads per q row
constexpr float NEG_INF = -1e30f;          // the TPU kernel's mask value

template <typename T>
struct F {
  static __device__ __forceinline__ float in(T v) { return v; }
  static __device__ __forceinline__ T out(float v) { return v; }
};

template <>
struct F<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float v) {
    return __float2bfloat16(v);            // round to nearest even
  }
};

struct Strides {
  int64_t b, h, s;                         // the head-dim stride is 1
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
k8_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ o, int heads,
                int sq, int sk, int n_qtiles, Strides qs, Strides ks,
                Strides vs, Strides os, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int PD = BK + 1;
  constexpr int NS = BK / 4;               // logits of a thread per tile
  constexpr int NO = D / 4;                // output columns of a thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // BQ × LD
  float* Ks = Qs + BQ * LD;                // BK × LD
  float* Vs = Ks + BK * LD;                // BK × D
  float* Ps = Vs + BK * D;                 // BQ × PD

  const int64_t bh = blockIdx.x / n_qtiles;
  const int q0 = (int)(blockIdx.x % n_qtiles) * BQ;
  const int64_t b = bh / heads, h = bh % heads;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;
  const int tid = threadIdx.x, r = tid >> 2, g = tid & 3;
  const int qi = q0 + r;
  const int off = sk - sq;                 // bottom-right causal alignment

  for (int x = tid; x < BQ * D; x += THREADS) {
    int rr = x / D, c = x % D;
    Qs[rr * LD + c] = q0 + rr < sq
        ? F<T>::in(qb[(int64_t)(q0 + rr) * qs.s + c]) : 0.f;
  }

  // keys past the block's last visible one lie wholly above the diagonal
  int kv_end = sk;
  if (causal) kv_end = min(sk, min(sq, q0 + BQ) + off);

  float m = NEG_INF, l = 0.f;
  float acc[NO];
#pragma unroll
  for (int jj = 0; jj < NO; ++jj) acc[jj] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();                       // the last tile's reads are done
    for (int x = tid; x < BK * D; x += THREADS) {
      int rr = x / D, c = x % D;
      bool in = k0 + rr < sk;
      int64_t kr = (int64_t)(k0 + rr);
      Ks[rr * LD + c] = in ? F<T>::in(kb[kr * ks.s + c]) : 0.f;
      Vs[rr * D + c] = in ? F<T>::in(vb[kr * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) s[jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv = Qs[r * LD + d];
#pragma unroll
      for (int jj = 0; jj < NS; ++jj)
        s[jj] = fmaf(qv, Ks[(g + 4 * jj) * LD + d], s[jj]);
    }

    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      int kj = k0 + g + 4 * jj;
      float x = s[jj] * scale;
      if (kj >= sk)
        x = -INFINITY;                     // no key: p = 0 exactly
      else if (causal && kj > qi + off)
        x = NEG_INF;
      s[jj] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      sum += s[jj];
      Ps[r * PD + g + 4 * jj] = s[jj];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    __syncthreads();                       // the row's p is in Ps

    float pv[NO];
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) pv[jj] = 0.f;
    for (int c = 0; c < BK; ++c) {
      float p = Ps[r * PD + c];
#pragma unroll
      for (int jj = 0; jj < NO; ++jj)
        pv[jj] = fmaf(p, Vs[c * D + g + 4 * jj], pv[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < NO; ++jj) acc[jj] = acc[jj] * alpha + pv[jj];
  }

  if (qi < sq) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NO; ++jj)
      ob[(int64_t)qi * os.s + g + 4 * jj] = F<T>::out(acc[jj] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int heads, int sq, int sk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      k8_flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int n_qtiles = (sq + BQ - 1) / BQ;
  int64_t blocks = batch * heads * n_qtiles;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  k8_flash_kernel<T, D><<<(unsigned)blocks, THREADS, bytes, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, heads, sq, sk, n_qtiles,
      qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int64_t batch, int heads, int sq, int sk, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             cudaStream_t st) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                  vs, os, scale, causal, st);
    case 32: return launch<T, 32>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                  vs, os, scale, causal, st);
    case 64: return launch<T, 64>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                  vs, os, scale, causal, st);
    case 128: return launch<T, 128>(q, k, v, o, batch, heads, sq, sk, qs,
                                    ks, vs, os, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (batch, heads, sq, d), k and v (batch, heads, sk, d), o like q, each
// given by its (batch, head, seq) element strides with a unit d stride.
// dtype codes: 0 float32, 2 bfloat16 (q, k, v and o share it).
extern "C" int k8_flash_attention(
    int dtype, int d, const void* q, const void* k, const void* v, void* o,
    int64_t batch, int heads, int sq, int sk, int64_t q_sb, int64_t q_sh,
    int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
    int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss,
    float scale, int causal, void* stream) {
  if (batch < 0 || heads < 1 || sq < 0 || sk < 1 || (causal && sq > sk))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || sq == 0) return 0;
  Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch_d<float>(d, q, k, v, o, batch, heads, sq, sk, qs, ks, vs,
                             os, scale, causal, st);
    case 2:
      return launch_d<__nv_bfloat16>(d, q, k, v, o, batch, heads, sq, sk, qs,
                                     ks, vs, os, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
