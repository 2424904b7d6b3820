// K8 — c6_flashattn, fused blockwise attention with a carried online
// softmax, for Hopper (sm_90a).
//
// Replaces the Pallas kernel
//   K8  src/repro/kernels/flashattn.py  flash_attention_pallas  (_attn_body)
// and computes what its body computes: logits s = (q·kᵀ)·scale in fp32,
// causal positions set to -1e30, a running max m that starts at -1e30, a
// running normaliser l and accumulator acc in fp32 (m_new = max(m, max s);
// p = exp(s - m_new); alpha = exp(m - m_new); l = l·alpha + Σp;
// acc = acc·alpha + p·v), and out = acc / max(l, 1e-30) cast to q's dtype.
// The causal mask is aligned bottom-right (key j is visible to query i iff
// j <= i + sk - sq), as ref.flash_attention aligns it; the TPU kernel takes
// causal attention only at sq == sk. k/v tiles wholly above the causal
// diagonal are skipped (there the TPU kernel's p is exactly 0 and alpha
// exactly 1); keys past sk get -inf, so their p is exactly 0. q, k, v and o
// are addressed through (batch, head, seq) strides with a unit head-dim
// stride, so (B, S, H, D) activations viewed as (B, H, S, D) are read in
// place. Head dims 16, 32, 64 and 128 are compile-time instances.
//
// What bounds it on the H100: at the LM prefill's shapes (bf16, causal,
// 1024 keys, D = 128) device-memory bytes (q, k, v read once, o written
// once) when the products run on the tensor cores at their bf16 rate.
//
// bfloat16 (the LM's path): the tensor cores, FA3's shape simplified.
//  * One block of 256 threads per (batch·head, 128-row q tile): two
//    consumer warpgroups of 64 q rows each; thread 0 also issues the TMA
//    loads. Causal q tiles go out heaviest first (the last tile first), so
//    the long blocks start early.
//  * The q tile is loaded once by TMA; k and v tiles of 128 rows pass
//    through a 2-stage ring in shared memory, fed by TMA and tracked with
//    mbarriers ("full": the tile arrived; "empty": both warpgroups are done
//    with it). The tensor maps are built on the host over the (B, H, S, D)
//    strided views with cuTensorMapEncodeTiled (looked up through
//    cudaGetDriverEntryPointByVersion), one box per 64 head-dim columns
//    (128 bytes, the swizzle span; 32 and 16 columns at D = 32 and 16 with
//    the 64 B and 32 B swizzles). TMA fills rows past the end with zeros.
//  * s = q·kᵀ: wgmma m64n128k16, q and k from shared memory (K-major,
//    descriptors matching TMA's swizzle), fp32 accumulators. bf16 products
//    are exact in fp32; the tensor cores sum them in an order of their own
//    and round the sums toward zero.
//  * The online softmax runs on the accumulator fragment in registers (fp32
//    m, l and the rescale), the row reductions over each quad of lanes.
//  * o += p·v: wgmma m64nNk16 (N = min(D, 64)) with A = p from registers
//    (the accumulator fragment re-packed as bf16 A fragments) and B = the v
//    tile in shared memory read through the transpose flag (v is stored
//    with D contiguous). p goes in as three bf16 terms, p1 = bf16(p),
//    p2 = bf16(p - p1) and p3 = bf16(p - p1 - p2) (the differences are
//    exact in fp32). Each term leaves at most 2^-8 of what it splits: p1
//    alone errs by up to 2^-8·p (2^-8·max|v| in the output), p1 + p2 by
//    2^-16·p, all three by 2^-24·p, fp32's own rounding. A k-step's three
//    wgmmas (16 keys) go into a fresh fp32 accumulator, which is then added
//    to the output's in fp32, rounding to nearest: the tensor cores round
//    each sum toward zero at the magnitude of their accumulator, and
//    chained over the row's keys those roundings lean one way at the
//    running total's magnitude. Chained, three terms left 4× as many
//    outputs beyond one bf16 ulp of the float64 result as the fp32 plain
//    version at unit-scale logits (experiments/k8_accumulation.py). It
//    costs 2× the algorithm's tensor-core work (q·kᵀ once, p·v three
//    times) and D/2 fp32 adds a thread a k-step.
//  * l is summed from the fp32 p; out = acc / max(l, 1e-30), rounded to
//    bf16 and stored through o's strides; rows past sq are not written.
//
// float32 (off the LM's path): tensor cores would round fp32 inputs to
// TF32, outside the fp32 bound, so it computes q·kᵀ and p·v as fp32 FMAs
// out of shared memory: one block per (batch·head, 64-row q tile), 64-row
// k/v tiles, 256 threads (thread (r, g) = (tid / 4, tid % 4) owns q row r,
// logits of columns g + 4·jj and output columns g + 4·jj; m and l reduced
// over the row's four threads with __shfl_xor_sync).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                     // q rows of a block
constexpr int BK = 64;                     // k/v rows of a tile
constexpr int THREADS = 256;               // 4 threads per q row
constexpr float NEG_INF = -1e30f;          // the TPU kernel's mask value

struct Strides {
  int64_t b, h, s;                         // the head-dim stride is 1
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
k8_flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int heads,
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;
  const int tid = threadIdx.x, r = tid >> 2, g = tid & 3;
  const int qi = q0 + r;
  const int off = sk - sq;                 // bottom-right causal alignment

  for (int x = tid; x < BQ * D; x += THREADS) {
    int rr = x / D, c = x % D;
    Qs[rr * LD + c] = q0 + rr < sq
        ? qb[(int64_t)(q0 + rr) * qs.s + c] : 0.f;
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
      Ks[rr * LD + c] = in ? kb[kr * ks.s + c] : 0.f;
      Vs[rr * D + c] = in ? vb[kr * vs.s + c] : 0.f;
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
      ob[(int64_t)qi * os.s + g + 4 * jj] = acc[jj] / den;
  }
}

template <int D>
int fma_launch(const void* q, const void* k, const void* v, void* o,
               int64_t batch, int heads, int sq, int sk, Strides qs,
               Strides ks, Strides vs, Strides os, float scale, int causal,
               cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      k8_flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  int n_qtiles = (sq + BQ - 1) / BQ;
  int64_t blocks = batch * heads * n_qtiles;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  k8_flash_kernel<D><<<(unsigned)blocks, THREADS, bytes, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, heads,
      sq, sk, n_qtiles, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

int fma_launch_d(int d, const void* q, const void* k, const void* v,
                 void* o, int64_t batch, int heads, int sq, int sk,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int causal, cudaStream_t st) {
  switch (d) {
    case 16: return fma_launch<16>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                   vs, os, scale, causal, st);
    case 32: return fma_launch<32>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                   vs, os, scale, causal, st);
    case 64: return fma_launch<64>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                   vs, os, scale, causal, st);
    case 128: return fma_launch<128>(q, k, v, o, batch, heads, sq, sk, qs,
                                     ks, vs, os, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int BM = 128;                    // q rows of a block (2 × 64)
constexpr int BN = 128;                    // k/v rows of a tile
constexpr int STAGES = 2;                  // the k/v ring
constexpr int THREADS = 256;               // two consumer warpgroups

template <int D>
struct Shape {
  static constexpr int PANEL = D < 64 ? D : 64;   // columns of one TMA box
  static constexpr int NPANEL = D / PANEL;
  static constexpr int ROWB = PANEL * 2;          // bytes of a swizzled row
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t SWZ = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int GROUP = 8 * ROWB;          // bytes of 8 rows (SBO)
  static constexpr int Q_PANEL = BM * ROWB;
  static constexpr int KV_PANEL = BN * ROWB;
  static constexpr int Q_BYTES = NPANEL * Q_PANEL;
  static constexpr int KV_BYTES = NPANEL * KV_PANEL;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + barriers, + slack to align the base to the 1024 B swizzle atom
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(bar) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// one (PANEL × rows) box of a (D, S, H, B) tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
         "r"(c3)
      : "memory");
}

// a wgmma shared-memory descriptor: start, leading and stride byte offsets,
// swizzle mode
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t swz) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swz << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving register reads or writes across the
// asynchronous wgmma (its results land at wait_group, not at the asm)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_frag(uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[j]) :: "memory");
}

// d (64×128, fp32) (+)= a·b: a and b bf16 in shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64×16, fp32) (+)= a·b: a bf16 in registers, b bf16 in shared
// memory, MN-major (the transpose flag set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64×32, fp32) (+)= a·b: a bf16 in registers, b bf16 in shared
// memory, MN-major (the transpose flag set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64×64, fp32) (+)= a·b: a bf16 in registers, b bf16 in shared
// memory, MN-major (the transpose flag set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64×N) (+)= a·b with A from registers, N = 16, 32 or 64
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, scale_d);
  else wgmma_rs_n64(d, a, b, scale_d);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) rounded to bf16 and packed; lo and hi keep what the rounding
// left out (exact in fp32)
__device__ __forceinline__ uint32_t pack_bf16_rest(float& lo, float& hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  const float2 f = __bfloat1622float2(v);
  lo -= f.x;
  hi -= f.y;
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
k8_flash_wgmma(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               __nv_bfloat16* __restrict__ o, int bh_count, int heads,
               int sq, int sk, int n_qtiles, Strides os, float scale,
               int causal) {
  using L = Shape<D>;
  constexpr int NS = BN / 2;               // logits of a thread per tile
  constexpr int NO = D / 2;                // output values of a thread
  constexpr int KSTEPS_QK = D / 16;
  constexpr int KSTEPS_PV = BN / 16;
  constexpr int NT = D < 64 ? D : 64;      // output columns of a p·v wgmma
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = (unsigned char*)(((uintptr_t)smem_raw + 1023) &
                                         ~(uintptr_t)1023);
  const uint32_t sbase = smem_addr(smem);
  const uint32_t q_s = sbase;
  auto k_s = [&](int st) { return sbase + L::Q_BYTES + st * 2 * L::KV_BYTES; };
  auto v_s = [&](int st) { return k_s(st) + L::KV_BYTES; };
  const uint32_t bar = sbase + L::BAR_OFF;  // q_full, full[2], empty[2]
  auto full = [&](int st) { return bar + 8 + 8 * st; };
  auto empty = [&](int st) { return bar + 24 + 8 * st; };

  // heaviest causal q tiles first
  const int id = blockIdx.x;
  const int qt = causal ? n_qtiles - 1 - id / bh_count : id / bh_count;
  const int bh = id % bh_count;
  const int b = bh / heads, h = bh % heads;
  const int q0 = qt * BM;
  const int off = sk - sq;                 // bottom-right causal alignment
  const int kv_end = causal ? min(sk, min(sq, q0 + BM) + off) : sk;
  const int n_kv = (kv_end + BN - 1) / BN;

  const int tid = threadIdx.x;
  if (tid == 0) {
    bar_init(bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      bar_init(full(st), 1);
      bar_init(empty(st), THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int j) {              // tile j into stage j % 2
    const int st = j % STAGES;
    bar_expect_tx(full(st), 2 * L::KV_BYTES);
#pragma unroll
    for (int p = 0; p < L::NPANEL; ++p) {
      tma_load(k_s(st) + p * L::KV_PANEL, &kmap, full(st), p * L::PANEL,
               j * BN, h, b);
      tma_load(v_s(st) + p * L::KV_PANEL, &vmap, full(st), p * L::PANEL,
               j * BN, h, b);
    }
  };
  if (tid == 0) {
    bar_expect_tx(bar, L::Q_BYTES);
#pragma unroll
    for (int p = 0; p < L::NPANEL; ++p)
      tma_load(q_s + p * L::Q_PANEL, &qmap, bar, p * L::PANEL, q0, h, b);
    for (int j = 0; j < STAGES && j < n_kv; ++j) load_kv(j);
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  // this thread's two rows of the accumulator fragments, and its columns
  const int qi0 = q0 + wg * 64 + warp * 16 + lane / 4, qi1 = qi0 + 8;
  const int col = 2 * (lane % 4);

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;

  bar_wait(bar, 0);                        // q has arrived
  for (int j = 0; j < n_kv; ++j) {
    const int st = j % STAGES;
    bar_wait(full(st), (j / STAGES) & 1);

    // s = q·kᵀ (64 × 128 for this warpgroup)
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS_QK; ++kk) {
      const int p = kk * 16 / L::PANEL, cb = (kk * 16 % L::PANEL) * 2;
      const uint64_t a = desc(q_s + p * L::Q_PANEL + wg * 64 * L::ROWB + cb,
                              16, L::GROUP, L::SWZ);
      const uint64_t bd = desc(k_s(st) + p * L::KV_PANEL + cb, 16, L::GROUP,
                               L::SWZ);
      wgmma_ss_n128(s, a, bd, kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // the online softmax on the fragment: s[4g + e] is row (e < 2 ? qi0 :
    // qi1), column 8g + col + (e & 1) of the tile
    const int k0 = j * BN;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kj = k0 + 8 * (i / 4) + col + (i & 1);
      const int qi = (i & 2) ? qi1 : qi0;
      float x = s[i] * scale;
      if (kj >= sk)
        x = -INFINITY;                     // no key: p = 0 exactly
      else if (causal && kj > qi + off)
        x = NEG_INF;
      s[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float pv = expf(s[i] - ((i & 2) ? mn1 : mn0));
      s[i] = pv;
      if (i & 2) sum1 += pv; else sum0 += pv;
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, d);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, d);
    }
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    l0 = l0 * al0 + sum0;
    l1 = l1 * al1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? al1 : al0;

    // acc += p·v with p as three bf16 terms, p1 = bf16(p),
    // p2 = bf16(p - p1), p3 = bf16(p - p1 - p2) (the differences are exact
    // in fp32), each an A fragment taken from the accumulator fragment:
    // k-step kk takes columns 16kk..16kk+15, its registers hold (row qi0,
    // cols 0-7), (qi1, 0-7), (qi0, 8-15), (qi1, 8-15). A k-step's three
    // products go into a fresh accumulator t, NT output columns a wgmma,
    // and t is added to acc in fp32 (see the design: the tensor cores
    // round their sums toward zero, at the magnitude of their accumulator).
#pragma unroll
    for (int kk = 0; kk < KSTEPS_PV; ++kk) {
      uint32_t a1[4], a2[4], a3[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 4 * (2 * kk + (r >> 1)) + 2 * (r & 1);
        float x0 = s[i], x1 = s[i + 1];
        a1[r] = pack_bf16_rest(x0, x1);
        a2[r] = pack_bf16_rest(x0, x1);
        a3[r] = pack_bf16(x0, x1);
      }
      float t[D / NT][NT / 2];
#pragma unroll
      for (int n = 0; n < D / NT; ++n) {
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) t[n][i] = 0.f;
        fence_regs(t[n]);
      }
      fence_frag(a1);
      fence_frag(a2);
      fence_frag(a3);
      wg_fence();
#pragma unroll
      for (int n = 0; n < D / NT; ++n) {
        const uint64_t bd = desc(v_s(st) + n * L::KV_PANEL + kk * 16 * L::ROWB,
                                 L::KV_PANEL, L::GROUP, L::SWZ);
        wgmma_pv<NT>(t[n], a1, bd, 0);
        wgmma_pv<NT>(t[n], a2, bd, 1);
        wgmma_pv<NT>(t[n], a3, bd, 1);
      }
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int n = 0; n < D / NT; ++n) {
        fence_regs(t[n]);
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[n * NT / 2 + i] += t[n][i];
      }
    }

    bar_arrive(empty(st));                 // this thread is done with it
    if (tid == 0 && j + STAGES < n_kv) {
      bar_wait(empty(st), (j / STAGES) & 1);
      load_kv(j + STAGES);
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-30) in bf16; acc[4g + e]: row (e < 2 ? qi0 :
  // qi1), column 8g + col + (e & 1)
  __nv_bfloat16* ob = o + (int64_t)b * os.b + (int64_t)h * os.h;
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int c = 8 * g + col;
    if (qi0 < sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)qi0 * os.s + c) =
          pack_bf16(acc[4 * g] / den0, acc[4 * g + 1] / den0);
    if (qi1 < sq)
      *reinterpret_cast<uint32_t*>(ob + (int64_t)qi1 * os.s + c) =
          pack_bf16(acc[4 * g + 2] / den1, acc[4 * g + 3] / den1);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda at build time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// a (D, S, H, B) map of a bf16 (B, H, S, D) view with a unit D stride;
// boxes of (PANEL, 128, 1, 1) with the swizzle of a PANEL-column row
template <int D>
bool make_map(CUtensorMap* map, const void* base, int64_t batch, int heads,
              int s, Strides st) {
  using L = Shape<D>;
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)heads,
                        (cuuint64_t)batch};
  cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                           (cuuint64_t)st.b * 2};
  cuuint32_t box[4] = {(cuuint32_t)L::PANEL, 128, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUtensorMapSwizzle swz = L::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : L::ROWB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           int64_t batch, int heads, int sq, int sk, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, int causal, cudaStream_t st) {
  using L = Shape<D>;
  CUtensorMap qm, km, vm;
  if (!make_map<D>(&qm, q, batch, heads, sq, qs) ||
      !make_map<D>(&km, k, batch, heads, sk, ks) ||
      !make_map<D>(&vm, v, batch, heads, sk, vs))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      k8_flash_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qtiles = (sq + BM - 1) / BM;
  const int64_t bh = batch * heads;
  const int64_t blocks = bh * n_qtiles;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  k8_flash_wgmma<D><<<(unsigned)blocks, THREADS, L::SMEM, st>>>(
      qm, km, vm, (__nv_bfloat16*)o, (int)bh, heads, sq, sk, n_qtiles, os,
      scale, causal);
  return (int)cudaGetLastError();
}

int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int64_t batch, int heads, int sq, int sk, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, int causal,
             cudaStream_t st) {
  switch (d) {
    case 16: return launch<16>(q, k, v, o, batch, heads, sq, sk, qs, ks, vs,
                               os, scale, causal, st);
    case 32: return launch<32>(q, k, v, o, batch, heads, sq, sk, qs, ks, vs,
                               os, scale, causal, st);
    case 64: return launch<64>(q, k, v, o, batch, heads, sq, sk, qs, ks, vs,
                               os, scale, causal, st);
    case 128: return launch<128>(q, k, v, o, batch, heads, sq, sk, qs, ks,
                                 vs, os, scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
      return fma_launch_d(d, q, k, v, o, batch, heads, sq, sk, qs, ks, vs,
                          os, scale, causal, st);
    case 2:
      return tc::launch_d(d, q, k, v, o, batch, heads, sq, sk, qs, ks, vs, os,
                          scale, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
