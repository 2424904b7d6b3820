// SSD chunk output — the Mamba2 SSD mixer's whole chunk output in
// prefill, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package leaves the chunked SSD's
// quadratic intra-chunk term to XLA (src/repro/models/ssm.py, the
// (B, C, Q, Q, H) decay and weight tensors and two einsums), and so did
// the port's eager chain (models/ssm.py): at Mamba2-1.3B's prefill of
// 8 × 8192 tokens that chain made about 13 float32 passes over a 4.3 GB
// tensor a layer and half of the card's time. This kernel computes the
// boundary of the published Mamba2 chunk-scan forward (state-spaces/mamba,
// ssd_chunk_scan): for each (batch b, chunk c, head h) and each row i of
// the chunk,
//
//   y[i] = Σ_{j ≤ i} g[i,j] · exp(cum_i − cum_j) · dt_j · x[j]     (intra)
//        + exp(cum_i) · C[i] · run[c−1]ᵀ                           (inter)
//        + D[h] · x[i]                                             (skip)
//
// with g = C·Bᵀ (the small float32 einsum, computed before the launch),
// cum the chunk's cumulative log-decay, run the states after each chunk
// (K4's output, read in place: no shifted copy; zero for c = 0), and
// writes y once, rounded from float32 to the output's type (bf16 on the
// path, float32 for the tests' comparisons). exp never sees a positive
// argument: cum falls along the chunk, k-steps above the diagonal are
// skipped, and within the diagonal k-step exp sees 0 where j > i.
//
// What bounds it on the H100: device-memory bytes. A launch reads x and
// the states once and writes y once (at Mamba2-1.3B's widths and 8 × 8192
// tokens 0.54 + 0.52 GB read, 0.54 GB written a layer); g, C, cum and dt
// are small and shared by the heads of a chunk, whose blocks are
// adjacent in the grid, so L2 serves their repeats. It reaches about a
// quarter of that bound: at 16 warps an SM (registers and shared memory
// allow two blocks) a block's load phase and its products barely
// overlap with the other block's.
//
// Precision: the eager chain's products are full float32. x and C hold
// bf16 values, exact as bf16 tensor-core operands; the weights
// w = (exp(cum_i − cum_j)·g)·dt_j (rounded in that order, as the chain
// rounds them; below the diagonal the exp is a product of two factors,
// below) and the states are not, so each goes in as PIECES bf16
// terms, t1 = bf16(v), t2 = bf16(v − t1), t3 = bf16(v − t1 − t2) (the
// differences exact in fp32), each product of a term with a bf16 value
// exact in fp32. A term leaves at most 2^-8 of what it splits; three hold
// a float32 value exactly (24 significant bits in three of 8) while each
// term stays in bf16's normal range; one term (PIECES = 1, the tests'
// negative control) errs by up to 2^-8·|v|. The tensor cores round each
// sum toward zero at the magnitude of their accumulator, so a fresh fp32
// accumulator takes the mma.syncs of at most 4 k-steps of 16 (12 with
// three terms) and is then added to the output's accumulator in fp32,
// rounding to nearest (the lesson of K8's p·v: chained roundings toward
// zero lean one way).
//
// Design:
//  * One block of Q threads per (b, c, h), heads fastest in the grid.
//    The block's Q/32 warps each own two 16-row tiles of the chunk,
//    r and R−1−r (R = Q/16), so every warp does R+1 causal k-steps of 16
//    keys: the triangle shared evenly, no j-tile above the diagonal.
//  * Shared memory: the chunk's x rows (Q × 64 bf16, head dims past P
//    zero; rows padded to 72 for conflict-free ldmatrix), the previous
//    state split into PIECES bf16 tiles (64 × N, rows padded by 8), and
//    the chunk's cum, dt and exp table of this head. Loaded once: x by
//    cp.async while each thread keeps BATCH 16-byte state loads in flight
//    before it splits any (taken one at a time, their latency sets a
//    tenth of the kernel's time), then a barrier.
//  * Products: mma.sync m16n8k16 bf16 → fp32. Intra: A = w, built in
//    registers from g (read from L2 in the A fragment's own layout:
//    four threads a 32-byte sector), cum and dt, split into its terms.
//    Below the diagonal, exp(cum_i − cum_j) is taken as exp(cum_i − cum_e)
//    · exp(cum_e − cum_j), e the k-step's last key: both factors ≤ 1 (no
//    overflow; where one underflows so does the exp), two exps a thread a
//    k-step in place of eight, the second factor from a table the block
//    fills once, and the weight within a few ulps of the chain's;
//    B = x tiles through ldmatrix.trans. Inter: A = C rows (read from L2
//    the same way), B = the state's terms through ldmatrix; summed over
//    N, then scaled by exp(cum_i) in the output's accumulator, before
//    the intra term joins it.
//  * Epilogue: + D·x[i] (fp32, rounded alone: the chain's x·D then +),
//    one rounding to the output type, 4- or 8-byte stores of column
//    pairs (P even).
// Shapes taken: Q a multiple of 32 up to 256, P even up to 64, N a
// multiple of 16 up to 128; x and C bf16; g, cum, dt, run and D float32,
// all contiguous. Offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PMAX = 64;                 // head dims of a block, padded
constexpr int XPITCH = PMAX + 8;         // x row pitch in shared memory
constexpr int QMAX = 256;                // chunk rows (and threads) of a block
constexpr int NMAX = 128;                // state size
constexpr int GROUP = 4;                 // k-steps into one fresh accumulator
constexpr int NT = PMAX / 8;             // n-tiles of 8 head dims
constexpr int BATCH = 8;                 // state loads a thread keeps in flight

struct Args {
  const __nv_bfloat16* x;                // (B, S, H, P)
  const __nv_bfloat16* c;                // (B, S, N)
  const float* g;                        // (B, NC, Q, Q)
  const float* cum;                      // (B, S, H): (B, NC, Q, H)
  const float* dt;                       // (B, S, H)
  const float* run;                      // (B, NC, H, P, N)
  const float* d;                        // (H,)
  void* y;                               // (B, S, H, P)
  int nc, q, h, p, n;
};

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

// the k-th of PIECES terms of (lo, hi), which keep the rest
template <int PIECES>
__device__ __forceinline__ uint32_t term(int k, float& lo, float& hi) {
  return k + 1 < PIECES ? pack_bf16_rest(lo, hi) : pack_bf16(lo, hi);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously (no registers)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a · b, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero(float (&t)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) t[nt][e] = 0.f;
}

__device__ __forceinline__ void add_into(float (&out)[NT][4],
                                         const float (&t)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nt][e] = __fadd_rn(out[nt][e], t[nt][e]);
}

// the weight g·exp(cum_i − cum_j)·dt_j, rounded as the eager chain rounds
// it ((exp · g) · dt); above the diagonal (keep false) exp sees 0 and the
// weight is 0: the eager chain's double where
__device__ __forceinline__ float weight(bool keep, float ci, float cj,
                                        float gij, float dtj) {
  const float e = expf(keep ? __fsub_rn(ci, cj) : 0.f);
  return keep ? __fmul_rn(__fmul_rn(e, gij), dtj) : 0.f;
}

// the same weight below the diagonal from its two exp factors:
// ((er · ec) · g) · dt
__device__ __forceinline__ float scaled(float er, float ec, float gij,
                                        float dtj) {
  return __fmul_rn(__fmul_rn(__fmul_rn(er, ec), gij), dtj);
}

__device__ __forceinline__ uint32_t ldg_pair(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ void store_pair(float* y, float v0, float v1) {
  *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* y, float v0,
                                           float v1) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
}

template <int PIECES>
size_t smem_bytes(int q, int n) {
  return sizeof(__nv_bfloat16) *
             ((size_t)q * XPITCH + (size_t)PIECES * PMAX * (n + 8)) +
         sizeof(float) * 3 * (size_t)q;
}

template <typename Out, int PIECES>
__global__ void __launch_bounds__(QMAX, 2) ssd_chunk_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = a.q, heads = a.h, P = a.p, N = a.n, rpitch = N + 8;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // [q][XPITCH]
  __nv_bfloat16* rs = xs + (size_t)q * XPITCH;   // [PIECES][PMAX][rpitch]
  float* cs = reinterpret_cast<float*>(rs + (size_t)PIECES * PMAX * rpitch);
  float* ds = cs + q;
  float* es = ds + q;       // exp(cum at the end of j's 16-key step − cum_j)

  const int hh = blockIdx.x % heads;
  const int bc = blockIdx.x / heads;            // b · nc + c
  const int c = bc % a.nc;
  const int64_t row0 = (int64_t)bc * q;         // the chunk's first row, b·S + c·Q
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // ---- loads: x rows (asynchronous copies where P is 64), the previous
  // state's terms (BATCH loads a thread in flight before any is split),
  // cum and dt of this head
  const int64_t xrow = (int64_t)heads * P;      // x's (and y's) row stride
  const __nv_bfloat16* xb = a.x + row0 * xrow + (int64_t)hh * P;
  if (P == PMAX) {
    for (int e = tid; e < q * (PMAX / 8); e += nthreads) {  // 16-byte chunks
      const int i = e / (PMAX / 8), k = e % (PMAX / 8);
      cp_async16(xs + i * XPITCH + k * 8, xb + i * xrow + k * 8);
    }
  } else {
    for (int e = tid; e < q * PMAX; e += nthreads) {
      const int i = e / PMAX, k = e % PMAX;
      xs[i * XPITCH + k] = k < P ? xb[i * xrow + k] : __float2bfloat16(0.f);
    }
  }
  if (c > 0) {
    const float* rb = a.run + ((int64_t)(bc - 1) * heads + hh) * P * N;
    const int quads = N / 4, total = PMAX * quads;
    for (int base = tid; base < total; base += BATCH * nthreads) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = base + u * nthreads, pr = e / quads;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < total && pr < P)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              rb + (int64_t)pr * N + (e % quads) * 4));
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = base + u * nthreads, pr = e / quads;
        if (e >= total) break;
#pragma unroll
        for (int t = 0; t < PIECES; ++t) {
          const uint32_t lo = term<PIECES>(t, v[u].x, v[u].y);
          const uint32_t hi = term<PIECES>(t, v[u].z, v[u].w);
          *reinterpret_cast<uint2*>(rs + ((size_t)t * PMAX + pr) * rpitch +
                                    (e % quads) * 4) = make_uint2(lo, hi);
        }
      }
    }
  }
  for (int i = tid; i < q; i += nthreads) {
    const int64_t o = (row0 + i) * heads + hh;
    cs[i] = a.cum[o];
    ds[i] = a.dt[o];
  }
  cp_async_wait_all();
  __syncthreads();
  for (int j = tid; j < q; j += nthreads)
    es[j] = expf(__fsub_rn(cs[j | 15], cs[j]));
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t4 = lane & 3;
  const int R = q / 16;
  const float dh = a.d[hh];
  // ldmatrix lane offsets: x (trans; rows j, cols p) and the state (rows p,
  // cols n), each x4 covering two n-tiles of one k-step
  const int xr = (lane & 7) + ((lane >> 3) & 1) * 8, xc = (lane >> 4) * 8;
  const int sr = (lane & 7) + (lane >> 4) * 8, sc = ((lane >> 3) & 1) * 8;

#pragma unroll 1
  for (int side = 0; side < 2; ++side) {
    const int r = side == 0 ? R - 1 - warp : warp;   // this warp's row tile
    const int i0 = r * 16;
    float out[NT][4], acc[NT][4];
    zero(out);

    // ---- inter: exp(cum_i) · Σ_n C[i,n] · run[c−1][p,n]
    if (c > 0) {
      const __nv_bfloat16* cr0 = a.c + (row0 + i0 + gid) * N + 2 * t4;
      const __nv_bfloat16* cr1 = cr0 + 8 * (int64_t)N;
      uint32_t an[4] = {ldg_pair(cr0), ldg_pair(cr1), ldg_pair(cr0 + 8),
                        ldg_pair(cr1 + 8)};
#pragma unroll 1
      for (int ks = 0; ks < N / 16; ++ks) {
        if (ks % GROUP == 0) zero(acc);
        const int k0 = ks * 16;
        const uint32_t af[4] = {an[0], an[1], an[2], an[3]};
        if (ks + 1 < N / 16) {          // the next k-step's C in flight
          an[0] = ldg_pair(cr0 + k0 + 16);
          an[1] = ldg_pair(cr1 + k0 + 16);
          an[2] = ldg_pair(cr0 + k0 + 24);
          an[3] = ldg_pair(cr1 + k0 + 24);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
          for (int t = 0; t < PIECES; ++t) {
            uint32_t b[4];
            ldsm_x4(b, smem_addr(rs + ((size_t)t * PMAX + np * 16 + sr) *
                                          rpitch + k0 + sc));
            mma(acc[2 * np], af, b[0], b[1]);
            mma(acc[2 * np + 1], af, b[2], b[3]);
          }
        }
        if (ks % GROUP == GROUP - 1 || ks == N / 16 - 1) add_into(out, acc);
      }
      const float e0 = expf(cs[i0 + gid]), e1 = expf(cs[i0 + gid + 8]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        out[nt][0] *= e0;
        out[nt][1] *= e0;
        out[nt][2] *= e1;
        out[nt][3] *= e1;
      }
    }

    // ---- intra: Σ_{j ≤ i} w[i,j] · x[j], k-steps of 16 keys up to the
    // diagonal; w built in registers, its next k-step's g loads in flight
    const float ci0 = cs[i0 + gid], ci1 = cs[i0 + gid + 8];
    const float* gr0 = a.g + ((int64_t)bc * q + i0 + gid) * q + 2 * t4;
    const float* gr1 = gr0 + 8 * (int64_t)q;
    float2 gn[4] = {__ldg(reinterpret_cast<const float2*>(gr0)),
                    __ldg(reinterpret_cast<const float2*>(gr1)),
                    __ldg(reinterpret_cast<const float2*>(gr0 + 8)),
                    __ldg(reinterpret_cast<const float2*>(gr1 + 8))};
#pragma unroll 1
    for (int ks = 0; ks <= r; ++ks) {
      if (ks % GROUP == 0) zero(acc);
      const int j0 = ks * 16;
      const float2 g00 = gn[0], g10 = gn[1], g01 = gn[2], g11 = gn[3];
      if (ks < r) {
        const int jn = j0 + 16;
        gn[0] = __ldg(reinterpret_cast<const float2*>(gr0 + jn));
        gn[1] = __ldg(reinterpret_cast<const float2*>(gr1 + jn));
        gn[2] = __ldg(reinterpret_cast<const float2*>(gr0 + jn + 8));
        gn[3] = __ldg(reinterpret_cast<const float2*>(gr1 + jn + 8));
      }
      const float2 dj0 = *reinterpret_cast<const float2*>(ds + j0 + 2 * t4);
      const float2 dj1 = *reinterpret_cast<const float2*>(ds + j0 + 8 + 2 * t4);
      float w[8];
      if (ks < r) {
        // below the diagonal: exp(cum_i − cum_j) as exp(cum_i − cum_e) ·
        // exp(cum_e − cum_j), e the step's last key (both factors ≤ 1):
        // two exps a thread a step, the second from the block's table
        const float cref = cs[j0 + 15];
        const float er0 = expf(__fsub_rn(ci0, cref));
        const float er1 = expf(__fsub_rn(ci1, cref));
        const float2 ej0 = *reinterpret_cast<const float2*>(es + j0 + 2 * t4);
        const float2 ej1 =
            *reinterpret_cast<const float2*>(es + j0 + 8 + 2 * t4);
        w[0] = scaled(er0, ej0.x, g00.x, dj0.x);
        w[1] = scaled(er0, ej0.y, g00.y, dj0.y);
        w[2] = scaled(er1, ej0.x, g10.x, dj0.x);
        w[3] = scaled(er1, ej0.y, g10.y, dj0.y);
        w[4] = scaled(er0, ej1.x, g01.x, dj1.x);
        w[5] = scaled(er0, ej1.y, g01.y, dj1.y);
        w[6] = scaled(er1, ej1.x, g11.x, dj1.x);
        w[7] = scaled(er1, ej1.y, g11.y, dj1.y);
      } else {
        // the diagonal step: exp(cum_i − cum_j) itself, 0 where j > i
        const float2 cj0 =
            *reinterpret_cast<const float2*>(cs + j0 + 2 * t4);
        const float2 cj1 =
            *reinterpret_cast<const float2*>(cs + j0 + 8 + 2 * t4);
        const int ca = 2 * t4, cb = 2 * t4 + 8;   // local columns
        w[0] = weight(ca <= gid, ci0, cj0.x, g00.x, dj0.x);
        w[1] = weight(ca + 1 <= gid, ci0, cj0.y, g00.y, dj0.y);
        w[2] = weight(ca <= gid + 8, ci1, cj0.x, g10.x, dj0.x);
        w[3] = weight(ca + 1 <= gid + 8, ci1, cj0.y, g10.y, dj0.y);
        w[4] = weight(cb <= gid, ci0, cj1.x, g01.x, dj1.x);
        w[5] = weight(cb + 1 <= gid, ci0, cj1.y, g01.y, dj1.y);
        w[6] = weight(cb <= gid + 8, ci1, cj1.x, g11.x, dj1.x);
        w[7] = weight(cb + 1 <= gid + 8, ci1, cj1.y, g11.y, dj1.y);
      }
      uint32_t af[PIECES][4];
#pragma unroll
      for (int t = 0; t < PIECES; ++t) {
        af[t][0] = term<PIECES>(t, w[0], w[1]);
        af[t][1] = term<PIECES>(t, w[2], w[3]);
        af[t][2] = term<PIECES>(t, w[4], w[5]);
        af[t][3] = term<PIECES>(t, w[6], w[7]);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(xs + (j0 + xr) * XPITCH + np * 16 + xc));
#pragma unroll
        for (int t = 0; t < PIECES; ++t) {
          mma(acc[2 * np], af[t], b[0], b[1]);
          mma(acc[2 * np + 1], af[t], b[2], b[3]);
        }
      }
      if (ks % GROUP == GROUP - 1 || ks == r) add_into(out, acc);
    }

    // ---- epilogue: + D·x[i], one rounding to Out, column pairs
    Out* yb = reinterpret_cast<Out*>(a.y) + (row0 + i0) * xrow +
              (int64_t)hh * P;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (col >= P) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int li = gid + 8 * half;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                xs + (i0 + li) * XPITCH + col));
        store_pair(yb + li * xrow + col,
                   __fadd_rn(out[nt][2 * half], __fmul_rn(xv.x, dh)),
                   __fadd_rn(out[nt][2 * half + 1], __fmul_rn(xv.y, dh)));
      }
    }
  }
}

template <typename Out, int PIECES>
int launch(const Args& a, int64_t batch, cudaStream_t st) {
  const size_t bytes = smem_bytes<PIECES>(a.q, a.n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<Out, PIECES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = batch * a.nc * a.h;
  if (blocks >= (int64_t(1) << 31)) return (int)cudaErrorInvalidValue;
  ssd_chunk_kernel<Out, PIECES><<<(unsigned)blocks, a.q, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (batch, nc·q, heads, p) bf16; c (batch, nc·q, n) bf16; g (batch, nc,
// q, q), cum and dt (batch, nc·q, heads), run (batch, nc, heads, p, n) and
// d (heads) float32; y like x in the output type (0 float32, 2 bfloat16).
// pieces: 3 (the path) or 1 (the single-term control). All contiguous.
extern "C" int ssd_chunk_output(int out_dtype, int pieces, const void* x,
                                const void* c, const void* g,
                                const void* cum, const void* dt,
                                const void* run, const void* d, void* y,
                                int64_t batch, int nc, int q, int heads,
                                int p, int n, void* stream) {
  if (batch < 0 || nc < 1 || heads < 1 || q < 32 || q > QMAX || q % 32 ||
      p < 2 || p > PMAX || p % 2 || n < 16 || n > NMAX || n % 16)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const __nv_bfloat16*>(c),
               static_cast<const float*>(g),
               static_cast<const float*>(cum),
               static_cast<const float*>(dt),
               static_cast<const float*>(run),
               static_cast<const float*>(d), y, nc, q, heads, p, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 2 && pieces == 3)
    return launch<__nv_bfloat16, 3>(a, batch, st);
  if (out_dtype == 0 && pieces == 3) return launch<float, 3>(a, batch, st);
  if (out_dtype == 2 && pieces == 1)
    return launch<__nv_bfloat16, 1>(a, batch, st);
  if (out_dtype == 0 && pieces == 1) return launch<float, 1>(a, batch, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
