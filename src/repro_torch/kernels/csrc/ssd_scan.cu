// Mamba-2 SSD chunk scan for Hopper (sm_90a): K9 of the port.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_pallas
// (_kernel): over x (B, S, H, P), dt (B, S, H) f32 post-softplus, a (H,)
// f32 negative, B and C (B, S, G, N) with head h reading group
// h / (H / G), chunks of Q steps, from the state h = h0 (or 0):
//   cs_i     = cumsum_{k <= i} dt_k * a                  (within the chunk)
//   y_i      = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//            + exp(cs_i) (C_i . h)           (h: the state before the chunk)
//   h       <- h exp(cs_Q) + sum_j dt_j exp(cs_Q - cs_j) x_j B_j^T
// all in f32; y is written in x's dtype, and the final state h_last
// (B, H, P, N) f32 once at the end. The TPU kernel keeps h_last on chip and
// its model falls back to the plain scan for it; here it is the kernel's
// second output, so prefill never runs the plain scan.
//
// What bounds it: operations, narrowly. Per (b, h, chunk) tile the causal
// half of C B^T is Q (Q + 1) N flops, its masked product with x
// Q (Q + 1) P, C h 2 Q N P and the state update 2 Q N P: 21.0 MFLOP at
// Q = 256, P = 64, N = 128. At (4, 4096, 80, 64) that is 108 GFLOP per
// launch, 0.109 ms at 989 TFLOP/s bf16, against about 360 MB of x, dt, B,
// C, y and h_last (0.107 ms at 3.35 TB/s).
//
// Design, bf16 (ssd_scan_bf16, P and N compile-time):
//  * one block of 8 warps per (head, batch) walks the chunks in order, as
//    the TPU grid's innermost chunk axis does; the (P, N) f32 state stays
//    in shared memory across the chunks. x, B and C are read in place from
//    their (B, S, H, P) and (B, S, G, N) layouts with 16-byte loads (no
//    transposed or head-repeated copies).
//  * per chunk, B_c, C_c (Q x N) and x_c (Q x P) bf16 tiles sit in shared
//    memory (rows padded by 8 elements); at Q = 256, P = 64, N = 128 with
//    the state that is 215 KB of dynamic shared memory, above the 48 KB
//    static limit, hence cudaFuncSetAttribute.
//  * the chunk cumsum runs on one warp (a sequential run per lane, then a
//    shuffle scan of the lanes' totals) in f64, rounded once to f32 like
//    the plain version's: at -16 per step the cumsums reach the thousands,
//    where two f32 summation orders differ by ulps of 2.4e-4 that exp
//    turns into relative errors of the outputs.
//  * outputs: each warp owns 16-row query tiles (tile pairs from both ends
//    of the chunk, so causal work balances). C's A fragments stay in
//    registers for the tile; C h^T and, key tile by key tile up to the
//    diagonal, (C B^T) run on mma.sync m16n8k16 (bf16 in, f32 accumulate).
//    The mask j <= i is applied before the exp (exp of the upper
//    triangle's positive differences could overflow, and inf * 0 is NaN);
//    the masked f32 (C B^T) L dt is then the A operand of the product with
//    x.
//  * operands that are f32 (the state h, (C B^T) L dt, dt e^{cs_Q - cs_j} x)
//    enter the tensor cores as two bf16 terms, hi = bf16(v) and
//    lo = bf16(v - hi), two mma each: about 16 significant bits, so the
//    only bf16-sized rounding of the bf16 path is the store of y.
//  * the state update runs after all warps have read the chunk's h: warp w
//    owns a 16-row block of P and a share of N's 8-column tiles, starting
//    its accumulators at h exp(cs_Q).
//  * simple first: synchronous tile loads, one block per SM; cp.async/TMA,
//    wgmma and sharing C B^T across the heads of a group are later work.
// f32 (ssd_scan_f32) keeps f32 end to end with plain FMAs (the tensor
// cores would round to TF32): 16-row query tiles and 16-key tiles, 16
// threads per row; the x chunk and the state in shared memory, C and B
// streamed in 16-row tiles.
//
// Both need Q % 16 == 0 and S % Q == 0 (the model pads S with dt = 0).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_THREADS 256
#define SSD_WARPS 8
#define SSD_PAD 8
#define SSD_SMEM_LIMIT 232448

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ helpers

__device__ __forceinline__ void ssd_mma(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ssd_ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two addresses, the first in the low half
__device__ __forceinline__ uint32_t ssd_pack2(const bf16* lo, const bf16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t ssd_pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as hi + lo bf16 pairs: hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void ssd_split(float v0, float v1, uint32_t& hi,
                                          uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// cs[i] = sum_{k <= i} f32(dts[k] * a) over the chunk, summed in f64 and
// rounded once to f32, as the plain version (kernels/ssd_scan.py chunk_cumsum)
// does: exp(cs_i - cs_j) amplifies any rounding of cs, and an f32 sum's
// rounding depends on its order, the f64 sum's f32 rounding does not. On
// one warp: lane l sums its run [l * per, (l + 1) * per) in order, the
// runs' totals are scanned across the lanes, and each lane adds its
// offset to its run.
__device__ __forceinline__ void ssd_cumsum(const float* dts, float a,
                                           float* cs, int Q, int lane) {
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  double tot = 0.0;
  for (int i = lo; i < hi; ++i) tot += (double)__fmul_rn(dts[i], a);
  double incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  double run = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) run = 0.0;
  for (int i = lo; i < hi; ++i) {
    run += (double)__fmul_rn(dts[i], a);
    cs[i] = __double2float_rn(run);
  }
}

// the chunk's dt, cumsum, exp(cs) and dt * exp(cs_Q - cs); leaves the
// arrays visible to the block
__device__ __forceinline__ void ssd_chunk_decays(
    const float* __restrict__ dt, long long row0, int H, int h, float a,
    int Q, float* dts, float* cs, float* ecs, float* wend) {
  for (int i = threadIdx.x; i < Q; i += SSD_THREADS)
    dts[i] = dt[(row0 + i) * H + h];
  __syncthreads();
  if (threadIdx.x < 32) ssd_cumsum(dts, a, cs, Q, threadIdx.x);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int i = threadIdx.x; i < Q; i += SSD_THREADS) {
    ecs[i] = expf(cs[i]);
    wend[i] = dts[i] * expf(cl - cs[i]);
  }
  __syncthreads();
}

// ---------------------------------------------------------- bf16, mma

// bytes of dynamic shared memory: the state (P x (N + 8) f32), four (Q,)
// f32 arrays, B_c and C_c (Q x (N + 8) bf16) and x_c (Q x (P + 8) bf16)
static inline int ssd_bf16_smem(int P, int N, int Q) {
  return P * (N + 8) * 4 + 4 * Q * 4 +
         (2 * Q * (N + SSD_PAD) + Q * (P + SSD_PAD)) * 2;
}

template <int P, int N>
__global__ void __launch_bounds__(SSD_THREADS)
    ssd_scan_bf16(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const bf16* __restrict__ bmat,
                  const bf16* __restrict__ cmat,
                  const float* __restrict__ h0, bf16* __restrict__ y,
                  float* __restrict__ hlast, int S, int H, int G, int Q) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P, N multiples of 16");
  constexpr int LDB = N + SSD_PAD;  // bf16 row strides
  constexpr int LDX = P + SSD_PAD;
  constexpr int LDH = N + 8;        // f32 row stride of the state
  constexpr int PT = P / 16;        // 16-row blocks of the state
  constexpr int NT = N / 8;         // 8-column tiles of the state
  static_assert(SSD_WARPS % PT == 0, "P / 16 divides the warp count");
  constexpr int WP = SSD_WARPS / PT;       // warps per state row block
  constexpr int HT = (NT + WP - 1) / WP;   // state tiles per warp

  extern __shared__ __align__(16) unsigned char ssd_smem[];
  float* hs = reinterpret_cast<float*>(ssd_smem);  // P x LDH
  float* cs = hs + P * LDH;                        // Q each
  float* ecs = cs + Q;
  float* wend = ecs + Q;
  float* dts = wend + Q;
  bf16* Bs = reinterpret_cast<bf16*>(dts + Q);     // Q x LDB
  bf16* Cs = Bs + Q * LDB;                         // Q x LDB
  bf16* Xs = Cs + Q * LDB;                         // Q x LDX

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const float ah = a[h];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long hoff = ((long long)b * H + h) * P * N;

  for (int i = threadIdx.x; i < P * N; i += SSD_THREADS)
    hs[(i / N) * LDH + i % N] = h0 != nullptr ? h0[hoff + i] : 0.f;

  const int nrt = Q / 16;
  for (int c = 0; c < S / Q; ++c) {
    const long long row0 = (long long)b * S + (long long)c * Q;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = threadIdx.x; i < Q * (N / 8); i += SSD_THREADS) {
      const int r = i / (N / 8), v = (i % (N / 8)) * 8;
      const long long src = ((row0 + r) * G + grp) * N + v;
      *reinterpret_cast<uint4*>(Bs + r * LDB + v) =
          *reinterpret_cast<const uint4*>(bmat + src);
      *reinterpret_cast<uint4*>(Cs + r * LDB + v) =
          *reinterpret_cast<const uint4*>(cmat + src);
    }
    for (int i = threadIdx.x; i < Q * (P / 8); i += SSD_THREADS) {
      const int r = i / (P / 8), v = (i % (P / 8)) * 8;
      *reinterpret_cast<uint4*>(Xs + r * LDX + v) =
          *reinterpret_cast<const uint4*>(x + ((row0 + r) * H + h) * P + v);
    }
    ssd_chunk_decays(dt, row0, H, h, ah, Q, dts, cs, ecs, wend);

    // ---- outputs: 16-row query tiles, paired from both ends
    for (int k = warp; k < nrt; k += SSD_WARPS) {
      const int base = (k / SSD_WARPS) * SSD_WARPS;
      const int gs = min(SSD_WARPS, nrt - base);
      const int rt = ((k / SSD_WARPS) & 1) ? base + gs - 1 - (k - base) : k;
      const int i0 = rt * 16;
      const int ia = i0 + g, ib = i0 + g + 8;

      uint32_t cf[N / 16][4];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const bf16* ca = Cs + ia * LDB + kk * 16 + 2 * t;
        cf[kk][0] = ssd_ld32(ca);
        cf[kk][1] = ssd_ld32(ca + 8 * LDB);
        cf[kk][2] = ssd_ld32(ca + 8);
        cf[kk][3] = ssd_ld32(ca + 8 * LDB + 8);
      }
      float acc[P / 8][4];
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;

      // inter-chunk: exp(cs_i) * C_i . h
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int pt = 0; pt < P / 8; ++pt) {
          const float* hp = hs + (pt * 8 + g) * LDH + kk * 16 + 2 * t;
          const float2 v0 = *reinterpret_cast<const float2*>(hp);
          const float2 v1 = *reinterpret_cast<const float2*>(hp + 8);
          uint32_t h0h, h0l, h1h, h1l;
          ssd_split(v0.x, v0.y, h0h, h0l);
          ssd_split(v1.x, v1.y, h1h, h1l);
          ssd_mma(acc[pt], cf[kk], h0h, h1h);
          ssd_mma(acc[pt], cf[kk], h0l, h1l);
        }
      }
      const float ea = ecs[ia], eb = ecs[ib];
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        acc[pt][0] *= ea;
        acc[pt][1] *= ea;
        acc[pt][2] *= eb;
        acc[pt][3] *= eb;
      }

      // intra-chunk: key tiles of 16 up to the diagonal
      const float csa = cs[ia], csb = cs[ib];
      for (int jt = 0; jt <= rt; ++jt) {
        const int j0 = jt * 16;
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const bf16* bp = Bs + (j0 + nt * 8 + g) * LDB + kk * 16 + 2 * t;
            ssd_mma(s[nt], cf[kk], ssd_ld32(bp), ssd_ld32(bp + 8));
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + nt * 8 + 2 * t + (e & 1);
            const int i = (e >> 1) ? ib : ia;
            const float csi = (e >> 1) ? csb : csa;
            s[nt][e] = j <= i ? s[nt][e] * expf(csi - cs[j]) * dts[j] : 0.f;
          }
        uint32_t ph[4], pl[4];
        ssd_split(s[0][0], s[0][1], ph[0], pl[0]);
        ssd_split(s[0][2], s[0][3], ph[1], pl[1]);
        ssd_split(s[1][0], s[1][1], ph[2], pl[2]);
        ssd_split(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
        for (int pt = 0; pt < P / 8; ++pt) {
          const bf16* vp = Xs + (j0 + 2 * t) * LDX + pt * 8 + g;
          const uint32_t b0 = ssd_pack2(vp, vp + LDX);
          const uint32_t b1 = ssd_pack2(vp + 8 * LDX, vp + 9 * LDX);
          ssd_mma(acc[pt], ph, b0, b1);
          ssd_mma(acc[pt], pl, b0, b1);
        }
      }

      bf16* ya = y + ((row0 + ia) * H + h) * P;
      bf16* yb = y + ((row0 + ib) * H + h) * P;
#pragma unroll
      for (int pt = 0; pt < P / 8; ++pt) {
        const int col = pt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ya + col) =
            ssd_pack_f32(acc[pt][0], acc[pt][1]);
        *reinterpret_cast<uint32_t*>(yb + col) =
            ssd_pack_f32(acc[pt][2], acc[pt][3]);
      }
    }
    __syncthreads();  // every read of the chunk's h is done

    // ---- state update: h = h exp(cs_Q) + (x dt e^{cs_Q - cs})^T B
    {
      const int p0 = (warp % PT) * 16, wn = warp / PT;
      const float et = expf(cs[Q - 1]);
      float hacc[HT][4];
#pragma unroll
      for (int k = 0; k < HT; ++k) {
        const int n = (wn + WP * k) * 8 + 2 * t;
        if (wn + WP * k < NT) {
          hacc[k][0] = hs[(p0 + g) * LDH + n] * et;
          hacc[k][1] = hs[(p0 + g) * LDH + n + 1] * et;
          hacc[k][2] = hs[(p0 + g + 8) * LDH + n] * et;
          hacc[k][3] = hs[(p0 + g + 8) * LDH + n + 1] * et;
        }
      }
      for (int ks = 0; ks < nrt; ++ks) {
        const int ja = ks * 16 + 2 * t;
        const float w0 = wend[ja], w1 = wend[ja + 1];
        const float w8 = wend[ja + 8], w9 = wend[ja + 9];
        const bf16* xp = Xs + ja * LDX + p0 + g;
        uint32_t xh[4], xl[4];
        // A[p][j] = x[j][p] w[j]: rows p0 + g (+ 8), columns ja (+1, +8, +9)
        ssd_split(__bfloat162float(xp[0]) * w0,
                  __bfloat162float(xp[LDX]) * w1, xh[0], xl[0]);
        ssd_split(__bfloat162float(xp[8]) * w0,
                  __bfloat162float(xp[LDX + 8]) * w1, xh[1], xl[1]);
        ssd_split(__bfloat162float(xp[8 * LDX]) * w8,
                  __bfloat162float(xp[9 * LDX]) * w9, xh[2], xl[2]);
        ssd_split(__bfloat162float(xp[8 * LDX + 8]) * w8,
                  __bfloat162float(xp[9 * LDX + 8]) * w9, xh[3], xl[3]);
#pragma unroll
        for (int k = 0; k < HT; ++k) {
          if (wn + WP * k < NT) {
            const bf16* bp = Bs + ja * LDB + (wn + WP * k) * 8 + g;
            const uint32_t b0 = ssd_pack2(bp, bp + LDB);
            const uint32_t b1 = ssd_pack2(bp + 8 * LDB, bp + 9 * LDB);
            ssd_mma(hacc[k], xh, b0, b1);
            ssd_mma(hacc[k], xl, b0, b1);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < HT; ++k) {
        const int n = (wn + WP * k) * 8 + 2 * t;
        if (wn + WP * k < NT) {
          hs[(p0 + g) * LDH + n] = hacc[k][0];
          hs[(p0 + g) * LDH + n + 1] = hacc[k][1];
          hs[(p0 + g + 8) * LDH + n] = hacc[k][2];
          hs[(p0 + g + 8) * LDH + n + 1] = hacc[k][3];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * N; i += SSD_THREADS)
    hlast[hoff + i] = hs[(i / N) * LDH + i % N];
}

// ----------------------------------------------------------- f32, FMA

#define SF_T 16      // query rows and keys per tile
#define SF_MAXD 8    // y columns per thread: P <= 128
#define SF_MAXE 64   // state entries per thread: P * N <= 256 * 64

static inline int ssd_f32_smem(int P, int N, int Q) {
  return (P * (N + 1) + Q * (P + 1) + 4 * Q + 2 * SF_T * (N + 1) +
          SF_T * (SF_T + 1)) * 4;
}

__global__ void __launch_bounds__(SSD_THREADS)
    ssd_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ bmat,
                 const float* __restrict__ cmat, const float* __restrict__ h0,
                 float* __restrict__ y, float* __restrict__ hlast, int S,
                 int H, int G, int Q, int P, int N) {
  extern __shared__ __align__(16) unsigned char ssd_smem[];
  const int LH = N + 1, LX = P + 1;  // odd strides: no bank conflicts
  float* hs = reinterpret_cast<float*>(ssd_smem);  // P x LH
  float* xs = hs + P * LH;                          // Q x LX
  float* cs = xs + Q * LX;
  float* ecs = cs + Q;
  float* wend = ecs + Q;
  float* dts = wend + Q;
  float* Cq = dts + Q;                              // SF_T x LH
  float* Bk = Cq + SF_T * LH;                       // SF_T x LH
  float* Ps = Bk + SF_T * LH;                       // SF_T x (SF_T + 1)

  const int h = blockIdx.x, b = blockIdx.y;
  const int grp = h / (H / G);
  const float ah = a[h];
  const int r = threadIdx.x / SF_T, cc = threadIdx.x % SF_T;
  const long long hoff = ((long long)b * H + h) * P * N;
  const int n_e = P * N / SSD_THREADS;

  for (int i = threadIdx.x; i < P * N; i += SSD_THREADS)
    hs[(i / N) * LH + i % N] = h0 != nullptr ? h0[hoff + i] : 0.f;

  const int ntile = Q / SF_T;
  for (int c = 0; c < S / Q; ++c) {
    const long long row0 = (long long)b * S + (long long)c * Q;
    __syncthreads();
    for (int i = threadIdx.x; i < Q * P; i += SSD_THREADS)
      xs[(i / P) * LX + i % P] = x[((row0 + i / P) * H + h) * P + i % P];
    ssd_chunk_decays(dt, row0, H, h, ah, Q, dts, cs, ecs, wend);

    for (int qt = 0; qt < ntile; ++qt) {
      const int i = qt * SF_T + r;
      __syncthreads();  // Cq, Bk, Ps free
      for (int e = threadIdx.x; e < SF_T * N; e += SSD_THREADS)
        Cq[(e / N) * LH + e % N] =
            cmat[((row0 + qt * SF_T + e / N) * G + grp) * N + e % N];
      __syncthreads();
      float acc[SF_MAXD];
#pragma unroll
      for (int d = 0; d < SF_MAXD; ++d) {
        acc[d] = 0.f;
        if (cc + SF_T * d < P) {
          const float* hp = hs + (cc + SF_T * d) * LH;
          float v = 0.f;
          for (int n = 0; n < N; ++n) v += Cq[r * LH + n] * hp[n];
          acc[d] = v * ecs[i];
        }
      }
      for (int kt = 0; kt <= qt; ++kt) {
        __syncthreads();  // Bk and Ps free
        for (int e = threadIdx.x; e < SF_T * N; e += SSD_THREADS)
          Bk[(e / N) * LH + e % N] =
              bmat[((row0 + kt * SF_T + e / N) * G + grp) * N + e % N];
        __syncthreads();
        const int j = kt * SF_T + cc;
        float sv = 0.f;
        if (j <= i) {
          for (int n = 0; n < N; ++n) sv += Cq[r * LH + n] * Bk[cc * LH + n];
          sv = sv * expf(cs[i] - cs[j]) * dts[j];
        }
        Ps[r * (SF_T + 1) + cc] = sv;
        __syncthreads();
#pragma unroll
        for (int d = 0; d < SF_MAXD; ++d) {
          if (cc + SF_T * d < P) {
            float v = 0.f;
            for (int jj = 0; jj < SF_T; ++jj)
              v += Ps[r * (SF_T + 1) + jj] *
                   xs[(kt * SF_T + jj) * LX + cc + SF_T * d];
            acc[d] += v;
          }
        }
      }
      float* yr = y + ((row0 + i) * H + h) * P;
#pragma unroll
      for (int d = 0; d < SF_MAXD; ++d)
        if (cc + SF_T * d < P) yr[cc + SF_T * d] = acc[d];
    }

    // state update
    const float et = expf(cs[Q - 1]);
    float hacc[SF_MAXE];
#pragma unroll
    for (int k = 0; k < SF_MAXE; ++k) {
      const int e = threadIdx.x + SSD_THREADS * k;
      hacc[k] = k < n_e ? hs[(e / N) * LH + e % N] * et : 0.f;
    }
    for (int kt = 0; kt < ntile; ++kt) {
      __syncthreads();
      for (int e = threadIdx.x; e < SF_T * N; e += SSD_THREADS)
        Bk[(e / N) * LH + e % N] =
            bmat[((row0 + kt * SF_T + e / N) * G + grp) * N + e % N];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < SF_MAXE; ++k) {
        if (k < n_e) {
          const int e = threadIdx.x + SSD_THREADS * k;
          const int p = e / N, n = e % N;
          float v = 0.f;
          for (int jj = 0; jj < SF_T; ++jj) {
            const int j = kt * SF_T + jj;
            v += xs[j * LX + p] * wend[j] * Bk[jj * LH + n];
          }
          hacc[k] += v;
        }
      }
    }
    __syncthreads();  // every read of the chunk's h is done
#pragma unroll
    for (int k = 0; k < SF_MAXE; ++k) {
      if (k < n_e) {
        const int e = threadIdx.x + SSD_THREADS * k;
        hs[(e / N) * LH + e % N] = hacc[k];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P * N; i += SSD_THREADS)
    hlast[hoff + i] = hs[(i / N) * LH + i % N];
}

// ------------------------------------------------------------ dispatch

template <int P, int N>
static cudaError_t ssd_launch_bf16(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, const void* h0, void* y,
                                   void* hl, int B, int S, int H, int G,
                                   int Q, cudaStream_t stream) {
  const int smem = ssd_bf16_smem(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_bf16<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  ssd_scan_bf16<P, N><<<dim3(H, B), SSD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<const bf16*>(cm), static_cast<const float*>(h0),
      static_cast<bf16*>(y), static_cast<float*>(hl), S, H, G, Q);
  return cudaGetLastError();
}

// the (head dim, state) pairs built: mamba2_2_7b's (64, 128) and its SMOKE
// config's (16, 16)
static int ssd_bf16_supported(int P, int N) {
  return (P == 16 && N == 16) || (P == 64 && N == 128);
}

#define SSD_BF16_CASE(PP, NN)                                              \
  if (P == PP && N == NN)                                                  \
    return (int)ssd_launch_bf16<PP, NN>(x, dt, a, bm, cm, h0, y, hl, B, S, \
                                        H, G, Q, st);

extern "C" {

// Dynamic shared memory one block needs (bytes), or -1 for a shape the
// kernel does not take; dtype 0 = float32, 1 = bfloat16.
int ssd_scan_smem_bytes(int P, int N, int Q, int dtype) {
  if (Q <= 0 || Q % 16 != 0 || P <= 0 || N <= 0) return -1;
  if (dtype == 1) {
    if (!ssd_bf16_supported(P, N)) return -1;
    return ssd_bf16_smem(P, N, Q);
  }
  if (dtype == 0) {
    if (P % 16 != 0 || P > SF_T * SF_MAXD || N % 16 != 0 ||
        P * N > SSD_THREADS * SF_MAXE)
      return -1;
    return ssd_f32_smem(P, N, Q);
  }
  return -1;
}

int ssd_scan_smem_limit(void) { return SSD_SMEM_LIMIT; }

// x, y: (B, S, H, P); dt: (B, S, H) f32; a: (H,) f32; bm, cm: (B, S, G, N);
// h0 (may be null), hl: (B, H, P, N) f32; all contiguous and 16-byte
// aligned; x, bm, cm, y of one dtype (0 = float32, 1 = bfloat16);
// H % G == 0, S % Q == 0, and ssd_scan_smem_bytes(P, N, Q, dtype) in
// (0, ssd_scan_smem_limit()].
int ssd_scan_forward(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, const void* h0, void* y,
                     void* hl, int B, int S, int H, int G, int P, int N,
                     int Q, int dtype, void* stream) {
  const int smem = ssd_scan_smem_bytes(P, N, Q, dtype);
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 ||
      S % Q != 0 || smem < 0 || smem > SSD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    SSD_BF16_CASE(16, 16)
    SSD_BF16_CASE(64, 128)
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_f32<<<dim3(H, B), SSD_THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const float*>(bm),
      static_cast<const float*>(cm), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hl), S, H, G, Q, P, N);
  return (int)cudaGetLastError();
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
