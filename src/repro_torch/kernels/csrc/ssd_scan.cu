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
// Design, bf16: three kernels with no dependency between the blocks of
// one kernel, on the scratch cs (B, S, H) f32 and states (B, nc, H, P, N)
// f32 (nc = S / Q), so the sequential walk over the chunks becomes
// B H nc independent tiles and only the state recurrence stays in order:
//  1. ssd_chunk_state, grid (nc, H, B), 8 warps: the chunk cumsum (one
//     warp, f64, rounded once to f32 like the plain version's: at -16 per
//     step the cumsums reach the thousands, where two f32 summation orders
//     differ by ulps of 2.4e-4 that exp turns into relative errors of the
//     outputs), written to cs; and the chunk's own state contribution
//     S_c = sum_j dt_j e^{cs_Q - cs_j} x_j B_j^T on mma.sync, written to
//     states. x_c and B_c stream through a two-stage cp.async ring 64 rows
//     at a time: 56,320 bytes of shared memory at Q = 256, P = 64,
//     N = 128, and at most 64 registers, so four blocks share an SM.
//  2. ssd_state_pass, one thread per 4 state elements: h <- h e^{cs_Q} +
//     S_c over the chunks in order, in place (states[c] becomes the state
//     before chunk c), h_last at the end; the plain version's rounding
//     (product, then sum). Bound by bytes.
//  3. ssd_chunk_scan, grid (nc x Q / 64, H, B), 4 warps: one block per 64
//     query rows of a chunk (heaviest first), one 16-row query tile per
//     warp. C's A fragments load into registers; the state before the
//     chunk lands by cp.async and is split in place into hi and lo bf16
//     for C h^T; B_c and x_c then stream 64 key rows at a time up to the
//     diagonal through a two-stage cp.async ring whose second stage
//     overlays the state, for (C B^T) and its product with x, their
//     fragments by ldmatrix. On the diagonal tile the mask comes before
//     the exp (exp of the upper triangle's positive differences could
//     overflow, and inf * 0 is NaN); off it e^{cs_i - cs_j} dt_j is
//     e^{cs_i - cs_j1} (e^{cs_j1 - cs_j} dt_j), j1 the tile's last key,
//     both factors at most 1: two exps per row and tile, not sixteen.
//     64,512 bytes at Q = 256, P = 64, N = 128 and 162 registers, so
//     three blocks share an SM.
//  Operands that are f32 (the state, (C B^T) L dt, dt e^{cs_Q - cs_j} x)
//  enter the tensor cores (m16n8k16, bf16 in, f32 accumulate) as two bf16
//  terms, hi = bf16(v) and lo = bf16(v - hi), two mma each: about 16
//  significant bits, so the only bf16-sized rounding of the bf16 path is
//  the store of y. x, B and C are read in place from their (B, S, H, P)
//  and (B, S, G, N) layouts with 16-byte copies (no transposed or
//  head-repeated copies). TMA, wgmma and sharing C B^T across the heads
//  of a group are later work.
// f32 (ssd_scan_f32) keeps f32 end to end with plain FMAs (the tensor
// cores would round to TF32): one block per (head, batch) walks the chunks
// in order; 16-row query tiles and 16-key tiles, 16 threads per row; the x
// chunk and the state in shared memory, C and B streamed in 16-row tiles.
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

// ldmatrix: four (x4) or two (x2) 8 x 8 bf16 matrices from shared memory,
// lane l giving the address of row l % 8 of matrix l / 8; register i
// holds matrix i's (row g, columns 2t, 2t + 1), or with .trans its (rows
// 2t, 2t + 1, column g), as mma.sync's fragments take them
__device__ __forceinline__ void ssd_ldm4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ssd_ldm4t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void ssd_ldm2t(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(s));
}

// the two bf16 of a fragment register as floats (.x the low half)
__device__ __forceinline__ float2 ssd_unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// 16 bytes from device to shared memory without passing through
// registers (cp.async, L2 only); visible to the thread after a wait on
// its group, to the block after that and a __syncthreads
__device__ __forceinline__ void ssd_cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void ssd_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` of the thread's newest groups are in flight
template <int n>
__device__ __forceinline__ void ssd_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// `rows` rows of a bf16 matrix, `cols` wide (a multiple of 8), to shared
// rows of stride ld_dst, 16 bytes a copy; row r of the source starts at
// src + r * ld_src
template <int NTHREADS>
__device__ __forceinline__ void ssd_cp_rows(bf16* dst, int ld_dst,
                                            const bf16* src, long long ld_src,
                                            int rows, int cols) {
  const int per = cols / 8;
  for (int i = threadIdx.x; i < rows * per; i += NTHREADS) {
    const int r = i / per, v = (i % per) * 8;
    ssd_cp16(dst + r * ld_dst + v, src + r * ld_src + v);
  }
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

#define SSD_KT 64  // rows of x_c and B_c per step of ssd_chunk_state

// query tiles (and warps) per ssd_chunk_scan block: 4 where 64 divides Q
static inline int ssd_scan_warps(int Q) {
  return Q % 64 == 0 ? 4 : Q % 32 == 0 ? 2 : 1;
}

// bytes of dynamic shared memory of ssd_chunk_state: dt, cs, dt e^{cs_Q - cs}
// (Q f32 each) and two stages of SSD_KT rows of B_c and x_c (bf16, rows
// padded by 8)
static inline int ssd_state_smem(int P, int N, int Q) {
  return 3 * Q * 4 + 2 * SSD_KT * ((N + SSD_PAD) + (P + SSD_PAD)) * 2;
}

// ... of ssd_chunk_scan: dt, cs and the key decays wk (Q f32 each), stage
// 0 of 16 W rows of B_c and x_c, then one region that first holds the
// state before the chunk (P x (N + 8) f32, split in place into hi and lo
// bf16) and then stage 1
static inline int ssd_scan_smem(int P, int N, int Q) {
  const int stage =
      16 * ssd_scan_warps(Q) * ((N + SSD_PAD) + (P + SSD_PAD)) * 2;
  const int hbytes = P * (N + SSD_PAD) * 4;
  return 3 * Q * 4 + stage + (hbytes > stage ? hbytes : stage);
}

// Kernel 1, grid (nc, H, B): the chunk's cumsum cs (written to cs_out,
// (B, S, H) f32) and its own state contribution
//   S_c = sum_j dt_j e^{cs_Q - cs_j} x_j B_j^T   (P x N f32)
// written to states (B, nc, H, P, N). Warp w owns a 16-row block of P and
// HT adjacent 8-column tiles of N; its fragments come by ldmatrix.trans,
// and the f32 A operand x dt e^{cs_Q - cs} enters as hi + lo bf16 terms.
// x_c and B_c stream through a two-stage cp.async ring SSD_KT rows at a
// time; the first rows' copies overlap the cumsum. At most 64 registers,
// so four blocks share an SM.
template <int P, int N>
__global__ void __launch_bounds__(SSD_THREADS, 4)
    ssd_chunk_state(const bf16* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ a,
                    const bf16* __restrict__ bmat, float* __restrict__ cs_out,
                    float* __restrict__ states, int S, int H, int G, int Q) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P, N multiples of 16");
  constexpr int LDB = N + SSD_PAD;  // bf16 row strides
  constexpr int LDX = P + SSD_PAD;
  constexpr int STAGE = SSD_KT * (LDB + LDX);  // bf16: B rows, then x rows
  constexpr int PT = P / 16;        // 16-row blocks of the state
  constexpr int NT = N / 8;         // 8-column tiles of the state
  static_assert(SSD_WARPS % PT == 0, "P / 16 divides the warp count");
  constexpr int WP = SSD_WARPS / PT;       // warps per state row block
  constexpr int HT = (NT + WP - 1) / WP;   // state tiles per warp

  extern __shared__ __align__(16) unsigned char ssd_smem[];
  float* dts = reinterpret_cast<float*>(ssd_smem);  // Q each
  float* cs = dts + Q;
  float* wend = cs + Q;
  bf16* ring = reinterpret_cast<bf16*>(wend + Q);   // 2 x STAGE

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int grp = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)b * S + (long long)c * Q;
  const bf16* bsrc = bmat + (row0 * G + grp) * N;  // row r at + r G N
  const bf16* xsrc = x + (row0 * H + h) * P;        // row r at + r H P
  auto fetch = [&](int k0, int st) {
    const int rows = min(SSD_KT, Q - k0);
    bf16* dst = ring + st * STAGE;
    ssd_cp_rows<SSD_THREADS>(dst, LDB, bsrc + (long long)k0 * G * N,
                             (long long)G * N, rows, N);
    ssd_cp_rows<SSD_THREADS>(dst + SSD_KT * LDB, LDX,
                             xsrc + (long long)k0 * H * P, (long long)H * P,
                             rows, P);
    ssd_cp_commit();
  };
  fetch(0, 0);

  for (int i = threadIdx.x; i < Q; i += SSD_THREADS)
    dts[i] = dt[(row0 + i) * H + h];
  __syncthreads();
  if (threadIdx.x < 32) ssd_cumsum(dts, a[h], cs, Q, threadIdx.x);
  __syncthreads();
  const float cl = cs[Q - 1];
  for (int i = threadIdx.x; i < Q; i += SSD_THREADS) {
    cs_out[(row0 + i) * H + h] = cs[i];
    wend[i] = dts[i] * expf(cl - cs[i]);
  }

  const int p0 = (warp % PT) * 16, wn = warp / PT;
  float acc[HT][4];
#pragma unroll
  for (int k = 0; k < HT; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[k][e] = 0.f;

  for (int k0 = 0, st = 0; k0 < Q; k0 += SSD_KT, st ^= 1) {
    const int rows = min(SSD_KT, Q - k0);
    __syncthreads();  // wend is written; the other stage's readers are done
    if (k0 + SSD_KT < Q) {
      fetch(k0 + SSD_KT, st ^ 1);
      ssd_cp_wait<1>();
    } else {
      ssd_cp_wait<0>();
    }
    __syncthreads();  // this stage's rows have landed for every thread
    const bf16* Bs = ring + st * STAGE;
    const bf16* Xs = Bs + SSD_KT * LDB;
    // lane l addresses row l % 8 of matrix l / 8: rows + 8 for matrices
    // 2, 3 (rs) or 1, 3 (rt), columns + 8 for matrices 1, 3 (cs) or 2, 3
    const int rs = (lane & 7) + ((lane >> 4) << 3);
    const int rt8 = (lane & 7) + (((lane >> 3) & 1) << 3);
    const int cs8 = ((lane >> 3) & 1) << 3, ct8 = (lane >> 4) << 3;
    for (int ks = 0; ks < rows / 16; ++ks) {
      const int jl = ks * 16, ja = k0 + jl + 2 * t;
      const float2 w01 = *reinterpret_cast<const float2*>(wend + ja);
      const float2 w89 = *reinterpret_cast<const float2*>(wend + ja + 8);
      // A[p][j] = x[j][p] w[j] for rows p0 + g (+ 8), columns ja (+1, +8,
      // +9): the transposed 8 x 8 blocks of x_c at (jl, p0), (jl, p0 + 8),
      // (jl + 8, p0), (jl + 8, p0 + 8)
      uint32_t xa[4], xh[4], xl[4];
      ssd_ldm4t(xa, Xs + (jl + rs) * LDX + p0 + cs8);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = ssd_unpack(xa[q]);
        const float2 w = q < 2 ? w01 : w89;
        ssd_split(v.x * w.x, v.y * w.y, xh[q], xl[q]);
      }
      // B[j][n] = B_c[j][n] for the warp's 8-column tiles, two at a time
#pragma unroll
      for (int k = 0; k < HT; k += 2) {
        const int n0 = (wn * HT + k) * 8;
        if (n0 >= N) continue;
        if constexpr (HT % 2 == 0) {
          uint32_t bb[4];
          ssd_ldm4t(bb, Bs + (jl + rt8) * LDB + n0 + ct8);
          ssd_mma(acc[k], xh, bb[0], bb[1]);
          ssd_mma(acc[k], xl, bb[0], bb[1]);
          ssd_mma(acc[k + 1], xh, bb[2], bb[3]);
          ssd_mma(acc[k + 1], xl, bb[2], bb[3]);
        } else {
          uint32_t bb[2];
          ssd_ldm2t(bb, Bs + (jl + rt8) * LDB + n0);
          ssd_mma(acc[k], xh, bb[0], bb[1]);
          ssd_mma(acc[k], xl, bb[0], bb[1]);
          if (k + 1 < HT && n0 + 8 < N) {
            ssd_ldm2t(bb, Bs + (jl + rt8) * LDB + n0 + 8);
            ssd_mma(acc[k + 1], xh, bb[0], bb[1]);
            ssd_mma(acc[k + 1], xl, bb[0], bb[1]);
          }
        }
      }
    }
  }

  float* out = states + (((long long)b * (S / Q) + c) * H + h) * P * N;
#pragma unroll
  for (int k = 0; k < HT; ++k) {
    const int n = (wn * HT + k) * 8 + 2 * t;
    if (wn * HT + k < NT) {
      *reinterpret_cast<float2*>(out + (p0 + g) * N + n) =
          make_float2(acc[k][0], acc[k][1]);
      *reinterpret_cast<float2*>(out + (p0 + g + 8) * N + n) =
          make_float2(acc[k][2], acc[k][3]);
    }
  }
}

// Kernel 2: the state recurrence over the chunks, 4 state elements a thread,
// in place: states[b, c] (S_c on entry) becomes the state before chunk c,
//   h_0 = h0 (or 0),  h_{c+1} = h_c e^{cs_Q(c)} + S_c,
// and hlast = h_nc. The rounding is pinned to the plain version's separate
// product and sum (no FMA). Loads of 8 chunks go out before their updates.
#define SSD_PASS_UNROLL 8

__global__ void __launch_bounds__(SSD_THREADS)
    ssd_state_pass(float* __restrict__ states, const float* __restrict__ cs,
                   const float* __restrict__ h0, float* __restrict__ hlast,
                   int B, int S, int H, int PN, int Q) {
  const int nc = S / Q;
  const int per = PN / 4;  // float4 per (b, h)
  const long long i = (long long)blockIdx.x * SSD_THREADS + threadIdx.x;
  if (i >= (long long)B * H * per) return;
  const long long bh = i / per;
  const int e = (int)(i % per);
  const int b = (int)(bh / H), h = (int)(bh % H);
  float4 hv = h0 != nullptr
                  ? reinterpret_cast<const float4*>(h0 + bh * PN)[e]
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += SSD_PASS_UNROLL) {
    float4 sv[SSD_PASS_UNROLL];
    float dv[SSD_PASS_UNROLL];
#pragma unroll
    for (int k = 0; k < SSD_PASS_UNROLL; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        sv[k] = reinterpret_cast<const float4*>(
            states + (((long long)b * nc + c) * H + h) * PN)[e];
        dv[k] = expf(cs[((long long)b * S + (long long)c * Q + Q - 1) * H +
                        h]);
      }
    }
#pragma unroll
    for (int k = 0; k < SSD_PASS_UNROLL; ++k) {
      const int c = c0 + k;
      if (c < nc) {
        reinterpret_cast<float4*>(
            states + (((long long)b * nc + c) * H + h) * PN)[e] = hv;
        hv.x = __fadd_rn(__fmul_rn(hv.x, dv[k]), sv[k].x);
        hv.y = __fadd_rn(__fmul_rn(hv.y, dv[k]), sv[k].y);
        hv.z = __fadd_rn(__fmul_rn(hv.z, dv[k]), sv[k].z);
        hv.w = __fadd_rn(__fmul_rn(hv.w, dv[k]), sv[k].w);
      }
    }
  }
  reinterpret_cast<float4*>(hlast + bh * PN)[e] = hv;
}

// Kernel 3, grid (nc x Q / (16 W), H, B), W warps: one block per block of
// 16 W query rows of a chunk, the heaviest (last) row blocks first; warp w
// owns one 16-row query tile rt.
//   y_i = sum_{j <= i} (C_i . B_j) e^{cs_i - cs_j} dt_j x_j
//       + e^{cs_i} (C_i . h_prev)
// C's A fragments come from device memory into registers for the tile. The
// state before the chunk lands in shared memory by cp.async and is split in
// place: each f32 column pair (n, n + 1) becomes the word pair (hi, lo),
// each word two bf16, as C h^T's B fragments take them. Key blocks of 16 W
// rows of B_c and x_c stream through a two-stage cp.async ring (stage 1
// overlays the state once C h^T is done), each block's copies overlapping
// the previous block's mma.sync; key tiles of 16 up to the diagonal, their
// fragments by ldmatrix. On the diagonal tile the mask j <= i comes before
// the exp; off it the decay is two factors of at most 1. The f32
// (C B^T) L dt enters the product with x as hi + lo bf16 terms. y is
// rounded to bf16 once.
template <int P, int N, int W>
__global__ void __launch_bounds__(32 * W)
    ssd_chunk_scan(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ cs_in,
                   const bf16* __restrict__ bmat,
                   const bf16* __restrict__ cmat,
                   const float* __restrict__ hprev, bf16* __restrict__ y,
                   int S, int H, int G, int Q) {
  static_assert(P % 16 == 0 && N % 16 == 0, "P, N multiples of 16");
  constexpr int NTHREADS = 32 * W, QB = 16 * W;
  constexpr int LDB = N + SSD_PAD;  // bf16 row strides
  constexpr int LDX = P + SSD_PAD;
  constexpr int LDH = N + SSD_PAD;  // f32 (word) row stride of the state
  constexpr int STAGE = QB * (LDB + LDX);  // bf16: B rows, then x rows

  extern __shared__ __align__(16) unsigned char ssd_smem[];
  float* dts = reinterpret_cast<float*>(ssd_smem);  // Q each
  float* cs = dts + Q;
  float* wk = cs + Q;
  bf16* ring0 = reinterpret_cast<bf16*>(wk + Q);    // STAGE
  float* Hs = reinterpret_cast<float*>(ring0 + STAGE);  // P x LDH, then
  bf16* ring1 = reinterpret_cast<bf16*>(Hs);            // STAGE

  const int nrb = Q / QB;
  const int rb = nrb - 1 - (int)(blockIdx.x % nrb);
  const int c = blockIdx.x / nrb, h = blockIdx.y, b = blockIdx.z;
  const int nc = S / Q;
  const int grp = h / (H / G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)b * S + (long long)c * Q;
  const int kend = (rb + 1) * QB;  // keys [0, kend) of the chunk
  const bf16* bsrc = bmat + (row0 * G + grp) * N;  // row r at + r G N
  const bf16* xsrc = x + (row0 * H + h) * P;        // row r at + r H P
  auto fetch = [&](int kb, bf16* dst) {
    ssd_cp_rows<NTHREADS>(dst, LDB, bsrc + (long long)kb * QB * G * N,
                          (long long)G * N, QB, N);
    ssd_cp_rows<NTHREADS>(dst + QB * LDB, LDX,
                          xsrc + (long long)kb * QB * H * P, (long long)H * P,
                          QB, P);
    ssd_cp_commit();
  };

  // group 0: the state before the chunk; group 1: key block 0
  const float* hp = hprev + (((long long)b * nc + c) * H + h) * P * N;
  for (int i = threadIdx.x; i < P * N / 4; i += NTHREADS)
    ssd_cp16(Hs + (4 * i / N) * LDH + 4 * i % N, hp + 4 * i);
  ssd_cp_commit();
  fetch(0, ring0);

  for (int i = threadIdx.x; i < kend; i += NTHREADS) {
    dts[i] = dt[(row0 + i) * H + h];
    cs[i] = cs_in[(row0 + i) * H + h];
  }
  const int rt = rb * W + warp;
  const int ia = rt * 16 + g, ib = ia + 8;
  const bf16* ca = cmat + ((row0 + ia) * G + grp) * N + 2 * t;
  const bf16* cb = cmat + ((row0 + ib) * G + grp) * N + 2 * t;
  uint32_t cf[N / 16][4];
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    cf[kk][0] = ssd_ld32(ca + kk * 16);
    cf[kk][1] = ssd_ld32(cb + kk * 16);
    cf[kk][2] = ssd_ld32(ca + kk * 16 + 8);
    cf[kk][3] = ssd_ld32(cb + kk * 16 + 8);
  }
  float acc[P / 8][4];
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[pt][e] = 0.f;

  ssd_cp_wait<1>();
  __syncthreads();  // the state, dt and cs are in place
  // wk_j = e^{cs_{j1} - cs_j} dt_j, j1 the last key of j's 16-key tile:
  // off the diagonal e^{cs_i - cs_j} dt_j = e^{cs_i - cs_{j1}} wk_j, both
  // factors at most 1 (cs falls along the chunk), one exp per row and tile
  for (int i = threadIdx.x; i < kend; i += NTHREADS)
    wk[i] = expf(cs[i | 15] - cs[i]) * dts[i];
  for (int i = threadIdx.x; i < P * N / 2; i += NTHREADS) {
    float2* w = reinterpret_cast<float2*>(Hs + (2 * i / N) * LDH + 2 * i % N);
    const float2 v = *w;
    uint2 hl;
    ssd_split(v.x, v.y, hl.x, hl.y);
    *reinterpret_cast<uint2*>(w) = hl;
  }
  __syncthreads();

  // inter-chunk: exp(cs_i) * C_i . h_prev
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
    for (int pt = 0; pt < P / 8; ++pt) {
      const float* hw = Hs + (pt * 8 + g) * LDH + kk * 16 + 2 * t;
      const uint2 w0 = *reinterpret_cast<const uint2*>(hw);
      const uint2 w1 = *reinterpret_cast<const uint2*>(hw + 8);
      ssd_mma(acc[pt], cf[kk], w0.x, w1.x);
      ssd_mma(acc[pt], cf[kk], w0.y, w1.y);
    }
  }
  const float ea = expf(cs[ia]), eb = expf(cs[ib]);
#pragma unroll
  for (int pt = 0; pt < P / 8; ++pt) {
    acc[pt][0] *= ea;
    acc[pt][1] *= ea;
    acc[pt][2] *= eb;
    acc[pt][3] *= eb;
  }

  // intra-chunk: key blocks of 16 W rows, key tiles of 16 up to the
  // diagonal. Lane l addresses row l % 8 of ldmatrix block l / 8: rows + 8
  // for blocks 2, 3 (rs) or 1, 3 (rt8), columns + 8 for blocks 1, 3 (cs8)
  // or 2, 3 (ct8)
  const float csa = cs[ia], csb = cs[ib];
  const int rs = (lane & 7) + ((lane >> 4) << 3);
  const int rt8 = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int cs8 = ((lane >> 3) & 1) << 3, ct8 = (lane >> 4) << 3;
  for (int kb = 0; kb <= rb; ++kb) {
    __syncthreads();  // the other stage's (at kb = 0: the state's) readers
                      // are done
    if (kb < rb) {
      fetch(kb + 1, (kb & 1) ? ring0 : ring1);
      ssd_cp_wait<1>();
    } else {
      ssd_cp_wait<0>();
    }
    __syncthreads();  // key block kb has landed for every thread
    const bf16* Bs = (kb & 1) ? ring1 : ring0;
    const bf16* Xs = Bs + QB * LDB;
    const int njt = kb < rb ? W : warp + 1;
    for (int jt = 0; jt < njt; ++jt) {
      const int jl = jt * 16, j0 = kb * QB + jl;
      float s[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      // C B^T: B's fragments for both 8-key halves of the tile by one
      // ldmatrix, blocks (jl, kk), (jl, kk + 8), (jl + 8, kk), (jl + 8, kk + 8)
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t bq[4];
        ssd_ldm4(bq, Bs + (jl + rs) * LDB + kk * 16 + cs8);
        ssd_mma(s[0], cf[kk], bq[0], bq[1]);
        ssd_mma(s[1], cf[kk], bq[2], bq[3]);
      }
      if (j0 == rt * 16) {  // the diagonal tile: mask before the exp
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + nt * 8 + 2 * t + (e & 1);
            const int i = (e >> 1) ? ib : ia;
            const float csi = (e >> 1) ? csb : csa;
            s[nt][e] = j <= i ? s[nt][e] * expf(csi - cs[j]) * dts[j] : 0.f;
          }
      } else {
        const float ra = expf(csa - cs[j0 + 15]), rb2 = expf(csb - cs[j0 + 15]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 w =
              *reinterpret_cast<const float2*>(wk + j0 + nt * 8 + 2 * t);
          s[nt][0] = s[nt][0] * ra * w.x;
          s[nt][1] = s[nt][1] * ra * w.y;
          s[nt][2] = s[nt][2] * rb2 * w.x;
          s[nt][3] = s[nt][3] * rb2 * w.y;
        }
      }
      uint32_t ph[4], pl[4];
      ssd_split(s[0][0], s[0][1], ph[0], pl[0]);
      ssd_split(s[0][2], s[0][3], ph[1], pl[1]);
      ssd_split(s[1][0], s[1][1], ph[2], pl[2]);
      ssd_split(s[1][2], s[1][3], ph[3], pl[3]);
      // x's fragments for two 8-column tiles of P by one ldmatrix.trans,
      // blocks (jl, pt), (jl + 8, pt), (jl, pt + 1), (jl + 8, pt + 1)
#pragma unroll
      for (int pt = 0; pt < P / 8; pt += 2) {
        uint32_t xb[4];
        ssd_ldm4t(xb, Xs + (jl + rt8) * LDX + pt * 8 + ct8);
        ssd_mma(acc[pt], ph, xb[0], xb[1]);
        ssd_mma(acc[pt], pl, xb[0], xb[1]);
        ssd_mma(acc[pt + 1], ph, xb[2], xb[3]);
        ssd_mma(acc[pt + 1], pl, xb[2], xb[3]);
      }
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
static cudaError_t ssd_launch_state(const void* x, const void* dt,
                                    const void* a, const void* bm, void* cs,
                                    void* st, int B, int S, int H, int G,
                                    int Q, cudaStream_t stream) {
  const int smem = ssd_state_smem(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_state<P, N><<<dim3(S / Q, H, B), SSD_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(bm),
      static_cast<float*>(cs), static_cast<float*>(st), S, H, G, Q);
  return cudaGetLastError();
}

static cudaError_t ssd_launch_pass(void* st, const void* cs, const void* h0,
                                   void* hl, int B, int S, int H, int PN,
                                   int Q, cudaStream_t stream) {
  const long long blocks =
      ((long long)B * H * (PN / 4) + SSD_THREADS - 1) / SSD_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ssd_state_pass<<<(unsigned)blocks, SSD_THREADS, 0, stream>>>(
      static_cast<float*>(st), static_cast<const float*>(cs),
      static_cast<const float*>(h0), static_cast<float*>(hl), B, S, H, PN,
      Q);
  return cudaGetLastError();
}

template <int P, int N, int W>
static cudaError_t ssd_launch_scan_w(const void* x, const void* dt,
                                     const void* cs, const void* bm,
                                     const void* cm, const void* hp, void* y,
                                     int B, int S, int H, int G, int Q,
                                     cudaStream_t stream) {
  const int smem = ssd_scan_smem(P, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_scan<P, N, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<P, N, W>
      <<<dim3((S / Q) * (Q / (16 * W)), H, B), 32 * W, smem, stream>>>(
          static_cast<const bf16*>(x), static_cast<const float*>(dt),
          static_cast<const float*>(cs), static_cast<const bf16*>(bm),
          static_cast<const bf16*>(cm), static_cast<const float*>(hp),
          static_cast<bf16*>(y), S, H, G, Q);
  return cudaGetLastError();
}

template <int P, int N>
static cudaError_t ssd_launch_scan(const void* x, const void* dt,
                                   const void* cs, const void* bm,
                                   const void* cm, const void* hp, void* y,
                                   int B, int S, int H, int G, int Q,
                                   cudaStream_t stream) {
  switch (ssd_scan_warps(Q)) {
    case 4:
      return ssd_launch_scan_w<P, N, 4>(x, dt, cs, bm, cm, hp, y, B, S, H, G,
                                        Q, stream);
    case 2:
      return ssd_launch_scan_w<P, N, 2>(x, dt, cs, bm, cm, hp, y, B, S, H, G,
                                        Q, stream);
    default:
      return ssd_launch_scan_w<P, N, 1>(x, dt, cs, bm, cm, hp, y, B, S, H, G,
                                        Q, stream);
  }
}

// the (head dim, state) pairs built: mamba2_2_7b's (64, 128) and its SMOKE
// config's (16, 16)
static int ssd_bf16_supported(int P, int N) {
  return (P == 16 && N == 16) || (P == 64 && N == 128);
}

// the shapes every launch takes: a chunk of whole 16-row tiles dividing S,
// G dividing H, at most 65535 sequences
static int ssd_shape_ok(int B, int S, int H, int G, int Q) {
  return B > 0 && B <= 65535 && S > 0 && H > 0 && H <= 65535 && G > 0 &&
         H % G == 0 && Q > 0 && Q % 16 == 0 && S % Q == 0;
}

#define SSD_BF16_DISPATCH(CALL)                  \
  if (P == 16 && N == 16) return (int)CALL(16, 16); \
  if (P == 64 && N == 128) return (int)CALL(64, 128); \
  return (int)cudaErrorInvalidValue;

extern "C" {

// Dynamic shared memory the largest block of a dtype's kernels needs
// (bytes), or -1 for a shape the kernels do not take; dtype 0 = float32,
// 1 = bfloat16.
int ssd_scan_smem_bytes(int P, int N, int Q, int dtype) {
  if (Q <= 0 || Q % 16 != 0 || P <= 0 || N <= 0) return -1;
  if (dtype == 1) {
    if (!ssd_bf16_supported(P, N)) return -1;
    const int s1 = ssd_state_smem(P, N, Q), s3 = ssd_scan_smem(P, N, Q);
    return s1 > s3 ? s1 : s3;
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

// Kernel 1 alone (bf16): x (B, S, H, P), dt (B, S, H) f32, a (H,) f32, bm
// (B, S, G, N); writes cs (B, S, H) f32 and st (B, S / Q, H, P, N) f32.
int ssd_chunk_state_forward(const void* x, const void* dt, const void* a,
                            const void* bm, void* cs, void* st, int B, int S,
                            int H, int G, int P, int N, int Q, void* stream) {
  if (!ssd_shape_ok(B, S, H, G, Q) ||
      ssd_scan_smem_bytes(P, N, Q, 1) > SSD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s_ = static_cast<cudaStream_t>(stream);
#define SSD_CALL1(PP, NN) \
  ssd_launch_state<PP, NN>(x, dt, a, bm, cs, st, B, S, H, G, Q, s_)
  SSD_BF16_DISPATCH(SSD_CALL1)
#undef SSD_CALL1
}

// Kernel 2 alone: st (B, S / Q, H, P, N) f32 in place (S_c in, the state
// before chunk c out), cs (B, S, H) f32, h0 (may be null) and hl (B, H, P,
// N) f32, all 16-byte aligned.
int ssd_state_pass_forward(void* st, const void* cs, const void* h0,
                           void* hl, int B, int S, int H, int P, int N,
                           int Q, void* stream) {
  if (!ssd_shape_ok(B, S, H, 1, Q) || P <= 0 || N <= 0 || (P * N) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return (int)ssd_launch_pass(st, cs, h0, hl, B, S, H, P * N, Q,
                              static_cast<cudaStream_t>(stream));
}

// Kernel 3 alone (bf16): x, y (B, S, H, P), dt and cs (B, S, H) f32, bm and
// cm (B, S, G, N), hp (B, S / Q, H, P, N) f32, the state before each chunk.
int ssd_chunk_scan_forward(const void* x, const void* dt, const void* cs,
                           const void* bm, const void* cm, const void* hp,
                           void* y, int B, int S, int H, int G, int P, int N,
                           int Q, void* stream) {
  if (!ssd_shape_ok(B, S, H, G, Q) ||
      ssd_scan_smem_bytes(P, N, Q, 1) > SSD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s_ = static_cast<cudaStream_t>(stream);
#define SSD_CALL3(PP, NN) \
  ssd_launch_scan<PP, NN>(x, dt, cs, bm, cm, hp, y, B, S, H, G, Q, s_)
  SSD_BF16_DISPATCH(SSD_CALL3)
#undef SSD_CALL3
}

// The whole scan. x, y: (B, S, H, P); dt: (B, S, H) f32; a: (H,) f32; bm,
// cm: (B, S, G, N); h0 (may be null), hl: (B, H, P, N) f32; all contiguous
// and 16-byte aligned; x, bm, cm, y of one dtype (0 = float32, 1 =
// bfloat16); H % G == 0, S % Q == 0, and ssd_scan_smem_bytes(P, N, Q,
// dtype) in (0, ssd_scan_smem_limit()]. bf16 runs kernels 1-3 on the
// scratch cs (B, S, H) f32 and st (B, S / Q, H, P, N) f32; f32 runs
// ssd_scan_f32 and ignores them.
int ssd_scan_forward(const void* x, const void* dt, const void* a,
                     const void* bm, const void* cm, const void* h0, void* y,
                     void* hl, void* cs, void* st, int B, int S, int H,
                     int G, int P, int N, int Q, int dtype, void* stream) {
  const int smem = ssd_scan_smem_bytes(P, N, Q, dtype);
  if (!ssd_shape_ok(B, S, H, G, Q) || smem < 0 || smem > SSD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st_ = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (cs == nullptr || st == nullptr) return (int)cudaErrorInvalidValue;
    int err = ssd_chunk_state_forward(x, dt, a, bm, cs, st, B, S, H, G, P,
                                      N, Q, stream);
    if (err != 0) return err;
    err = ssd_state_pass_forward(st, cs, h0, hl, B, S, H, P, N, Q, stream);
    if (err != 0) return err;
    return ssd_chunk_scan_forward(x, dt, cs, bm, cm, st, y, B, S, H, G, P,
                                  N, Q, stream);
  }
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_f32<<<dim3(H, B), SSD_THREADS, smem, st_>>>(
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
