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
//  3. chunk outputs y, one of two kernels by the rule ssd_scan_kernel_of
//     (kernels/ssd_scan.py::kernel_for is its twin):
//     ssd_chunk_scan_wgmma at (P, N) = (64, 128) and chunks of whole 64-row
//     query blocks (mamba2_2_7b's main path), the earlier ssd_chunk_scan on
//     mma.sync everywhere else (the SMOKE config's (16, 16), chunks of 16
//     or 32 rows).
//   ssd_chunk_scan_wgmma, grid (H, nc x ceil(Q / 256), B): one block per
//     256 query rows of a (chunk, head, batch), so at Q = 256 one block a
//     chunk: C's rows, the state's split and the key tiles are loaded and
//     made once per chunk (the mma.sync kernel does each four times, one block
//     per 64 rows). One producer warpgroup, of which one thread issues
//     every TMA load (C once; B_c and x_c key tile by key tile, 64 keys,
//     through a 2-stage ring with full and empty mbarriers for B and for x
//     apart); two consumer warpgroups (setmaxnreg 24 / 240) own the four
//     64-row query blocks, the heaviest paired with the lightest (rows
//     0-63 with 192-255, 64-127 with 128-191: 5 key tiles each). A
//     warpgroup walks the key tiles once for both its blocks: S = C B_c^T
//     on wgmma (m64n64k16, C and B_c K-major from shared memory, no split:
//     both are bf16), the decay in registers (on the diagonal tile the mask
//     before the exp, as exp of the upper triangle's positive differences
//     could overflow and inf * 0 is NaN; off it e^{cs_i - cs_j} dt_j =
//     e^{cs_i - cs_j1} (e^{cs_j1 - cs_j} dt_j), j1 the tile's last key, both
//     factors at most 1: two exps per row and tile), then y += M x_c on
//     wgmma with M from registers (the accumulator layout is the A
//     layout) as hi + lo bf16 and x_c the B operand MN-major, straight from
//     its TMA tile. S of one step is issued with M x of the step before and
//     the decay runs beside the latter; B's stage frees when S is done, x's
//     when M x is. The consumers read the f32 state themselves and split it
//     once into hi and lo bf16 tiles in the 128-byte swizzle for C h^T
//     (m64n64k16, issued with the first S; y's rows then scaled by
//     e^{cs_i}), which saves a 32 KB f32 staging tile. y leaves by TMA from
//     its query block's C tile. Shared memory 148 KB at Q = 256 (C 64 KB,
//     state 32 KB, ring 48 KB, cs, dt, wk 3 KB): one block an SM, 384
//     threads, 168 registers, no spill. Bound: bytes (x, y and h_prev 168
//     MB each at call A; B and C read by all 80 heads of a chunk from L2);
//     its tensor-core work with the hi and lo terms is 29.4 MFLOP a chunk,
//     0.152 ms at call A at 989 TFLOP/s against the 0.156 ms bytes bound.
//   What holds it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke and
//     tests/torch_k9_ablations.py, PERF.md section 6): 0.52 ms at call A
//     against the mma.sync kernel's 0.77. Without any wgmma (the loads,
//     the split, the decay and the store alone) it takes 0.25 ms: each
//     chunk moves 192 KB into its SM, 128 KB of it B_c and C, which every
//     head reads again from L2; the products add 0.27 ms on top, as a
//     block's loads up to its first S (C, the state, the first key tile)
//     overlap no work of its own. Without the lo terms it is 11% faster,
//     without C h^T 8%, without the overlap 2-3% slower; three or four
//     ring stages, 32- or 128-key tiles and one consumer warpgroup are
//     slower (the last two spill). A persistent form (one block an SM, C
//     double-buffered, the next chunk loaded under this one's products)
//     spilled at 240 registers a consumer thread and was slower. Sharing
//     C B^T and its loads across a group's heads is the next step.
//   ssd_chunk_scan (mma.sync), grid (nc x Q / (16 W), H, B), W warps: one
//     block per 16 W query rows of a chunk (heaviest first), one 16-row
//     query tile per warp. C's A fragments load into registers; the state
//     before the chunk lands by cp.async and is split in place into hi and
//     lo bf16 for C h^T; B_c and x_c then stream 16 W key rows at a time up
//     to the diagonal through a two-stage cp.async ring whose second stage
//     overlays the state, for (C B^T) and its product with x, their
//     fragments by ldmatrix; 16-key tiles, the same mask and decay. 64,512
//     bytes at Q = 256, P = 64, N = 128 and 162 registers, so three blocks
//     share an SM.
//  Operands that are f32 (the state, (C B^T) L dt, dt e^{cs_Q - cs_j} x)
//  enter the tensor cores (bf16 in, f32 accumulate) as two bf16 terms, hi =
//  bf16(v) and lo = bf16(v - hi), two products each: about 16 significant
//  bits, so the only bf16-sized rounding of the bf16 path is the store of
//  y. x, B and C are read in place from their (B, S, H, P) and (B, S, G, N)
//  layouts (no transposed or head-repeated copies). Sharing C B^T across
//  the heads of a group, K9.1 on wgmma and the f32 scratch are later work.
// f32 (ssd_scan_f32) keeps f32 end to end with plain FMAs (the tensor
// cores would round to TF32): one block per (head, batch) walks the chunks
// in order; 16-row query tiles and 16-key tiles, 16 threads per row; the x
// chunk and the state in shared memory, C and B streamed in 16-row tiles.
//
// Both need Q % 16 == 0 and S % Q == 0 (the model pads S with dt = 0).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // TMA, mbarrier, wgmma helpers; tensor-map encoder

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

// ------------------------------------------ bf16, wgmma + TMA (K9.3 main)

// The kernel rule and the tiles of ssd_chunk_scan_wgmma, which
// kernels/ssd_scan.py::source_config reads: head dim SSD_WG_P and state
// SSD_WG_N at chunks of whole 64-row query blocks; a block takes up to
// SSD_WG_ROWS query rows of one (chunk, head, batch), SSD_WG_NWG consumer
// warpgroups own its 64-row query blocks by ssd_wg_of, and B_c and x_c
// stream SSD_WG_BK keys a stage through a ring of SSD_WG_STAGES stages.
#define SSD_WG_P 64
#define SSD_WG_N 128
#define SSD_WG_ROWS 256
#define SSD_WG_NWG 2
#define SSD_WG_BK 64
#define SSD_WG_STAGES 2

// The key tiles of bk keys that the 64 query rows [q0, q0 + 64) of a chunk
// visit are [0, hi]; those up to ihi are interior (every key at or before
// every row: no mask), the rest (the diagonal ones) are masked.
// kernels/ssd_scan.py::chunk_tiles is the same rule.
__host__ __device__ __forceinline__ void ssd_tiles(int q0, int bk, int& hi,
                                                   int& ihi) {
  hi = (q0 + 63) / bk;
  ihi = (q0 + 1) / bk - 1;
}

// The consumer warpgroup of query block r of a block's nb: the heaviest
// paired with the lightest (at nb = 4 rows 0-63 and 192-255 to one,
// 64-127 and 128-191 to the other, so each visits 5 key tiles of 64); at
// nb = 2 one block each; one consumer warpgroup takes all.
// kernels/ssd_scan.py::warpgroup_of is the same rule.
__host__ __device__ __forceinline__ int ssd_wg_of(int r, int nb, int nwg) {
  if (nwg == 1) return 0;
  if (nb == 2) return r;
  return (r < nb - 1 - r ? r : nb - 1 - r) % 2;
}

// bytes of dynamic shared memory of ssd_chunk_scan_wgmma at chunk Q: 1024
// to align, C of the block's query rows (Q or SSD_WG_ROWS of them), the
// state's hi and lo tiles, the B_c and x_c ring, the barriers, and cs, dt
// and the key decays wk (Q f32 each)
static inline int ssd_wg_smem(int Q) {
  const int rows = Q < SSD_WG_ROWS ? Q : SSD_WG_ROWS;
  return 1024 + rows * SSD_WG_N * 2 + 2 * SSD_WG_P * SSD_WG_N * 2 +
         SSD_WG_STAGES * SSD_WG_BK * (SSD_WG_N + SSD_WG_P) * 2 +
         8 * (1 + 4 * SSD_WG_STAGES) + 3 * Q * 4;
}

// y += M x_c for one key tile: M (64 x BK, f32 in registers) as hi and lo
// bf16 A fragments, x_c (BK keys x 64 columns) the B operand MN-major,
// k-step kk 2048 bytes on (issued, not waited for)
template <int BK>
__device__ __forceinline__ void ssd_issue_mx(float (&y)[8][4],
                                             const uint32_t (&mh)[BK / 16][4],
                                             const uint32_t (&ml)[BK / 16][4],
                                             uint32_t xa) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dx = fa_desc(xa + kk * 2048, BK * 128, 1024);
    fa_wgmma_rs(y, mh[kk], dx);
    fa_wgmma_rs(y, ml[kk], dx);
  }
}

// D (64 x NB) (+)= C_q E^T over the state's 128 columns: C_q (64 rows) and
// E (NB rows: B_c's keys, or the state's P rows) K-major in shared memory,
// two 64-column chunks each, C's 8192 bytes apart and E's NB * 128
// (issued, not waited for)
template <int NB>
__device__ __forceinline__ void ssd_issue_cbt(float (&d)[NB / 8][4],
                                              uint32_t ca, uint32_t ea,
                                              int accumulate) {
#pragma unroll
  for (int kk = 0; kk < SSD_WG_N / 16; ++kk)
    fa_wgmma_ss(d, fa_desc(ca + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024),
                fa_desc(ea + (kk / 4) * NB * 128 + (kk % 4) * 32, 16, 1024),
                accumulate || kk > 0);
}

// What a consumer warpgroup's steps read: the tiles' shared-memory
// addresses and barriers, cs, dt and wk, and its NS slots: slot k takes
// query block rb[k] (rows q_first + 64 rb[k] ..), key tiles [0, hi[k]],
// interior up to ihi[k], and holds cs of its rows i0 = q0 + 16 warp + g
// and i0 + 8; slots lightest first, so the last one visits every tile
template <int NS>
struct SsdCtx {
  static constexpr int kSlots = NS;
  uint32_t sc, sh, sb, sx, bar_c, bar_b, bar_x, bar_eb, bar_ex;
  const float *css, *dts, *wk;
  int q_first, warp, g, t;
  int rb[NS], hi[NS], ihi[NS];
  float csr[NS][2];
};

__device__ __forceinline__ int ssd_stage(int j) { return j % SSD_WG_STAGES; }
__device__ __forceinline__ uint32_t ssd_parity(int j) {
  return static_cast<uint32_t>((j / SSD_WG_STAGES) & 1);
}

// One step of a consumer warpgroup: slot K on key tile j. S = C_q B_j^T
// is issued, then the pending product: M x of the step before (slot PK on
// tile pj) or, at the first step (PK < 0), C h_prev^T (hi + lo) of every
// slot, after `first` has laid out what every step reads (the state's
// tiles, cs, dt, wk). The decay of S runs beside the pending product. B's
// stage frees once the tile's last slot's S is done, x's once its last M x
// is; after the first step y's rows are scaled by e^{cs_i}. The slots are
// template arguments, so every wgmma names its accumulator (a register
// chosen at run time makes ptxas serialize them).
template <int BK, int NS, int K, int PK, class First>
__device__ __forceinline__ void ssd_step(const SsdCtx<NS>& cx, int j, int pj,
                                         float (&y)[NS][8][4],
                                         float (&s)[BK / 8][4],
                                         uint32_t (&mh)[BK / 16][4],
                                         uint32_t (&ml)[BK / 16][4],
                                         First& first) {
  constexpr uint32_t C_BYTES = 64 * SSD_WG_N * 2;
  constexpr uint32_t H_BYTES = SSD_WG_P * SSD_WG_N * 2;
  constexpr uint32_t B_BYTES = BK * SSD_WG_N * 2, X_BYTES = BK * SSD_WG_P * 2;
  if constexpr (PK < 0) fa_bar_wait(cx.bar_c, 0);
  fa_bar_wait(cx.bar_b + 8 * ssd_stage(j), ssd_parity(j));
  fa_wgmma_fence();
  ssd_issue_cbt<BK>(s, cx.sc + cx.rb[K] * C_BYTES,
                    cx.sb + ssd_stage(j) * B_BYTES, 0);
  fa_wgmma_commit();
  if constexpr (PK < 0) {
    first();
    fa_wgmma_fence();
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      ssd_issue_cbt<SSD_WG_P>(y[q], cx.sc + cx.rb[q] * C_BYTES, cx.sh, 0);
      ssd_issue_cbt<SSD_WG_P>(y[q], cx.sc + cx.rb[q] * C_BYTES,
                              cx.sh + H_BYTES, 1);
    }
  } else {
    fa_bar_wait(cx.bar_x + 8 * ssd_stage(pj), ssd_parity(pj));
    fa_wgmma_fence();
    ssd_issue_mx<BK>(y[PK], mh, ml, cx.sx + ssd_stage(pj) * X_BYTES);
  }
  fa_wgmma_commit();
  fa_wgmma_wait<1>();  // S is done; the pending product runs on
  fa_fence_regs(s);
  if constexpr (K == NS - 1) fa_bar_arrive(cx.bar_eb + 8 * ssd_stage(j));

  // the decay of S into M
  const int key0 = j * BK;
  if (j <= cx.ihi[K]) {
    const float cl = cx.css[key0 + BK - 1];
    const float r0 = expf(cx.csr[K][0] - cl), r1 = expf(cx.csr[K][1] - cl);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
      const float2 w = *reinterpret_cast<const float2*>(cx.wk + key0 +
                                                         nt * 8 + 2 * cx.t);
      s[nt][0] = s[nt][0] * r0 * w.x;
      s[nt][1] = s[nt][1] * r0 * w.y;
      s[nt][2] = s[nt][2] * r1 * w.x;
      s[nt][3] = s[nt][3] * r1 * w.y;
    }
  } else {  // a masked tile: the mask before the exp
    const int i0 = cx.q_first + 64 * cx.rb[K] + 16 * cx.warp + cx.g;
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jj = key0 + nt * 8 + 2 * cx.t + (e & 1);
        s[nt][e] = jj <= i0 + 8 * (e >> 1)
                       ? s[nt][e] * expf(cx.csr[K][e >> 1] - cx.css[jj]) *
                             cx.dts[jj]
                       : 0.f;
      }
  }

  fa_wgmma_wait<0>();
  if constexpr (PK < 0) {  // C h_prev^T is done: y's rows times e^{cs_i}
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      fa_fence_regs(y[q]);
      const float e0 = expf(cx.csr[q][0]), e1 = expf(cx.csr[q][1]);
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        y[q][d][0] *= e0;
        y[q][d][1] *= e0;
        y[q][d][2] *= e1;
        y[q][d][3] *= e1;
      }
    }
  } else {
    fa_fence_regs(y[PK]);
    if constexpr (PK == NS - 1)
      fa_bar_arrive(cx.bar_ex + 8 * ssd_stage(pj));
  }
  // M as hi + lo bf16 A fragments of k-steps kk (keys 16 kk.. of the
  // tile): the accumulator's layout is the A operand's
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    ssd_split(s[2 * kk][0], s[2 * kk][1], mh[kk][0], ml[kk][0]);
    ssd_split(s[2 * kk][2], s[2 * kk][3], mh[kk][1], ml[kk][1]);
    ssd_split(s[2 * kk + 1][0], s[2 * kk + 1][1], mh[kk][2], ml[kk][2]);
    ssd_split(s[2 * kk + 1][2], s[2 * kk + 1][3], mh[kk][3], ml[kk][3]);
  }
}

// the steps of slots P0 + 1 .. NS - 1 on tile j, each after the one before
template <int BK, int NS, int P0, class First>
__device__ __forceinline__ void ssd_tile_rest(const SsdCtx<NS>& cx, int j,
                                              float (&y)[NS][8][4],
                                              float (&s)[BK / 8][4],
                                              uint32_t (&mh)[BK / 16][4],
                                              uint32_t (&ml)[BK / 16][4],
                                              First& first) {
  if constexpr (P0 + 1 < NS) {
    ssd_step<BK, NS, P0 + 1, P0>(cx, j, j, y, s, mh, ml, first);
    ssd_tile_rest<BK, NS, P0 + 1>(cx, j, y, s, mh, ml, first);
  }
}

// the key tiles that slots P0 .. NS - 1 visit and slot P0 - 1 does not
// (P0 = 0: from tile 0), in order, then the next phase's
template <int BK, int NS, int P0, class First>
__device__ __forceinline__ void ssd_phase(const SsdCtx<NS>& cx,
                                          float (&y)[NS][8][4],
                                          float (&s)[BK / 8][4],
                                          uint32_t (&mh)[BK / 16][4],
                                          uint32_t (&ml)[BK / 16][4],
                                          First& first) {
  int j = 0;
  if constexpr (P0 == 0) {
    ssd_step<BK, NS, 0, -1>(cx, 0, -1, y, s, mh, ml, first);
    ssd_tile_rest<BK, NS, 0>(cx, 0, y, s, mh, ml, first);
    j = 1;
  } else {
    j = cx.hi[P0 - 1] + 1;
  }
  for (; j <= cx.hi[P0]; ++j) {
    ssd_step<BK, NS, P0, NS - 1>(cx, j, j - 1, y, s, mh, ml, first);
    ssd_tile_rest<BK, NS, P0>(cx, j, y, s, mh, ml, first);
  }
  if constexpr (P0 + 1 < NS) ssd_phase<BK, NS, P0 + 1>(cx, y, s, mh, ml, first);
}

// A consumer warpgroup with NS slots: every step, the last M x (the last
// slot's, on its last tile), then y as bf16 into each query block's own C
// tile (no longer read) in the layout TMA's 128-byte swizzle gives it
// (16-byte unit u of row r at u ^ (r % 8)), stored by one thread by TMA.
// Returns the last tile it visited.
template <int BK, int NS, class First>
__device__ __forceinline__ int ssd_consume(const SsdCtx<NS>& cx, int cw,
                                           int wt,
                                           int h, long long row0,
                                           const CUtensorMap* ty,
                                           First& first) {
  constexpr uint32_t C_BYTES = 64 * SSD_WG_N * 2;
  constexpr uint32_t X_BYTES = BK * SSD_WG_P * 2;
  float y[NS][8][4];
#pragma unroll
  for (int k = 0; k < NS; ++k)
#pragma unroll
    for (int d = 0; d < 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[k][d][e] = 0.f;
  float s[BK / 8][4];
#pragma unroll
  for (int d = 0; d < BK / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[d][e] = 0.f;
  uint32_t mh[BK / 16][4], ml[BK / 16][4];
  ssd_phase<BK, NS, 0>(cx, y, s, mh, ml, first);
  const int last = cx.hi[NS - 1];
  fa_bar_wait(cx.bar_x + 8 * ssd_stage(last), ssd_parity(last));
  fa_wgmma_fence();
  ssd_issue_mx<BK>(y[NS - 1], mh, ml, cx.sx + ssd_stage(last) * X_BYTES);
  fa_wgmma_commit();
  fa_wgmma_wait<0>();
  fa_fence_regs(y[NS - 1]);
  fa_bar_arrive(cx.bar_ex + 8 * ssd_stage(last));

  const int r0 = 16 * cx.warp + cx.g;  // r0 % 8 == g, as for r0 + 8
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    const uint32_t yq = cx.sc + cx.rb[q] * C_BYTES;
#pragma unroll
    for (int d = 0; d < 8; ++d) {
      const uint32_t at = yq + ((d ^ cx.g) << 4) + 4 * cx.t;
      const uint32_t v0 = ssd_pack_f32(y[q][d][0], y[q][d][1]);
      const uint32_t v1 = ssd_pack_f32(y[q][d][2], y[q][d][3]);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + r0 * 128), "r"(v0)
                   : "memory");
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + (r0 + 8) * 128),
                   "r"(v1)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  if (wt == 0) {
#pragma unroll
    for (int q = 0; q < NS; ++q)
      fa_tma_store(ty, cx.sc + cx.rb[q] * C_BYTES, 0, h,
                   (int)(row0 + cx.q_first + 64 * cx.rb[q]));
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  return last;
}

// Kernel 3 on Hopper, grid (H, nc x ceil(Q / SSD_WG_ROWS), B): one block per
// SSD_WG_ROWS query rows of a (chunk, head, batch), a chunk's row groups
// heaviest first, the heads of one chunk together (at G = 1 they read one
// B_c and C, from L2).
//   y_i = sum_{j <= i} (C_i . B_j) e^{cs_i - cs_j} dt_j x_j
//       + e^{cs_i} (C_i . h_prev)
// One producer thread loads C of the block's rows, then B_c and x_c key
// tile by key tile through the ring (TMA; full and empty mbarriers for B
// and for x apart). The consumers read h_prev (f32) themselves and split
// it once into hi and lo bf16 tiles in the 128-byte swizzle, while the
// first S runs. A consumer warpgroup holds y of its (up to two) 64-row
// query blocks in registers and walks the key tiles in order, each tile
// once for all its blocks that visit it (ssd_phase, ssd_step): S = C_q
// B_j^T (wgmma, both from shared memory), the decay in registers (the mask
// before the exp on a masked tile; off it the two factors e^{cs_i - cs_j1}
// and wk_j = e^{cs_j1 - cs_j} dt_j, both at most 1), M split into hi and
// lo bf16 A fragments, y += M x_j (wgmma, A from registers). y goes out by
// TMA from its query block's own C tile.
template <int BK, int NWG>
__global__ void __launch_bounds__((NWG + 1) * 128, 1)
    ssd_chunk_scan_wgmma(const __grid_constant__ CUtensorMap tx,
                         const __grid_constant__ CUtensorMap tb,
                         const __grid_constant__ CUtensorMap tc,
                         const __grid_constant__ CUtensorMap ty,
                         const float* __restrict__ dt,
                         const float* __restrict__ cs_in,
                         const float* __restrict__ hprev, int S, int H, int G,
                         int Q) {
  constexpr int P = SSD_WG_P, N = SSD_WG_N, STAGES = SSD_WG_STAGES;
  constexpr int QBLK = SSD_WG_ROWS / 64;         // query blocks of a block
  constexpr int SLOTS = (QBLK + NWG - 1) / NWG;  // ... of a warpgroup
  constexpr int NT = NWG * 128;                  // consumer threads
  constexpr uint32_t C_BYTES = 64 * N * 2;       // one query block's C
  constexpr uint32_t H_BYTES = P * N * 2;        // one bf16 state tile
  constexpr uint32_t B_BYTES = BK * N * 2, X_BYTES = BK * P * 2;
  static_assert(P == 64 && N == 128, "one 64-column chunk of x, two of B");
  static_assert(SLOTS >= 1 && SLOTS <= 4, "one to four slots a warpgroup");
  extern __shared__ __align__(1024) unsigned char ssd_wsmem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  unsigned char* base =
      ssd_wsmem + ((1024u - (fa_saddr(ssd_wsmem) & 1023u)) & 1023u);
  const uint32_t sc = fa_saddr(base);
  const int ngrp = (Q + SSD_WG_ROWS - 1) / SSD_WG_ROWS;
  const int nb_max = Q < SSD_WG_ROWS ? Q / 64 : QBLK;
  const uint32_t sh = sc + nb_max * C_BYTES;  // the state's hi, then lo
  const uint32_t sb = sh + 2 * H_BYTES, sx = sb + STAGES * B_BYTES;
  const uint32_t bar_c = sx + STAGES * X_BYTES;
  const uint32_t bar_b = bar_c + 8, bar_x = bar_b + 8 * STAGES,
                 bar_eb = bar_x + 8 * STAGES, bar_ex = bar_eb + 8 * STAGES;
  float* css = reinterpret_cast<float*>(base + (bar_ex + 8 * STAGES - sc));
  float* dts = css + Q;
  float* wk = dts + Q;

  const int h = blockIdx.x, b = blockIdx.z;
  const int grp_row = ngrp - 1 - (int)(blockIdx.y % ngrp);  // heaviest first
  const int c = blockIdx.y / ngrp;
  const int grp = h / (H / G);
  const int nb = min(QBLK, Q / 64 - grp_row * QBLK);
  const int q_first = grp_row * SSD_WG_ROWS;  // the block's first row
  const int kend = q_first + 64 * nb;          // keys [0, kend)
  const int jmax = (kend - 1) / BK;            // the block's last key tile
  const long long row0 = (long long)b * S + (long long)c * Q;

  if (threadIdx.x == 0) {
    fa_bar_init(bar_c, 1);
    for (int st = 0; st < STAGES; ++st) {
      fa_bar_init(bar_b + 8 * st, 1);
      fa_bar_init(bar_x + 8 * st, 1);
      fa_bar_init(bar_eb + 8 * st, NWG * 128);
      fa_bar_init(bar_ex + 8 * st, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, warp-uniform for the compiler (a wgmma on a path it
  // takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      fa_bar_expect(bar_c, nb * C_BYTES);
      for (int r = 0; r < nb; ++r)
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
          fa_tma_load(sc + r * C_BYTES + ch * 8192, &tc, bar_c, ch * 64, grp,
                      (int)(row0 + q_first + 64 * r));
      for (int j = 0; j <= jmax; ++j) {
        const int st = j % STAGES;
        const uint32_t free_parity = ((j / STAGES) & 1) ^ 1;
        fa_bar_wait(bar_eb + 8 * st, free_parity);
        fa_bar_expect(bar_b + 8 * st, B_BYTES);
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
          fa_tma_load(sb + st * B_BYTES + ch * BK * 128, &tb, bar_b + 8 * st,
                      ch * 64, grp, (int)(row0 + j * BK));
        fa_bar_wait(bar_ex + 8 * st, free_parity);
        fa_bar_expect(bar_x + 8 * st, X_BYTES);
        fa_tma_load(sx + st * X_BYTES, &tx, bar_x + 8 * st, 0, h,
                    (int)(row0 + j * BK));
      }
    }
    return;
  }

  // consumer warpgroup cw
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int ct = threadIdx.x - 128;  // 0 .. NT - 1
  const int wt = threadIdx.x % 128;

  // loads issued now, used once the first S is on its way: the state
  // before the chunk (f32), and cs, dt and cs of the tile's last key of
  // the thread's first key
  const float4* hp4 = reinterpret_cast<const float4*>(
      hprev + (((long long)b * (S / Q) + c) * H + h) * P * N);
  constexpr int HV = P * N / 4 / NT;  // float4 a thread
  float4 hv[HV];
#pragma unroll
  for (int k = 0; k < HV; ++k) hv[k] = hp4[ct + NT * k];
  const float* csg = cs_in + row0 * H + h;
  const float* dtg = dt + row0 * H + h;
  auto key_loads = [&](int i, float& ci, float& di, float& c1) {
    ci = csg[(long long)i * H];
    di = dtg[(long long)i * H];
    c1 = csg[(long long)min(i | (BK - 1), kend - 1) * H];
  };
  float ci0 = 0.f, di0 = 0.f, c10 = 0.f;
  if (ct < kend) key_loads(ct, ci0, di0, c10);
  // what every step reads, laid out by all consumer threads: cs, dt and
  // wk_j = e^{cs_j1 - cs_j} dt_j (j1 the last key of j's tile) of the keys
  // [0, kend); the state split into hi and lo bf16 tiles (P rows of N, two
  // 64-column chunks 8192 bytes apart, 128-byte swizzle: 16-byte unit u of
  // row p at u ^ (p % 8))
  auto first = [&]() {
    if (ct < kend) {
      css[ct] = ci0;
      dts[ct] = di0;
      wk[ct] = expf(c10 - ci0) * di0;
    }
    for (int i = ct + NT; i < kend; i += NT) {
      float ci, di, c1;
      key_loads(i, ci, di, c1);
      css[i] = ci;
      dts[i] = di;
      wk[i] = expf(c1 - ci) * di;
    }
#pragma unroll
    for (int k = 0; k < HV; ++k) {
      const int e = 4 * (ct + NT * k);
      const int p = e / N, n = e % N;
      uint32_t h0, l0, h1, l1;
      ssd_split(hv[k].x, hv[k].y, h0, l0);
      ssd_split(hv[k].z, hv[k].w, h1, l1);
      const uint32_t off = (n / 64) * 8192 + p * 128 +
                           ((((n % 64) / 8) ^ (p & 7)) << 4) + (n % 8) * 2;
      *reinterpret_cast<uint2*>(base + (sh - sc) + off) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(base + (sh - sc) + H_BYTES + off) =
          make_uint2(l0, l1);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
  };

  // this warpgroup's query blocks, lightest first
  int nslot = 0, rb[SLOTS] = {};
  for (int r = 0; r < nb; ++r)
    if (ssd_wg_of(r, nb, NWG) == cw) {
#pragma unroll
      for (int k = 0; k < SLOTS; ++k)
        if (k == nslot) rb[k] = r;
      ++nslot;
    }
  const int warp = wt >> 5, lane = wt & 31;
  auto run = [&](auto ctx) -> int {
    ctx.sc = sc;
    ctx.sh = sh;
    ctx.sb = sb;
    ctx.sx = sx;
    ctx.bar_c = bar_c;
    ctx.bar_b = bar_b;
    ctx.bar_x = bar_x;
    ctx.bar_eb = bar_eb;
    ctx.bar_ex = bar_ex;
    ctx.css = css;
    ctx.dts = dts;
    ctx.wk = wk;
    ctx.q_first = q_first;
    ctx.warp = warp;
    ctx.g = lane >> 2;
    ctx.t = lane & 3;
    constexpr int ns = decltype(ctx)::kSlots;
#pragma unroll
    for (int k = 0; k < ns; ++k) {
      ctx.rb[k] = rb[k];
      ssd_tiles(q_first + 64 * rb[k], BK, ctx.hi[k], ctx.ihi[k]);
      const int i0 = q_first + 64 * rb[k] + 16 * warp + ctx.g;
      ctx.csr[k][0] = csg[(long long)i0 * H];
      ctx.csr[k][1] = csg[(long long)(i0 + 8) * H];
    }
    return ssd_consume<BK, ns>(ctx, cw, wt, h, row0, &ty, first);
  };
  int last = -1;
  if (nslot == SLOTS) {
    last = run(SsdCtx<SLOTS>());
  } else if (nslot == 1) {
    last = run(SsdCtx<1>());
  } else if (nslot == 0) {
    first();
  } else {
    if constexpr (SLOTS > 2) {
      if (nslot == 2) last = run(SsdCtx<2>());
      if constexpr (SLOTS > 3)
        if (nslot == 3) last = run(SsdCtx<3>());
    }
  }
  // the block's tiles past this warpgroup's last: released unread
  for (int j = last + 1; j <= jmax; ++j) {
    fa_bar_wait(bar_b + 8 * ssd_stage(j), ssd_parity(j));
    fa_bar_wait(bar_x + 8 * ssd_stage(j), ssd_parity(j));
    fa_bar_arrive(bar_eb + 8 * ssd_stage(j));
    fa_bar_arrive(bar_ex + 8 * ssd_stage(j));
  }
  if (nslot > 0 && wt == 0)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
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

// (P, H or G, rows) bf16, row stride of P elements, as a 3-D tensor map
// of boxes of 64 columns (128 bytes) x 1 x box_rows rows, 128-byte swizzle
static cudaError_t ssd_map(CUtensorMap* map, const void* ptr, int cols,
                           int planes, long long rows, int box_rows) {
  const FaEncodeTiled encode = fa_encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)planes,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * (cuuint64_t)planes * 2};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ssd_chunk_scan_wgmma on the tensor maps of x and y (P, H, B S), B and C
// (N, G, B S)
static cudaError_t ssd_launch_scan_wgmma(const void* x, const void* dt,
                                         const void* cs, const void* bm,
                                         const void* cm, const void* hp,
                                         void* y, int B, int S, int H, int G,
                                         int Q, cudaStream_t stream) {
  constexpr int BK = SSD_WG_BK, NWG = SSD_WG_NWG;
  const int ngrp = (Q + SSD_WG_ROWS - 1) / SSD_WG_ROWS;
  if (Q % 64 != 0 || Q % BK != 0 || (long long)(S / Q) * ngrp > 65535)
    return cudaErrorInvalidValue;
  const long long rows = (long long)B * S;
  CUtensorMap tx, tb, tc, ty;
  cudaError_t err;
  if ((err = ssd_map(&tx, x, SSD_WG_P, H, rows, BK)) != cudaSuccess ||
      (err = ssd_map(&tb, bm, SSD_WG_N, G, rows, BK)) != cudaSuccess ||
      (err = ssd_map(&tc, cm, SSD_WG_N, G, rows, 64)) != cudaSuccess ||
      (err = ssd_map(&ty, y, SSD_WG_P, H, rows, 64)) != cudaSuccess)
    return err;
  const int smem = ssd_wg_smem(Q);
  err = cudaFuncSetAttribute(ssd_chunk_scan_wgmma<BK, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan_wgmma<BK, NWG>
      <<<dim3(H, (S / Q) * ngrp, B), (NWG + 1) * 128, smem, stream>>>(
          tx, tb, tc, ty, static_cast<const float*>(dt),
          static_cast<const float*>(cs), static_cast<const float*>(hp), S, H,
          G, Q);
  return cudaGetLastError();
}

// the (head dim, state) pairs built: mamba2_2_7b's (64, 128) and its SMOKE
// config's (16, 16)
static int ssd_bf16_supported(int P, int N) {
  return (P == 16 && N == 16) || (P == 64 && N == 128);
}

// The kernel rule of K9.3 (kernels/ssd_scan.py::kernel_for is its twin):
// 2, ssd_chunk_scan_wgmma, at (SSD_WG_P, SSD_WG_N) and chunks of whole
// 64-row query blocks; 1, the mma.sync ssd_chunk_scan, at every other
// bf16 shape; -1 where neither builds
static int ssd_scan_kernel_of(int P, int N, int Q) {
  if (!ssd_bf16_supported(P, N) || Q <= 0 || Q % 16 != 0) return -1;
  return P == SSD_WG_P && N == SSD_WG_N && Q % 64 == 0 ? 2 : 1;
}

// dynamic shared memory of K9.3's kernel `kernel` (1 or 2) at (P, N, Q)
static int ssd_chunk_scan_smem(int P, int N, int Q, int kernel) {
  if (kernel == 2)
    return P == SSD_WG_P && N == SSD_WG_N && Q > 0 && Q % 64 == 0
               ? ssd_wg_smem(Q)
               : -1;
  return kernel == 1 && ssd_bf16_supported(P, N) ? ssd_scan_smem(P, N, Q)
                                                 : -1;
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
    const int s1 = ssd_state_smem(P, N, Q),
              s3 = ssd_chunk_scan_smem(P, N, Q, ssd_scan_kernel_of(P, N, Q));
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

// K9.3's kernel by the rule (1 mma.sync, 2 wgmma), -1 for a shape no bf16
// kernel takes
int ssd_chunk_scan_kernel(int P, int N, int Q) {
  return ssd_scan_kernel_of(P, N, Q);
}

// Kernel 3 alone (bf16) on the kernel `kernel` (1 mma.sync, 2 wgmma; the
// rule's or forced): x, y (B, S, H, P), dt and cs (B, S, H) f32, bm and cm
// (B, S, G, N), hp (B, S / Q, H, P, N) f32, the state before each chunk.
int ssd_chunk_scan_kernel_forward(const void* x, const void* dt,
                                  const void* cs, const void* bm,
                                  const void* cm, const void* hp, void* y,
                                  int B, int S, int H, int G, int P, int N,
                                  int Q, int kernel, void* stream) {
  const int smem = ssd_chunk_scan_smem(P, N, Q, kernel);
  if (!ssd_shape_ok(B, S, H, G, Q) || smem < 0 || smem > SSD_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s_ = static_cast<cudaStream_t>(stream);
  if (kernel == 2)
    return (int)ssd_launch_scan_wgmma(x, dt, cs, bm, cm, hp, y, B, S, H, G, Q,
                                      s_);
#define SSD_CALL3(PP, NN) \
  ssd_launch_scan<PP, NN>(x, dt, cs, bm, cm, hp, y, B, S, H, G, Q, s_)
  SSD_BF16_DISPATCH(SSD_CALL3)
#undef SSD_CALL3
}

// Kernel 3 alone (bf16) on the rule's kernel.
int ssd_chunk_scan_forward(const void* x, const void* dt, const void* cs,
                           const void* bm, const void* cm, const void* hp,
                           void* y, int B, int S, int H, int G, int P, int N,
                           int Q, void* stream) {
  return ssd_chunk_scan_kernel_forward(x, dt, cs, bm, cm, hp, y, B, S, H, G,
                                       P, N, Q, ssd_scan_kernel_of(P, N, Q),
                                       stream);
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
