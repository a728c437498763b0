// Causal / sliding-window GQA flash attention for Hopper (sm_90a): K8 of
// the port.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (_kernel):
// out = softmax(mask(q k^T * scale)) v per (batch, head), online softmax
// over kv tiles with running (m, l, acc), query i attending key j iff
// j <= i and (window == 0 or j > i - window). q is (B, H, S, dh), k and v
// (B, Hkv, S, dh); query head h reads kv head h / (H / Hkv) in place (no
// expanded copy: here MQA, 16 query heads on one kv head). NEG_INF =
// -1e30 and p = 0 on masked lanes, as the TPU kernel has them, so a fully
// masked row stays finite (l = 0 -> out = 0 / 1e-30 = 0).
//
// What bounds it: operations. At (4, 16, 4096, 256) bf16 with window 2048
// the unmasked band is sum_q min(q + 1, w) = 6.29M (q, k) pairs per
// (b, h), 4 * dh flops each: 0.41 TFLOP, 0.42 ms at 989 TFLOP/s, against
// 285 MB of q, k, v and out (0.085 ms at 3.35 TB/s).
//
// Design of the bf16 kernel (flash_fwd_bf16):
//  * one block of FA_WARPS = 4 warps per (64-query tile, head, batch);
//    each warp owns 16 query rows. Q, K and V tiles of 64 x dh bf16 sit in shared memory
//    (rows padded by 8 elements, so that the eight 16-byte rows an
//    ldmatrix reads fall in distinct banks); at dh = 256 that is 3 x 33 KB,
//    above the 48 KB static limit, so the launch raises the block's dynamic
//    shared-memory limit (cudaFuncSetAttribute): two blocks an SM.
//  * both products run on the tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate). Their fragments come by ldmatrix: Q's and
//    K's by ldmatrix.x4, V's by ldmatrix.x4.trans (one instruction for
//    two 8-column n-tiles). The S = Q K^T accumulator of a warp is 16 x 64
//    f32 in 32 registers a thread, and the O accumulator 16 x dh f32 (128
//    registers a thread at dh = 256) stays in registers across the whole
//    kv sweep. Row max and row sum reduce over the 4 threads of a quad by
//    shuffles; the S accumulator is re-packed to bf16 in registers as the
//    A operand of P V (p rounds to bf16 there; scores, max, sum and O stay
//    f32). Scores are kept in log2 units (scale * log2(e) folded into one
//    multiply) and exponentiated by exp2f.
//  * loads overlap the products (cp.async, 16 bytes a copy, in the
//    FlashAttention-2 order, one buffer each for K and V): V(j) is issued
//    before S = Q K(j)^T, and K(j + 1) as soon as every warp is done with
//    K(j), so S hides V's load and the softmax and P V hide K's.
//  * the kv tiles a query tile visits are classified by one rule
//    (fa_tiles, the same as kernels/flash_attention.py::kv_tiles): tiles
//    outside the band are never visited (windowed attention is O(S * w),
//    like the TPU kernel's pl.when); of the visited tiles, the interior
//    ones, every key live for every query row of the tile, are neither
//    masked nor checked. Only the diagonal tile, the window's lower-edge
//    tile and a tile reaching past S run the mask, before the exp.
//  * any S: rows and keys past S are zero-filled by the cp.async src-size
//    operand and masked; the TPU kernel's requirement that S divide by its
//    blocks is gone.
// Times on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke and
// tests/torch_k7_k8_ablations.py, PERF.md section 6) at q (4, 16, 4096,
// 256), one kv head: window 2048 1.74 ms (3.60 ms before this design; 24%
// of the 0.417 ms bound), window 0 2.28 ms, where SDPA's causal path takes
// 0.86 ms. Without the overlapped loads 1.90 ms, with every tile masked
// 2.13 ms; 128-query tiles (8 warps), 32-key tiles with one or two
// buffers, and two 64-key buffers were slower. Without the K and V
// fragment reads from shared memory it would take 1.50 ms: at dh = 256 a
// 16-row warp must hold O in 128 registers, so each of the four warps
// reads all of K and V from shared memory for itself (wgmma, which reads
// them once per warpgroup, is later work).
// The f32 kernel (flash_fwd_f32) keeps f32 end to end with plain FMAs
// (the tensor cores would round to TF32): 128 threads per 16-query tile,
// 8 threads per query row, 32-key tiles in shared memory, synchronous
// loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_NEG_INF (-1e30f)
#define FA_LOG2E 1.4426950408889634f

// ------------------------------------------------------------ bf16, mma

#define FA_WARPS 4
#define FA_BK 64
#define FA_PAD 8

__device__ __forceinline__ void fa_mma(float (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four 8 x 8 bf16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8; register i holds matrix i's (row
// g, columns 2t, 2t + 1), or with .trans its (rows 2t, 2t + 1, column g),
// as mma.sync's fragments take them
__device__ __forceinline__ void fa_ldm4(uint32_t (&r)[4],
                                        const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void fa_ldm4t(uint32_t (&r)[4],
                                         const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ uint32_t fa_pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from device to shared memory without passing through
// registers (cp.async, L2 only); `bytes` 0 writes 16 zero bytes and reads
// nothing. Visible to the thread after a wait on its group, to the block
// after that and a __syncthreads.
__device__ __forceinline__ void fa_cp16(void* smem, const void* gmem,
                                        int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void fa_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `n` of the thread's newest groups are in flight
template <int n>
__device__ __forceinline__ void fa_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// ROWS rows of dh bf16 from row0 on into shared memory (row stride LD) by
// cp.async, rows at or past S as zeros
template <int HD, int ROWS, int NTHREADS>
__device__ __forceinline__ void fa_cp_tile(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int row0, int S) {
  constexpr int LD = HD + FA_PAD;
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool in = row0 + r < S;
    fa_cp16(dst + r * LD + c,
            in ? src + (long long)(row0 + r) * HD + c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ bool fa_live(int key, int qpos, int S,
                                        int window) {
  return key <= qpos && key < S && (window <= 0 || key > qpos - window);
}

// The kv tiles of bk keys that the query rows [q0, q_last] visit, [lo,
// hi], and among them the interior ones, [ilo, ihi] (empty when ilo >
// ihi): every key of an interior tile is live for every one of the rows
// (at most q0, so before S; above q_last - window). A tile outside [lo,
// hi] holds no live key. kernels/flash_attention.py::kv_tiles is the same
// rule, and its tests hold it against the band mask.
__device__ __forceinline__ void fa_tiles(int q0, int q_last, int window,
                                         int bk, int& lo, int& hi, int& ilo,
                                         int& ihi) {
  hi = q_last / bk;
  lo = (window > 0 && q0 - window + 1 > 0) ? (q0 - window + 1) / bk : 0;
  ihi = (q0 + 1) / bk - 1;
  ilo = (window > 0 && q_last - window + 1 > 0)
            ? (q_last - window + 1 + bk - 1) / bk
            : 0;
}

// One kv tile's scores s (log2 units after the scale) into p, the running
// max and sum of rows g and g + 8 updated, alpha the rescale of O; MASK
// checks every (query, key) pair, else every pair is live.
template <bool MASK, int NT>
__device__ __forceinline__ void fa_softmax(float (&s)[NT][4], float (&m_r)[2],
                                           float (&l_r)[2], float (&alpha)[2],
                                           float scale_log2, int k0,
                                           const int (&qpos)[2], int t, int S,
                                           int window) {
  float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      float val = s[nt][e] * scale_log2;
      if (MASK && !fa_live(k0 + nt * 8 + 2 * t + (e & 1), qpos[rr], S,
                           window))
        val = FA_NEG_INF;
      s[nt][e] = val;
      mx[rr] = fmaxf(mx[rr], val);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m_r[rr], mx[rr]);
    alpha[rr] = exp2f(m_r[rr] - m_new);
    m_r[rr] = m_new;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      float p = exp2f(s[nt][e] - m_r[rr]);
      if (MASK && !fa_live(k0 + nt * 8 + 2 * t + (e & 1), qpos[rr], S,
                           window))
        p = 0.f;  // a row with no live key yet has m_r = NEG_INF
      s[nt][e] = p;
      sum[rr] += p;
    }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
    sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
    l_r[rr] = l_r[rr] * alpha[rr] + sum[rr];
  }
}

template <int HD>
__global__ void __launch_bounds__(FA_WARPS * 32)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int H, int Hkv, int S,
                   int window, float scale_log2) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  constexpr int BQ = 16 * FA_WARPS, NTHREADS = 32 * FA_WARPS;
  constexpr int LD = HD + FA_PAD;
  constexpr int NT = FA_BK / 8;  // 8-key n-tiles of S
  constexpr int DT = HD / 8;     // 8-column n-tiles of O
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + FA_BK * LD;

  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const long long qoff = ((long long)bb * H + h) * S * (long long)HD;
  const long long kvoff = ((long long)bb * Hkv + hk) * S * (long long)HD;
  const __nv_bfloat16* qg = q + qoff;
  const __nv_bfloat16* kg = k + kvoff;
  const __nv_bfloat16* vg = v + kvoff;
  __nv_bfloat16* og = o + qoff;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;
  const int qpos[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  // ldmatrix addresses: for Q (A) and V (.trans), rows + 8 in blocks 1, 3
  // and columns + 8 in blocks 2, 3; for K, keys + 8 in blocks 2, 3 and
  // columns + 8 in blocks 1, 3
  const int ar = (lane & 7) + (((lane >> 3) & 1) << 3), ac = (lane >> 4) << 3;
  const int kr = (lane & 7) + ((lane >> 4) << 3), kc = ((lane >> 3) & 1) << 3;

  int lo, hi, ilo, ihi;
  fa_tiles(q0, min(q0 + BQ, S) - 1, window, FA_BK, lo, hi, ilo, ihi);

  fa_cp_tile<HD, BQ, NTHREADS>(Qs, qg, q0, S);
  fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, lo * FA_BK, S);
  fa_cp_commit();

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_r[2] = {FA_NEG_INF, FA_NEG_INF};
  float l_r[2] = {0.f, 0.f};

  for (int j = lo; j <= hi; ++j) {
    const int k0 = j * FA_BK;
    fa_cp_wait<0>();
    __syncthreads();  // K(j) has landed; every warp is done with V(j - 1)
    fa_cp_tile<HD, FA_BK, NTHREADS>(Vs, vg, k0, S);
    fa_cp_commit();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      fa_ldm4(qa, Qs + (r0 + ar) * LD + kk * 16 + ac);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t kb[4];
        fa_ldm4(kb, Ks + (nt * 8 + kr) * LD + kk * 16 + kc);
        fa_mma(s[nt], qa, kb[0], kb[1]);
        fa_mma(s[nt + 1], qa, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with K(j)
    if (j < hi) {
      fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, k0 + FA_BK, S);
      fa_cp_commit();
    }

    float alpha[2];
    if (j >= ilo && j <= ihi)
      fa_softmax<false>(s, m_r, l_r, alpha, scale_log2, k0, qpos, t, S,
                        window);
    else
      fa_softmax<true>(s, m_r, l_r, alpha, scale_log2, k0, qpos, t, S,
                       window);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    if (j < hi)
      fa_cp_wait<1>();
    else
      fa_cp_wait<0>();
    __syncthreads();  // V(j) has landed

    // O += P V: the S accumulator of two n-tiles is one A operand; V's
    // fragments for two 8-column tiles of O by one ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t pa[4] = {fa_pack_f32(s[2 * kk][0], s[2 * kk][1]),
                              fa_pack_f32(s[2 * kk][2], s[2 * kk][3]),
                              fa_pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              fa_pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t vb[4];
        fa_ldm4t(vb, Vs + (kk * 16 + ar) * LD + d * 8 + ac);
        fa_mma(acc[d], pa, vb[0], vb[1]);
        fa_mma(acc[d + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // out = acc / l, rows past S not stored
  const float l0 = fmaxf(l_r[0], 1e-30f), l1 = fmaxf(l_r[1], 1e-30f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (qpos[0] < S)
      *reinterpret_cast<uint32_t*>(og + (long long)qpos[0] * HD + col) =
          fa_pack_f32(acc[d][0] / l0, acc[d][1] / l0);
    if (qpos[1] < S)
      *reinterpret_cast<uint32_t*>(og + (long long)qpos[1] * HD + col) =
          fa_pack_f32(acc[d][2] / l1, acc[d][3] / l1);
  }
}

// --------------------------------------------------------------- f32, FMA

#define FB_BQ 16
#define FB_BK 32
#define FB_THREADS 128  // 8 threads per query row

template <int HD>
__global__ void __launch_bounds__(FB_THREADS)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int H,
                  int Hkv, int S, int window, float scale) {
  extern __shared__ __align__(16) unsigned char fb_smem[];
  constexpr int LD = HD + 1;     // odd stride: the 8 keys of a row's
                                 // threads fall in distinct banks
  constexpr int DPT = HD / 8;    // output columns per thread
  constexpr int KPT = FB_BK / 8; // keys per thread in a tile
  float* Qs = reinterpret_cast<float*>(fb_smem);
  float* Ks = Qs + FB_BQ * LD;
  float* Vs = Ks + FB_BK * LD;
  float* Ps = Vs + FB_BK * LD;  // FB_BQ x (FB_BK + 1)

  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * FB_BQ;
  const long long qoff = ((long long)bb * H + h) * S * (long long)HD;
  const long long kvoff = ((long long)bb * Hkv + hk) * S * (long long)HD;
  const float* qg = q + qoff;
  const float* kg = k + kvoff;
  const float* vg = v + kvoff;
  float* og = o + qoff;

  const int r = threadIdx.x >> 3, c8 = threadIdx.x & 7;
  const int qpos = q0 + r;

  for (int i = threadIdx.x; i < FB_BQ * HD; i += FB_THREADS) {
    const int rr = i / HD, cc = i % HD;
    Qs[rr * LD + cc] = (q0 + rr < S) ? qg[(long long)(q0 + rr) * HD + cc]
                                     : 0.f;
  }

  const int q_last = min(q0 + FB_BQ, S) - 1;
  const int j_hi = q_last / FB_BK;
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / FB_BK;

  float acc[DPT];
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m_r = FA_NEG_INF, l_r = 0.f;

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * FB_BK;
    __syncthreads();
    for (int i = threadIdx.x; i < FB_BK * HD; i += FB_THREADS) {
      const int rr = i / HD, cc = i % HD;
      const bool in = k0 + rr < S;
      Ks[rr * LD + cc] = in ? kg[(long long)(k0 + rr) * HD + cc] : 0.f;
      Vs[rr * LD + cc] = in ? vg[(long long)(k0 + rr) * HD + cc] : 0.f;
    }
    __syncthreads();

    float s[KPT];
    float mx = FA_NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kl = c8 + 8 * i;
      float dot = 0.f;
      for (int d = 0; d < HD; ++d) dot += Qs[r * LD + d] * Ks[kl * LD + d];
      s[i] = fa_live(k0 + kl, qpos, S, window) ? dot * scale : FA_NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int o_ = 1; o_ < 8; o_ <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
    const float m_new = fmaxf(m_r, mx);
    const float alpha = expf(m_r - m_new);
    m_r = m_new;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int kl = c8 + 8 * i;
      const float p =
          fa_live(k0 + kl, qpos, S, window) ? expf(s[i] - m_new) : 0.f;
      Ps[r * (FB_BK + 1) + kl] = p;
      sum += p;
    }
#pragma unroll
    for (int o_ = 1; o_ < 8; o_ <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o_);
    l_r = l_r * alpha + sum;
    __syncwarp();  // a row's 8 threads share one warp
#pragma unroll
    for (int d = 0; d < DPT; ++d) {
      const int col = c8 + 8 * d;
      float pv = 0.f;
      for (int kl = 0; kl < FB_BK; ++kl)
        pv += Ps[r * (FB_BK + 1) + kl] * Vs[kl * LD + col];
      acc[d] = acc[d] * alpha + pv;
    }
    __syncwarp();
  }

  if (qpos < S) {
    const float l = fmaxf(l_r, 1e-30f);
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      og[(long long)qpos * HD + c8 + 8 * d] = acc[d] / l;
  }
}

// ------------------------------------------------------------- dispatch

template <int HD>
static cudaError_t fa_launch_bf16(const void* q, const void* k,
                                  const void* v, void* o, int B, int H,
                                  int Hkv, int S, int window, float scale,
                                  cudaStream_t stream) {
  constexpr int BQ = 16 * FA_WARPS;
  const int smem = (BQ + 2 * FA_BK) * (HD + FA_PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_bf16<HD><<<grid, 32 * FA_WARPS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hkv, S, window, scale * FA_LOG2E);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t fa_launch_f32(const void* q, const void* k, const void* v,
                                 void* o, int B, int H, int Hkv, int S,
                                 int window, float scale,
                                 cudaStream_t stream) {
  const int smem =
      ((FB_BQ + 2 * FB_BK) * (HD + 1) + FB_BQ * (FB_BK + 1)) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + FB_BQ - 1) / FB_BQ, H, B);
  flash_fwd_f32<HD><<<grid, FB_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, S,
      window, scale);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t fa_launch(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Hkv, int S,
                             int window, float scale, int dtype,
                             cudaStream_t stream) {
  if (dtype == 1)
    return fa_launch_bf16<HD>(q, k, v, o, B, H, Hkv, S, window, scale,
                              stream);
  if (dtype == 0)
    return fa_launch_f32<HD>(q, k, v, o, B, H, Hkv, S, window, scale,
                             stream);
  return cudaErrorInvalidValue;
}

extern "C" {

// q, o: (B, H, S, head_dim); k, v: (B, Hkv, S, head_dim), contiguous,
// 16-byte aligned; H a multiple of Hkv; dtype 0 = float32, 1 = bfloat16;
// head_dim one of 16, 32, 64, 128, 256.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Hkv, int S,
                            int head_dim, int window, float scale, int dtype,
                            void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0 ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return (int)fa_launch<16>(q, k, v, o, B, H, Hkv, S, window, scale,
                                dtype, s);
    case 32:
      return (int)fa_launch<32>(q, k, v, o, B, H, Hkv, S, window, scale,
                                dtype, s);
    case 64:
      return (int)fa_launch<64>(q, k, v, o, B, H, Hkv, S, window, scale,
                                dtype, s);
    case 128:
      return (int)fa_launch<128>(q, k, v, o, B, H, Hkv, S, window, scale,
                                 dtype, s);
    case 256:
      return (int)fa_launch<256>(q, k, v, o, B, H, Hkv, S, window, scale,
                                 dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
