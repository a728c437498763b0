// Causal / sliding-window GQA flash attention for Hopper (sm_90a): K8 of
// the port.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas (_kernel):
// out = softmax(mask(q k^T * scale)) v per (batch, head), online softmax
// over kv tiles with running (m, l, acc), query i attending key j iff
// j <= i and (window == 0 or j > i - window). q is (B, H, S, dh), k and v
// (B, Hkv, S, dh); query head h reads kv head h / (H / Hkv) in place (no
// expanded copy). NEG_INF = -1e30 and p = 0 on masked lanes, as the TPU
// kernel has them, so a fully masked row stays finite (l = 0 -> out = 0 /
// 1e-30 = 0). Scores, row max, row sum and O are f32; p rounds to bf16 for
// the second product.
//
// What bounds it: operations. At (4, 16, 4096, 256) bf16 with window 2048
// the unmasked band is sum_q min(q + 1, w) = 6.29M (q, k) pairs per
// (b, h), 4 * dh flops each: 0.41 TFLOP, 0.42 ms at 989 TFLOP/s, against
// 285 MB of q, k, v and out (0.085 ms at 3.35 TB/s); causal 0.556 ms at
// head dim 256, 0.278 ms at 128 with 16 heads.
//
// Three kernels; the wrapper (kernels/flash_attention.py::kernel_for) picks
// one by dtype and head dim:
//
// flash_fwd_wgmma, bf16 at head dims 64, 128 and 256 (every main path):
//  * one block per (query tile of BQ = 64 * FA_NWG rows, batch * head) on a
//    1-D grid, the query tiles with the most kv tiles first: a head's
//    tiles together where K and V fill more than half of the L2 (they stay
//    there while its tiles run), else every head's tile of one length
//    together (the better balance). FA_NWG = 2 consumer warpgroups own 64
//    query rows each; one producer warpgroup, of which one thread issues
//    every load. setmaxnreg moves registers from the producer (24) to the
//    consumers (240), so O stays in registers: 64 x dh f32, 128 registers
//    a thread at dh = 256.
//  * loads by TMA: Q once, then K and V tiles of BK keys through a ring of
//    FA_STAGES stages, each with a full barrier for K and for V and an empty
//    barrier for K and for V (mbarriers) that every consumer thread
//    arrives on: K's when S is done, V's when P V is, so the next K loads
//    while P V still reads V. Tensor maps (3-D: dh, S, batch * heads;
//    built on the host per call through cudaGetDriverEntryPoint, so the
//    build needs no -lcuda) are __grid_constant__ parameters. Rows past S
//    come in as zeros from TMA's out-of-bounds fill, so no tile reads
//    another head's rows; the output goes out by TMA from the consumer's
//    own Q rows, stores past S clipped. Shared tiles are 64-column (128
//    bytes) chunks in TMA's 128-byte swizzle, which the wgmma descriptors
//    read as they lie.
//  * both products on wgmma (bf16 in, f32 accumulate): S = Q K^T as
//    m64nBKk16 with Q and K K-major from shared memory; O += P V as
//    m64n(dh)k16 with P from registers (the S accumulator of a
//    warpgroup is laid out as the A operand: re-packed to bf16 in place)
//    and V the B operand MN-major, straight from its tile. A warpgroup
//    reads each K and V tile once for its 64 rows (the mma.sync kernel
//    reads them once for every 16-row warp).
//  * FlashAttention-3's order within a warpgroup: S(j) and P(j - 1)
//    V(j - 1) are issued together, O rescaled between them, and the
//    softmax of S(j) runs while P(j - 1) V(j - 1) is on the tensor cores.
//    Ping-pong: the two warpgroups issue their products in turns (named
//    barriers), so one's softmax runs beside the other's products.
//  * the softmax: raw row max, one FFMA and one ex2.approx a score (no
//    per-score scale, select or exp2f range check), O's rescale skipped
//    where no row of the warp has a new maximum, one reciprocal a row at
//    the end.
//  * the kv tiles a query tile visits are classified by one rule
//    (fa_tiles, the same as kernels/flash_attention.py::kv_tiles), per
//    warpgroup: tiles outside its band are never computed (windowed
//    attention is O(S * w), like the TPU kernel's pl.when; a warpgroup
//    releases the block's other tiles unread); of its visited tiles the
//    interior ones, every key live for every row, are neither masked nor
//    checked. Only the diagonal, window-edge and past-S tiles run the mask.
//  * tiles (FA_NWG, FA_STAGES and the FA_CFG lines below, which
//    kernels/flash_attention.py::tiles reads):
//    dh 256: BQ 128, BK 64, 2 stages: Q 64 KB + 4 x 32 KB = 192 KB of the
//    227 KB (BK 128 fits neither the shared memory nor, with O's 128 and
//    S's 64 registers, the 240 a thread).
//    dh 128 and 64: BQ 128, BK 128, 2 stages (160 and 80 KB). One block an
//    SM: 384 threads at 168 registers each fill the register file.
//  What bounds it now (times on an NVIDIA H100 80GB HBM3 at 700 W from
//  chip_smoke and tests/torch_k7_k8_ablations.py, PERF.md section 6): at
//  dh 256 window 2048 0.64 ms, 65% of the bound (the mma.sync kernel: 1.77 ms);
//  causal 0.80 ms, 70%, against SDPA's 0.86 (2.28); dh 128, 64 heads on 8
//  kv heads, 1.79 ms, 62%, against 1.76 (4.48); dh 64 at (2, 24, 1024)
//  0.036 ms against 0.034, a launch of 384 short blocks. Without the
//  overlap it is 8-15% slower, without it and the ping-pong 10-17%,
//  rescaling O at every tile 2-4%, with one consumer warpgroup 28-40%,
//  with BK 64 / 32 up to 30%; three stages or the other block order are
//  within 1%. Without the P V products it would take 11-12%
//  less: the S product (A and B both from shared memory, 96-128 bytes a
//  clock at BK 128 and 64, beside TMA's writes), its softmax (one SFU
//  exponential a score, 16 a clock an SM) and the loads hold the rest.
//
// flash_fwd_mma_sync, bf16 at head dims 16 and 32 (SMOKE configs and
// tests): the earlier Ampere-style design, 4 warps of 16 query rows,
// 64 x 64 tiles padded for ldmatrix, mma.sync m16n8k16, one cp.async
// buffer each for K and V (V(j) under S(j), K(j + 1) under the softmax and
// P V).
//
// flash_fwd_f32 keeps f32 end to end with plain FMAs (the tensor cores
// would round to TF32): 128 threads per 16-query tile, 8 threads per query
// row, 32-key tiles in shared memory, synchronous loads.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // TMA, mbarrier, wgmma helpers; tensor-map encoder

#define FA_NEG_INF (-1e30f)
#define FA_LOG2E 1.4426950408889634f

__device__ __forceinline__ uint32_t fa_pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
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

// 2^x by the SFU alone (exp2f adds a range check and scalings for
// denormal results; a p below 2^-126 is 0 here, far below bf16's reach
// beside the row's maximum, which gives 1)
__device__ __forceinline__ float fa_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One kv tile's raw scores s into p = 2^(s scale_log2 - m scale_log2), the
// running max m (raw units) and sum of rows g and g + 8 updated, alpha the
// rescale of O; MASK sets every dead (query, key) pair to NEG_INF, else
// every pair is live. A row with no live key yet (m = NEG_INF) takes the
// exponent's offset as 0, so its NEG_INF lanes give p = 0 as the others'
// do: one FFMA and one ex2 a score, no select. s[nt][e] is the mma
// accumulator layout (mma.sync's m16n8 tiles, and wgmma's m64nN per
// warp): row g (e < 2) or g + 8, key k0 + 8 nt + 2 t + (e & 1).
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
      if (MASK && !fa_live(k0 + nt * 8 + 2 * t + (e & 1), qpos[rr], S,
                           window))
        s[nt][e] = FA_NEG_INF;
      mx[rr] = fmaxf(mx[rr], s[nt][e]);
    }
  float off[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    const float m_new = fmaxf(m_r[rr], mx[rr]);
    alpha[rr] = fa_ex2((m_r[rr] - m_new) * scale_log2);  // 1 if unchanged
    m_r[rr] = m_new;
    off[rr] = m_new == FA_NEG_INF ? 0.f : m_new * scale_log2;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = e >> 1;
      const float p = fa_ex2(fmaf(s[nt][e], scale_log2, -off[rr]));
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

// ---------------------------------------------- bf16, wgmma + TMA (dh >= 64)

// FA_NWG consumer warpgroups (BQ = 64 FA_NWG query rows, the ping-pong
// below takes two), FA_STAGES ring stages, and the kv tile of BK keys by
// head dim. kernels/flash_attention.py::tiles reads these lines.
#define FA_NWG 2
#define FA_STAGES 2
template <int HD>
struct FaCfg;
#define FA_CFG(HD_, BK_)             \
  template <>                        \
  struct FaCfg<HD_> {                \
    static constexpr int BK = BK_;   \
  };
FA_CFG(64, 128)
FA_CFG(128, 128)
FA_CFG(256, 64)

// fa_softmax for a tile that is interior (no mask) or not
template <int NT>
__device__ __forceinline__ void fa_softmax_class(
    bool interior, float (&s)[NT][4], float (&m_r)[2], float (&l_r)[2],
    float (&alpha)[2], float scale_log2, int k0, const int (&qpos)[2], int t,
    int S, int window) {
  if (interior)
    fa_softmax<false>(s, m_r, l_r, alpha, scale_log2, k0, qpos, t, S, window);
  else
    fa_softmax<true>(s, m_r, l_r, alpha, scale_log2, k0, qpos, t, S, window);
}

// O *= alpha by rows; skipped where no row of the warp has a new maximum
// (alpha exactly 1), which after the first tiles is most tiles
template <int DT>
__device__ __forceinline__ void fa_rescale(float (&acc)[DT][4],
                                           const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    acc[d][0] *= alpha[0];
    acc[d][1] *= alpha[0];
    acc[d][2] *= alpha[1];
    acc[d][3] *= alpha[1];
  }
}

// P for O += P V: the softmaxed S accumulator re-packed to bf16 as the
// A fragments of k-steps kk (keys 16 kk.. of the tile)
template <int BK>
__device__ __forceinline__ void fa_pack_p(uint32_t (&p)[BK / 16][4],
                                          const float (&s)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    p[kk][0] = fa_pack_f32(s[2 * kk][0], s[2 * kk][1]);
    p[kk][1] = fa_pack_f32(s[2 * kk][2], s[2 * kk][3]);
    p[kk][2] = fa_pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    p[kk][3] = fa_pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// S = Q K^T of this warpgroup's 64 rows and one stage's BK keys (issued,
// not waited for): k-step kk reads 16 columns, 32 bytes into the
// 128-byte rows of chunk kk / 4
template <int HD, int BQ, int BK>
__device__ __forceinline__ void fa_issue_qk(float (&s)[BK / 8][4],
                                            uint32_t qa, uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    fa_wgmma_ss(s, fa_desc(qa + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
                fa_desc(ka + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024),
                kk > 0);
}

// O += P V (issued, not waited for): k-step kk takes keys 16 kk.. of the
// stage, 2048 bytes on; V's 64-column chunks lie BK * 128 bytes apart
template <int HD, int BK>
__device__ __forceinline__ void fa_issue_pv(float (&acc)[HD / 8][4],
                                            const uint32_t (&p)[BK / 16][4],
                                            uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    fa_wgmma_rs(acc, p[kk], fa_desc(va + kk * 2048, BK * 128, 1024));
}

template <int HD>
__global__ void __launch_bounds__((FA_NWG + 1) * 128, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap to, int H, int Hkv,
                    int S, int window, float scale_log2, int head_major) {
  constexpr int BK = FaCfg<HD>::BK, NWG = FA_NWG, STAGES = FA_STAGES;
  constexpr int BQ = 64 * NWG;
  constexpr int NCH = HD / 64;  // 64-column (128-byte) chunks of a row
  constexpr uint32_t Q_BYTES = BQ * HD * 2, KV_BYTES = BK * HD * 2;
  constexpr int NT = BK / 8, DT = HD / 8;
  extern __shared__ __align__(1024) unsigned char fa_smem[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  const uint32_t sq = (fa_saddr(fa_smem) + 1023u) & ~1023u;
  const uint32_t sk = sq + Q_BYTES, sv = sk + STAGES * KV_BYTES;
  // barriers: Q, then per stage K full, V full, K empty and V empty (K's
  // stage frees once S is done, before V's)
  const uint32_t bar_q = sv + STAGES * KV_BYTES;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES,
                 bar_ek = bar_v + 8 * STAGES, bar_ev = bar_ek + 8 * STAGES;

  // one block per (query tile, batch * head) on a 1-D grid, longest rows
  // first: head_major runs a head's query tiles together (its K and V stay
  // in L2 while they do), else every head's tile of one length together
  const int nq = (S + BQ - 1) / BQ, nbh = gridDim.x / nq;
  const int bh = head_major ? blockIdx.x / nq : blockIdx.x % nbh;
  const int qt = head_major ? blockIdx.x % nq : blockIdx.x / nbh;
  const int h = bh % H, b = bh / H;
  const int kvh = b * Hkv + h / (H / Hkv);
  const int q0 = (nq - 1 - qt) * BQ;  // longest rows first
  int lo, hi, ilo, ihi;
  fa_tiles(q0, min(q0 + BQ, S) - 1, window, BK, lo, hi, ilo, ihi);

  if (threadIdx.x == 0) {
    fa_bar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      fa_bar_init(bar_k + 8 * st, 1);
      fa_bar_init(bar_v + 8 * st, 1);
      fa_bar_init(bar_ek + 8 * st, NWG * 128);
      fa_bar_init(bar_ev + 8 * st, NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, warp-uniform for the compiler (a wgmma on a path it
  // takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 0) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      fa_bar_expect(bar_q, Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        fa_tma_load(sq + c * BQ * 128, &tq, bar_q, c * 64, q0, bh);
      for (int j = lo; j <= hi; ++j) {
        const int i = j - lo, st = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        fa_bar_wait(bar_ek + 8 * st, free_parity);
        fa_bar_expect(bar_k + 8 * st, KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          fa_tma_load(sk + st * KV_BYTES + c * BK * 128, &tk, bar_k + 8 * st,
                      c * 64, j * BK, kvh);
        fa_bar_wait(bar_ev + 8 * st, free_parity);
        fa_bar_expect(bar_v + 8 * st, KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          fa_tma_load(sv + st * KV_BYTES + c * BK * 128, &tv, bar_v + 8 * st,
                      c * 64, j * BK, kvh);
      }
    }
    return;
  }

  // consumer warpgroup cw: query rows [qw, qw + 64)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int cw = wg - 1;
  const int wt = threadIdx.x % 128, warp = wt >> 5, lane = wt & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = q0 + 64 * cw;
  const int qpos[2] = {qw + 16 * warp + g, qw + 16 * warp + g + 8};
  // this warpgroup's own tiles [wlo, whi] within the block's [lo, hi]
  int wlo = hi + 1, whi = hi, wilo = 0, wihi = -1;
  if (qw < S) fa_tiles(qw, min(qw + 64, S) - 1, window, BK, wlo, whi, wilo,
                       wihi);
  const uint32_t qa = sq + cw * 64 * 128;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  uint32_t p[BK / 16][4];
  float m_r[2] = {FA_NEG_INF, FA_NEG_INF};
  float l_r[2] = {0.f, 0.f};
  float alpha[2];

  auto stage = [&](int j) { return (j - lo) % STAGES; };
  auto parity = [&](int j) {
    return static_cast<uint32_t>(((j - lo) / STAGES) & 1);
  };
  // the block's tiles outside this warpgroup's band: released unread
  auto pass = [&](int j) {
    fa_bar_wait(bar_k + 8 * stage(j), parity(j));
    fa_bar_wait(bar_v + 8 * stage(j), parity(j));
    fa_bar_arrive(bar_ek + 8 * stage(j));
    fa_bar_arrive(bar_ev + 8 * stage(j));
  };
  // ping-pong: the two warpgroups issue their products in turns (named
  // barriers 3 and 4), so one's softmax runs while the other's products
  // hold the tensor cores. Each takes the same number of turns, one a
  // block tile + 1: a tile outside its band takes an empty turn where it
  // comes, so neither waits for a turn that the other can only give after
  // a ring stage this one still holds. Warpgroup 1 gives warpgroup 0 the
  // first turn and gives none after its own last (a model of these
  // barriers: tests/test_torch_attention_tiles.py).
  const int all_turns = hi - lo + 2;
  int turns = 0;
  auto turn_begin = [&]() { fa_named_sync(3 + cw, 256); };
  auto turn_end = [&]() {
    if (++turns < all_turns || cw == 0) fa_named_arrive(4 - cw, 256);
  };
  auto pass_turn = [&](int j) {
    pass(j);
    turn_begin();
    turn_end();
  };
  if (cw == 1) fa_named_arrive(3, 256);

  fa_bar_wait(bar_q, 0);
  for (int j = lo; j < wlo; ++j) pass_turn(j);
  // FlashAttention-3's order: S(j) and P(j - 1) V(j - 1) in flight
  // together, O rescaled for tile j - 1 between their issues, the softmax
  // of S(j) while P(j - 1) V(j - 1) is on the tensor cores
  if (wlo <= whi) {
    fa_bar_wait(bar_k + 8 * stage(wlo), parity(wlo));
    turn_begin();
    fa_wgmma_fence();
    fa_issue_qk<HD, BQ, BK>(s, qa, sk + stage(wlo) * KV_BYTES);
    fa_wgmma_commit();
    turn_end();
    fa_wgmma_wait<0>();
    fa_fence_regs(s);
    fa_bar_arrive(bar_ek + 8 * stage(wlo));
    fa_softmax_class(wlo >= wilo && wlo <= wihi, s, m_r, l_r, alpha,
                     scale_log2, wlo * BK, qpos, t, S, window);
    fa_pack_p<BK>(p, s);
    for (int j = wlo + 1; j <= whi; ++j) {
      fa_bar_wait(bar_k + 8 * stage(j), parity(j));
      turn_begin();
      fa_wgmma_fence();
      fa_issue_qk<HD, BQ, BK>(s, qa, sk + stage(j) * KV_BYTES);
      fa_wgmma_commit();
      fa_rescale(acc, alpha);
      fa_bar_wait(bar_v + 8 * stage(j - 1), parity(j - 1));
      fa_wgmma_fence();
      fa_issue_pv<HD, BK>(acc, p, sv + stage(j - 1) * KV_BYTES);
      fa_wgmma_commit();
      turn_end();
      fa_wgmma_wait<1>();
      fa_fence_regs(s);
      fa_bar_arrive(bar_ek + 8 * stage(j));
      fa_softmax_class(j >= wilo && j <= wihi, s, m_r, l_r, alpha,
                       scale_log2, j * BK, qpos, t, S, window);
      fa_wgmma_wait<0>();
      fa_fence_regs(acc);
      fa_bar_arrive(bar_ev + 8 * stage(j - 1));
      fa_pack_p<BK>(p, s);
    }
    fa_rescale(acc, alpha);
    fa_bar_wait(bar_v + 8 * stage(whi), parity(whi));
    turn_begin();
    fa_wgmma_fence();
    fa_issue_pv<HD, BK>(acc, p, sv + stage(whi) * KV_BYTES);
    fa_wgmma_commit();
    turn_end();
    fa_wgmma_wait<0>();
    fa_fence_regs(acc);
    fa_bar_arrive(bar_ev + 8 * stage(whi));
  } else {
    turn_begin();  // no row of this warpgroup before S
    turn_end();
  }
  for (int j = whi + 1; j <= hi; ++j) pass_turn(j);
  if (qw >= S) return;

  // out = acc / l (by one reciprocal a row) as bf16 into this warpgroup's
  // own Q rows (no longer read), in the layout TMA's 128-byte swizzle gives
  // them: 16-byte unit u of row r at u ^ (r % 8); then one thread stores
  // the 64 rows by TMA
  const float inv0 = 1.f / fmaxf(l_r[0], 1e-30f),
              inv1 = 1.f / fmaxf(l_r[1], 1e-30f);
  const int r0 = 16 * warp + g;  // r0 % 8 == g, as for r0 + 8
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const uint32_t at = qa + (d / 8) * BQ * 128 + (((d % 8) ^ g) << 4) + 4 * t;
    const uint32_t v0 = fa_pack_f32(acc[d][0] * inv0, acc[d][1] * inv0);
    const uint32_t v1 = fa_pack_f32(acc[d][2] * inv1, acc[d][3] * inv1);
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + r0 * 128), "r"(v0)
                 : "memory");
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at + (r0 + 8) * 128),
                 "r"(v1)
                 : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  if (wt == 0) {
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      fa_tma_store(&to, qa + c * BQ * 128, c * 64, qw, bh);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ------------------------------------------- bf16, mma.sync (dh 16 and 32)

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

template <int HD>
__global__ void __launch_bounds__(FA_WARPS * 32)
    flash_fwd_mma_sync(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int H, int Hkv, int S,
                       int window, float scale_log2) {
  extern __shared__ __align__(16) unsigned char fa_smem_sync[];
  constexpr int BQ = 16 * FA_WARPS, NTHREADS = 32 * FA_WARPS;
  constexpr int LD = HD + FA_PAD;
  constexpr int NT = FA_BK / 8;  // 8-key n-tiles of S
  constexpr int DT = HD / 8;     // 8-column n-tiles of O
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem_sync);
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
    fa_softmax_class(j >= ilo && j <= ihi, s, m_r, l_r, alpha, scale_log2,
                     k0, qpos, t, S, window);
    fa_rescale(acc, alpha);

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

#define FA_L2_HALF_BYTES (25.0 * (1 << 20))

template <int HD>
static cudaError_t fa_launch_wgmma(const void* q, const void* k,
                                   const void* v, void* o, int B, int H,
                                   int Hkv, int S, int window, float scale,
                                   cudaStream_t stream) {
  constexpr int BK = FaCfg<HD>::BK, BQ = 64 * FA_NWG;
  if ((long long)((S + BQ - 1) / BQ) * B * H > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = fa_map(&tq, q, HD, S, B * H, BQ)) != cudaSuccess ||
      (err = fa_map(&tk, k, HD, S, B * Hkv, BK)) != cudaSuccess ||
      (err = fa_map(&tv, v, HD, S, B * Hkv, BK)) != cudaSuccess ||
      (err = fa_map(&to, o, HD, S, B * H, 64)) != cudaSuccess)
    return err;
  // the heads' tiles in turn where K and V together fill more than half of
  // the 50 MB L2; where they fit, all heads' longest tiles first (the
  // better balance over the SMs)
  const int head_major =
      2.0 * B * Hkv * (double)S * HD * 2 > FA_L2_HALF_BYTES;
  // 1024 bytes of slack to align the tiles, Q, the K and V ring, barriers
  const int smem = 1024 + BQ * HD * 2 + 2 * FA_STAGES * BK * HD * 2 +
                   8 * (1 + 4 * FA_STAGES);
  err = cudaFuncSetAttribute(flash_fwd_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma<HD><<<((S + BQ - 1) / BQ) * B * H, (FA_NWG + 1) * 128,
                        smem, stream>>>(
      tq, tk, tv, to, H, Hkv, S, window, scale * FA_LOG2E, head_major);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t fa_launch_mma_sync(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int S, int window, float scale,
                                      cudaStream_t stream) {
  constexpr int BQ = 16 * FA_WARPS;
  const int smem = (BQ + 2 * FA_BK) * (HD + FA_PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_sync<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_mma_sync<HD><<<grid, 32 * FA_WARPS, smem, stream>>>(
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
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  dim3 grid((S + FB_BQ - 1) / FB_BQ, H, B);
  flash_fwd_f32<HD><<<grid, FB_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Hkv, S,
      window, scale);
  return cudaGetLastError();
}

// kernel 0: f32 (FMA); 1: bf16 mma.sync (head dims 16, 32); 2: bf16
// wgmma + TMA (64, 128, 256)
template <int HD>
static cudaError_t fa_launch(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Hkv, int S,
                             int window, float scale, int kernel,
                             cudaStream_t stream) {
  if (kernel == 0)
    return fa_launch_f32<HD>(q, k, v, o, B, H, Hkv, S, window, scale,
                             stream);
  if constexpr (HD <= 32) {
    if (kernel == 1)
      return fa_launch_mma_sync<HD>(q, k, v, o, B, H, Hkv, S, window, scale,
                                    stream);
  } else {
    if (kernel == 2)
      return fa_launch_wgmma<HD>(q, k, v, o, B, H, Hkv, S, window, scale,
                                 stream);
  }
  return cudaErrorInvalidValue;
}

extern "C" {

// q, o: (B, H, S, head_dim); k, v: (B, Hkv, S, head_dim), contiguous,
// 16-byte aligned; H a multiple of Hkv; head_dim one of 16, 32, 64, 128,
// 256; kernel 0 for float32 tensors, 1 (head dims 16, 32) or 2 (64, 128,
// 256) for bfloat16 ones.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, int B, int H, int Hkv, int S,
                            int head_dim, int window, float scale, int kernel,
                            void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || S <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return (int)fa_launch<16>(q, k, v, o, B, H, Hkv, S, window, scale,
                                kernel, s);
    case 32:
      return (int)fa_launch<32>(q, k, v, o, B, H, Hkv, S, window, scale,
                                kernel, s);
    case 64:
      return (int)fa_launch<64>(q, k, v, o, B, H, Hkv, S, window, scale,
                                kernel, s);
    case 128:
      return (int)fa_launch<128>(q, k, v, o, B, H, Hkv, S, window, scale,
                                 kernel, s);
    case 256:
      return (int)fa_launch<256>(q, k, v, o, B, H, Hkv, S, window, scale,
                                 kernel, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
