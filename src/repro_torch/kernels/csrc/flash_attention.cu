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
//  * one block of 4 warps per (64-query tile, head, batch); each warp owns
//    16 query rows. Q, K and V tiles of 64 x dh bf16 sit in shared memory
//    (rows padded by 8 elements: conflict-free fragment loads); at dh =
//    256 that is 3 x 33 KB, above the 48 KB static limit, so the launch
//    raises the block's dynamic shared-memory limit
//    (cudaFuncSetAttribute).
//  * both products run on the tensor cores through mma.sync m16n8k16
//    (bf16 in, f32 accumulate), whose register layout is documented: the
//    S = Q K^T accumulator of a warp is 16 x 64 f32 in 32 registers a
//    thread, and the O accumulator 16 x dh f32 (128 registers a thread at
//    dh = 256) stays in registers across the whole kv sweep. Row max and
//    row sum reduce over the 4 threads of a quad by shuffles; the S
//    accumulator is re-packed to bf16 in registers as the A operand of
//    P V (p rounds to bf16 there; scores, max, sum and O stay f32).
//  * fully masked kv tiles are skipped: the kv loop runs only over tiles
//    that meet the causal band of the query tile (and the window), which
//    makes windowed attention O(S * w) like the TPU kernel's pl.when.
//  * any S: rows and keys past S are zero-filled on load and masked; the
//    TPU kernel's requirement that S divide by its blocks is gone.
//  * simple first: synchronous tile loads, no cp.async / TMA / wgmma
//    pipeline yet (later work).
// The f32 kernel (flash_fwd_f32) keeps f32 end to end with plain FMAs
// (the tensor cores would round to TF32): 128 threads per 16-query tile,
// 8 threads per query row, 32-key tiles in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FA_NEG_INF (-1e30f)

// ------------------------------------------------------------ bf16, mma

#define FA_BQ 64
#define FA_BK 64
#define FA_THREADS 128
#define FA_PAD 8

__device__ __forceinline__ void fa_mma(float (&d)[4], uint32_t a0,
                                       uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t fa_ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from two addresses, the first in the low half
__device__ __forceinline__ uint32_t fa_pack2(const __nv_bfloat16* lo,
                                             const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t fa_pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of dh bf16 from row0 on into shared memory (row stride LD),
// rows at or past S as zeros
template <int HD>
__device__ __forceinline__ void fa_load_tile(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int row0, int S) {
  constexpr int LD = HD + FA_PAD;
  constexpr int VPR = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += FA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * HD +
                                            c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ bool fa_live(int key, int qpos, int S,
                                        int window) {
  return key <= qpos && key < S && (window <= 0 || key > qpos - window);
}

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int H, int Hkv, int S,
                   int window, float scale) {
  extern __shared__ __align__(16) unsigned char fa_smem[];
  constexpr int LD = HD + FA_PAD;
  constexpr int NT = FA_BK / 8;  // 8-key n-tiles of S
  constexpr int DT = HD / 8;     // 8-column n-tiles of O
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fa_smem);
  __nv_bfloat16* Ks = Qs + FA_BQ * LD;
  __nv_bfloat16* Vs = Ks + FA_BK * LD;

  const int h = blockIdx.y, bb = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * FA_BQ;
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

  fa_load_tile<HD>(Qs, qg, q0, S);

  // kv tiles that meet the band of this query tile
  const int q_last = min(q0 + FA_BQ, S) - 1;
  const int j_hi = q_last / FA_BK;
  int j_lo = 0;
  if (window > 0 && q0 - window + 1 > 0) j_lo = (q0 - window + 1) / FA_BK;

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.f;
  float m_r[2] = {FA_NEG_INF, FA_NEG_INF};
  float l_r[2] = {0.f, 0.f};

  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * FA_BK;
    __syncthreads();  // the previous tile's readers are done
    fa_load_tile<HD>(Ks, kg, k0, S);
    fa_load_tile<HD>(Vs, vg, k0, S);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const __nv_bfloat16* qa = Qs + (r0 + g) * LD + kk * 16 + 2 * t;
      const uint32_t a0 = fa_ld32(qa), a1 = fa_ld32(qa + 8 * LD);
      const uint32_t a2 = fa_ld32(qa + 8), a3 = fa_ld32(qa + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* kb = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        fa_mma(s[nt], a0, a1, a2, a3, fa_ld32(kb), fa_ld32(kb + 8));
      }
    }

    // scale, mask and the tile's row max (rows g and g + 8)
    float mx[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float val = fa_live(key, qpos[rr], S, window)
                              ? s[nt][e] * scale
                              : FA_NEG_INF;
        s[nt][e] = val;
        mx[rr] = fmaxf(mx[rr], val);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m_r[rr], mx[rr]);
      alpha[rr] = expf(m_r[rr] - m_new);
      m_r[rr] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1;
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const float p = fa_live(key, qpos[rr], S, window)
                            ? expf(s[nt][e] - m_r[rr])
                            : 0.f;
        s[nt][e] = p;
        sum[rr] += p;
      }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 1);
      sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], 2);
      l_r[rr] = l_r[rr] * alpha[rr] + sum[rr];
    }
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: the S accumulator of two n-tiles is one A operand
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t a0 = fa_pack_f32(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = fa_pack_f32(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = fa_pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = fa_pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * t) * LD + d * 8 + g;
        const uint32_t b0 = fa_pack2(vb, vb + LD);
        const uint32_t b1 = fa_pack2(vb + 8 * LD, vb + 9 * LD);
        fa_mma(acc[d], a0, a1, a2, a3, b0, b1);
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
  const int smem = 3 * 64 * (HD + FA_PAD) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + FA_BQ - 1) / FA_BQ, H, B);
  flash_fwd_bf16<HD><<<grid, FA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hkv, S, window, scale);
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
