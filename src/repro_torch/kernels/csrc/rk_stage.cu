// Fused Runge-Kutta stage kernels for Hopper (sm_90a): K1-K6 of the port,
// K1-K5 the kernels of every adaptive trial on the flat-state paths.
//
// K1 rk_stage_increment replaces the TPU kernel
//   src/repro/kernels/rk_stage.py::rk_stage_increment_pallas (_incr_kernel):
//   out = z + h * sum_j a_j k_j, zero weights skipped, f32 accumulation,
//   output in z's dtype.
// K2 rk_stage_combine_err replaces the TPU kernel
//   src/repro/kernels/rk_stage.py::rk_stage_combine_err_pallas
//   (_combine_err_kernel):
//   zn = z + h * sum_i b_i k_i, err = h * sum_i e_i k_i (stored only when
//   asked for), and one partial sum per block of
//   (err / (atol + rtol * max(|z|, |zn|)))^2.
// K3 rk_stage_increment_batched replaces
//   rk_stage.py::rk_stage_increment_batched_pallas (_incr_batched_kernel):
//   K1 on each row b of a (B, N) state with the row's own stepsize h[b];
//   k is (j, B, N). A row with h[b] = 0 computes z + 0 * acc, which is z.
// K4 rk_stage_combine_err_batched replaces
//   rk_stage.py::rk_stage_combine_err_batched_pallas
//   (_combine_err_batched_kernel):
//   K2 per row without the err store; norm partials (B, P), one per tile
//   of RK_TILE elements of a row as in the reference, scalar rtol/atol
//   passed by value.
// K5 rk_stage_combine_err_batched_rowtol replaces
//   rk_stage.py::rk_stage_combine_err_batched_rowtol_pallas
//   (_combine_err_batched_rowtol_kernel):
//   K4 with rtol[b], atol[b] loaded per row from (B,) device arrays. The
//   arithmetic is K4's, so a row at the same tolerance is bitwise K4's.
//
// K6 rk_stage_combine replaces rk_stage.py::rk_stage_combine_pallas
//   (_kernel): K2's combine with the (N,) err always stored and no norm
//   (a K2 template variant). No solver path launches it; it completes the
//   set, as the reference's ops.rk_stage_combine does.
//
// All six are bounded by bytes, not operations: each element costs a few
// flops against 4 (f32) or 2 (bf16) bytes per array touched. At the NODE18
// block's state (8*512*768 = 3,145,728 f32 values, 12.6 MB), solo (N) or
// batched (B = 8 rows of 393,216):
//   K1/K3 with one stage (HeunEuler) read 2 and write 1 state: 37.7 MB,
//   11.3 us at 3.35 TB/s;
//   K2/K4/K5 for HeunEuler without err read 3 and write 1: 50.3 MB, 15.0 us;
//   for Dopri5 (6 of 7 stages read) 8 and 1: 113 MB;
//   K6 for HeunEuler reads 3 and writes 2 (z_next and the f32 err): 62.9
//   MB, 18.8 us.
// The design therefore only has to stream: for K2 and K6 a grid-stride
// loop over 16-byte vectors (4 f32 or 8 bf16 per thread per load) when N
// is a multiple of the vector width and every base pointer is 16-byte
// aligned, else one element per thread per load. The ragged tail is masked
// by the loop bound; nothing is padded or copied. The batched kernels use
// a 2-D grid whose blockIdx.y is the row.
//
// K3 streams 16-byte vectors whatever N is. Row r of z, of out and of
// every stage of k starts at one offset modulo 16 bytes exactly when
// (rows * N) % V == 0 (V the vector width) and the three base pointers
// are mutually aligned modulo 16 bytes; the wrapper checks that once per
// call (and allocates out at z's offset). Each row then peels a scalar
// head up to its first 16-byte boundary and a scalar tail, and streams the
// rest in vectors, RK_UNROLL a thread and pass, all of a pass's loads
// (z and every stage read) issued before its arithmetic; its grid covers
// each row in one pass.
// Otherwise (for example (3, 4097) in f32, or a z at an offset that k
// does not share) K3 runs one element per thread per load, as before. K1
// shares the row code with one vector a pass, its own rule for the vector
// path and K3's one-pass grid on it (a grid capped at one wave of 8
// blocks an SM was slower for both); K2 and K6 keep the rule and grid of
// the paragraph above.
//
// K4 and K5 take K3's rule for the vector path and allocate z_next at z's
// offset, but a block owns one tile of RK_TILE elements of a row (grid
// (ceil(N / RK_TILE), B)): the tile peels its own scalar head and tail
// (RK_TILE is a multiple of the vector width, so every tile of a row has
// the row's head) and streams the rest in vectors, RK_TILE_UNROLL a thread
// and pass with all of a pass's loads issued before its arithmetic. No
// vector crosses a tile edge, so no element is counted twice or dropped.
// Each element's r^2 goes to shared memory at its position in the tile,
// and tile_sum adds the tile in one fixed order by position. The scalar
// path fills the same positions, so it gives the same bits.
// K1, K3, K4 and K5 read at most RK_FEW_STAGES stages through kernels
// that hold only that many stages' loads in registers.
//
// Rounding: the accumulation follows the Pallas body exactly
// (acc = 0; acc = acc + a_j*k_j for ascending j, skipping a_j == 0; then
// out = z + h*acc), with __fmul_rn/__fadd_rn so that nvcc does not contract
// the pairs into FMAs; the scale atol + rtol*max(|z|,|zn|) is rounded the
// same way. z_next and err are then bitwise equal to the plain PyTorch
// versions in rk_stage.py on the same inputs.
//
// h (and K5's tolerances) are read from device memory, so a solve never
// copies a stepsize or tolerance to the host. The tableau row is a
// by-value argument (at most 7 weights and a count); a zero weight is
// skipped by a branch that is uniform across the grid. The norm partials
// are written without atomics, each summed in a fixed order: K2's one per
// block (the grid depends on N alone), K4's and K5's one per tile of a row
// into partials[row * S + tile] for tile < P = ceil(N / RK_TILE), S the
// caller's row stride. A row's partials then depend on N and its own
// values alone: not on B, the other rows, the offset of its buffer or the
// path the kernel took. The caller sums each row's partials (it rounds S
// up to 4 floats, so that torch's sum adds every row in one order), and a
// served request's accept decisions are its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RK_MAX_STAGES 7
#define RK_THREADS 256
#define RK_MAX_ROWS 65535   // gridDim.y
// K1/K3/K4/K5 with at most this many stages (HeunEuler's, Bogacki-
// Shampine's first rows) hold fewer loads in registers than with
// RK_MAX_STAGES
#define RK_FEW_STAGES 2
// K3's 16-byte vectors a thread and pass (2 and 4 were slower:
// tests/torch_k3_k10_ablations.py)
#define RK_UNROLL 1
// K4/K5: elements of a row per norm partial (the reference's _BLOCK), and
// 16-byte vectors a thread and pass (at most the tile's share)
#define RK_TILE 2048
#define RK_TILE_UNROLL 2

static_assert((RK_TILE & (RK_TILE - 1)) == 0 && RK_TILE % RK_THREADS == 0 &&
                  RK_THREADS % 32 == 0,
              "tile_sum halves RK_TILE down to one warp");

struct RkRow {
  float w[RK_MAX_STAGES];
  int n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The raw bits of one load of V values of T: a 16-byte vector when V > 1.
template <typename T, int V>
struct Pack {
  using type = uint4;
};
template <typename T>
struct Pack<T, 1> {
  using type = T;
};

template <typename T, int V>
__device__ __forceinline__ typename Pack<T, V>::type load_pack(
    const T* __restrict__ p) {
  if constexpr (V == 1) {
    return p[0];
  } else {
    static_assert(sizeof(T) * V == 16, "vector loads are 16 bytes");
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const typename Pack<T, V>::type& raw,
                                       float (&x)[V]) {
  if constexpr (V == 1) {
    x[0] = to_f32(raw);
  } else {
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) x[i] = to_f32(e[i]);
  }
}

// V values of T starting at p, widened to f32 (one 16-byte load if V > 1).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&x)[V]) {
  unpack<T, V>(load_pack<T, V>(p), x);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&x)[V]) {
  if constexpr (V == 1) {
    p[0] = from_f32<T>(x[0]);
  } else {
    alignas(16) T e[V];
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(x[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  }
}

// V f32 values; 16-byte stores when V is a multiple of 4.
template <int V>
__device__ __forceinline__ void store_f32(float* __restrict__ p,
                                          const float (&x)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = x[i];
  }
}

// Element i of one state row, with the vector loop's arithmetic.
template <typename T, int NSMAX>
__device__ __forceinline__ void increment_one(const T* __restrict__ z,
                                              const T* __restrict__ k,
                                              long long kstride, float hv,
                                              T* __restrict__ out, long long i,
                                              const RkRow& a) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < NSMAX; ++j)
    if (j < a.n && a.w[j] != 0.0f)
      acc = __fadd_rn(acc, __fmul_rn(a.w[j], to_f32(k[j * kstride + i])));
  out[i] = from_f32<T>(__fadd_rn(to_f32(z[i]), __fmul_rn(hv, acc)));
}

// One state row of n values: out = z + h * sum_j a_j k_j, where stage j of
// the row starts at k + j * kstride; a.n <= NSMAX stages are read. With
// V > 1, z, every stage row of k and out must start at one offset modulo
// 16 bytes (the caller's condition): the row then runs as a scalar head up
// to z's first 16-byte boundary (at most V - 1 elements), an interior of
// 16-byte vectors and a scalar tail (at most V - 1), each element with the
// same arithmetic. In the interior a thread takes U vectors a pass, all
// their loads issued before any arithmetic; this block's share is the
// grid-stride loop over gridDim.x blocks.
template <typename T, int V, int U, int NSMAX>
__device__ __forceinline__ void increment_row(const T* __restrict__ z,
                                              const T* __restrict__ k,
                                              long long kstride, float hv,
                                              T* __restrict__ out,
                                              long long n, const RkRow& a) {
  using P = typename Pack<T, V>::type;
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  long long head = 0;
  if constexpr (V > 1) {
    const long long off =
        (long long)((reinterpret_cast<uintptr_t>(z) / sizeof(T)) % V);
    head = min((V - off) % V, n);
  }
  const long long units = (n - head) / V;
  const long long tail = head + units * V;
  if (g < head) increment_one<T, NSMAX>(z, k, kstride, hv, out, g, a);
  if (g < n - tail)
    increment_one<T, NSMAX>(z, k, kstride, hv, out, tail + g, a);
  const T* __restrict__ zi = z + head;
  const T* __restrict__ ki = k + head;
  T* __restrict__ oi = out + head;
  for (long long u0 = g; u0 < units; u0 += threads * U) {
    P zr[U], kr[NSMAX][U];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const long long off = (u0 + q * threads) * V;
      if (off < units * V) {
        zr[q] = load_pack<T, V>(zi + off);
#pragma unroll
        for (int j = 0; j < NSMAX; ++j)
          if (j < a.n && a.w[j] != 0.0f)
            kr[j][q] = load_pack<T, V>(ki + j * kstride + off);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const long long off = (u0 + q * threads) * V;
      if (off < units * V) {
        float acc[V];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < NSMAX; ++j) {
          if (j < a.n && a.w[j] != 0.0f) {
            float kj[V];
            unpack<T, V>(kr[j][q], kj);
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[i] = __fadd_rn(acc[i], __fmul_rn(a.w[j], kj[i]));
          }
        }
        float zv[V];
        unpack<T, V>(zr[q], zv);
#pragma unroll
        for (int i = 0; i < V; ++i)
          zv[i] = __fadd_rn(zv[i], __fmul_rn(hv, acc[i]));
        store_vec<T, V>(oi + off, zv);
      }
    }
  }
}

// One state row: zn, optional err, and (NORM) this thread's share of the
// sum of squared scaled errors (returned; 0 without NORM).
template <typename T, int V, bool WITH_ERR, bool NORM = true>
__device__ __forceinline__ float combine_err_row(
    const T* __restrict__ z, const T* __restrict__ k, long long kstride,
    float hv, T* __restrict__ zn_out, float* __restrict__ err_out,
    long long n, const RkRow& b, const RkRow& e, float rtol, float atol) {
  const long long units = n / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  float sq = 0.0f;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       u < units; u += stride) {
    const long long off = u * V;
    float acc[V], er[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      acc[i] = 0.0f;
      er[i] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < RK_MAX_STAGES; ++j) {
      const bool use_b = j < b.n && b.w[j] != 0.0f;
      const bool use_e = j < b.n && e.w[j] != 0.0f;
      if (use_b || use_e) {
        float kj[V];
        load_vec<T, V>(k + (long long)j * kstride + off, kj);
        if (use_b) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = __fadd_rn(acc[i], __fmul_rn(b.w[j], kj[i]));
        }
        if (use_e) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            er[i] = __fadd_rn(er[i], __fmul_rn(e.w[j], kj[i]));
        }
      }
    }
    float zv[V], zn[V];
    load_vec<T, V>(z + off, zv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      zn[i] = __fadd_rn(zv[i], __fmul_rn(hv, acc[i]));
      er[i] = __fmul_rn(hv, er[i]);
    }
    store_vec<T, V>(zn_out + off, zn);
    if constexpr (WITH_ERR) store_f32<V>(err_out + off, er);
    if constexpr (NORM) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float scale = __fadd_rn(
            atol, __fmul_rn(rtol, fmaxf(fabsf(zv[i]), fabsf(zn[i]))));
        const float r = __fdiv_rn(er[i], scale);
        sq = __fadd_rn(sq, __fmul_rn(r, r));
      }
    }
  }
  return sq;
}

// Fixed-order block reduction of each thread's sq (warp shuffles, then the
// first warp); thread 0 writes the block's partial to *out.
__device__ __forceinline__ void block_sum_to(float sq, float* __restrict__ out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sq += __shfl_down_sync(0xffffffffu, sq, o);
  __shared__ float warp_sums[RK_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sq;
  __syncthreads();
  if (warp == 0) {
    sq = lane < RK_THREADS / 32 ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq += __shfl_down_sync(0xffffffffu, sq, o);
    if (lane == 0) *out = sq;
  }
}

__device__ __forceinline__ bool stage_used(const RkRow& b, const RkRow& e,
                                           int j) {
  return j < b.n && (b.w[j] != 0.0f || e.w[j] != 0.0f);
}

// z_next and r^2 = (err / scale)^2 of V elements from their raw loads (z,
// and kr[j] for every used stage j), with combine_err_row's arithmetic in
// its order.
template <typename T, int V, int NSMAX>
__device__ __forceinline__ void combine_err_pack(
    const typename Pack<T, V>::type& zr,
    const typename Pack<T, V>::type (&kr)[NSMAX], float hv, const RkRow& b,
    const RkRow& e, float rtol, float atol, float (&zn)[V], float (&sq)[V]) {
  float acc[V], er[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = 0.0f;
    er[i] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NSMAX; ++j) {
    const bool use_b = j < b.n && b.w[j] != 0.0f;
    const bool use_e = j < b.n && e.w[j] != 0.0f;
    if (use_b || use_e) {
      float kj[V];
      unpack<T, V>(kr[j], kj);
      if (use_b) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          acc[i] = __fadd_rn(acc[i], __fmul_rn(b.w[j], kj[i]));
      }
      if (use_e) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          er[i] = __fadd_rn(er[i], __fmul_rn(e.w[j], kj[i]));
      }
    }
  }
  float zv[V];
  unpack<T, V>(zr, zv);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    zn[i] = __fadd_rn(zv[i], __fmul_rn(hv, acc[i]));
    const float scale = __fadd_rn(
        atol, __fmul_rn(rtol, fmaxf(fabsf(zv[i]), fabsf(zn[i]))));
    const float q = __fdiv_rn(__fmul_rn(hv, er[i]), scale);
    sq[i] = __fmul_rn(q, q);
  }
}

// Element i of a K4/K5 row (stage j at k + j * kstride): z_next stored,
// r^2 returned.
template <typename T, int NSMAX>
__device__ __forceinline__ float combine_err_one(
    const T* __restrict__ z, const T* __restrict__ k, long long kstride,
    float hv, T* __restrict__ zn_out, int i, const RkRow& b, const RkRow& e,
    float rtol, float atol) {
  T kr[NSMAX];
#pragma unroll
  for (int j = 0; j < NSMAX; ++j)
    if (stage_used(b, e, j)) kr[j] = k[j * kstride + i];
  float zn[1], sq[1];
  combine_err_pack<T, 1, NSMAX>(z[i], kr, hv, b, e, rtol, atol, zn, sq);
  zn_out[i] = from_f32<T>(zn[0]);
  return sq[0];
}

// A K4/K5 norm partial in its fixed order: the RK_TILE values s[p] added
// pairwise by position, the stride halving from RK_TILE / 2 to 1 (s[p] +
// s[p + w] for p < w), as rk_stage.combine_err_batched_tile_partials adds
// them. Thread i takes strides RK_TILE / 2 to RK_THREADS over positions
// i + RK_THREADS * m in registers, warp 0 strides RK_THREADS / 2 to 32,
// then shuffles 16 to 1. Every thread calls it after s is written and a
// barrier; thread 0 gets the sum.
__device__ __forceinline__ float tile_sum(const float* s) {
  constexpr int M = RK_TILE / RK_THREADS;
  constexpr int W = RK_THREADS / 32;
  __shared__ float c_s[RK_THREADS];
  float v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = s[threadIdx.x + m * RK_THREADS];
#pragma unroll
  for (int w = M / 2; w > 0; w >>= 1)
#pragma unroll
    for (int m = 0; m < w; ++m) v[m] = __fadd_rn(v[m], v[m + w]);
  c_s[threadIdx.x] = v[0];
  __syncthreads();
  float x = 0.0f;
  if (threadIdx.x < 32) {
    float c[W];
#pragma unroll
    for (int m = 0; m < W; ++m) c[m] = c_s[threadIdx.x + 32 * m];
#pragma unroll
    for (int w = W / 2; w > 0; w >>= 1)
#pragma unroll
      for (int m = 0; m < w; ++m) c[m] = __fadd_rn(c[m], c[m + w]);
    x = c[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = __fadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

// K1: out = z + h * sum_j a_j k_j over k of shape (a.n, n).
template <typename T, int V, int NSMAX>
__global__ void __launch_bounds__(RK_THREADS)
    rk_stage_increment_kernel(const T* __restrict__ z,
                              const T* __restrict__ k,
                              const float* __restrict__ h,
                              T* __restrict__ out, long long n, RkRow a) {
  increment_row<T, V, 1, NSMAX>(z, k, n, __ldg(h), out, n, a);
}

// K2: zn, optional err, and one partial norm sum per block.
template <typename T, int V, bool WITH_ERR>
__global__ void __launch_bounds__(RK_THREADS)
    rk_stage_combine_err_kernel(const T* __restrict__ z,
                                const T* __restrict__ k,
                                const float* __restrict__ h,
                                T* __restrict__ zn_out,
                                float* __restrict__ err_out,
                                float* __restrict__ partials, long long n,
                                RkRow b, RkRow e, float rtol, float atol) {
  const float sq = combine_err_row<T, V, WITH_ERR>(
      z, k, n, __ldg(h), zn_out, err_out, n, b, e, rtol, atol);
  block_sum_to(sq, partials + blockIdx.x);
}

// K6: zn and err, no norm.
template <typename T, int V>
__global__ void __launch_bounds__(RK_THREADS)
    rk_stage_combine_kernel(const T* __restrict__ z, const T* __restrict__ k,
                            const float* __restrict__ h,
                            T* __restrict__ zn_out,
                            float* __restrict__ err_out, long long n, RkRow b,
                            RkRow e) {
  combine_err_row<T, V, true, false>(z, k, n, __ldg(h), zn_out, err_out, n,
                                     b, e, 0.0f, 0.0f);
}

// K3: row r = blockIdx.y of z (rows, n) with k (a.n, rows, n), h (rows,);
// U vectors a thread and pass on the vector path, one element on the
// scalar path.
template <typename T, int V, int NSMAX>
__global__ void __launch_bounds__(RK_THREADS)
    rk_stage_increment_batched_kernel(const T* __restrict__ z,
                                      const T* __restrict__ k,
                                      const float* __restrict__ h,
                                      T* __restrict__ out, long long n,
                                      long long rows, RkRow a) {
  const long long r = blockIdx.y;
  increment_row<T, V, V == 1 ? 1 : RK_UNROLL, NSMAX>(
      z + r * n, k + r * n, rows * n, __ldg(h + r), out + r * n, n, a);
}

// K4 (ROWTOL false: rtol, atol by value) and K5 (ROWTOL true: rtol[r],
// atol[r] from device memory): block (t, r) owns tile t of row r, the
// elements [t * RK_TILE, min((t + 1) * RK_TILE, n)), and writes its norm
// partial to partials[r * pstride + t]. With V > 1 (the caller's
// condition as for K3) the tile runs as a scalar head up to its first
// 16-byte boundary, an interior of 16-byte vectors, U a thread and pass
// with every load of the pass issued before its arithmetic, and a scalar
// tail; RK_TILE is a multiple of V, so every tile of a row has the row's
// head. Each r^2 goes to shared memory at its position in the tile
// (shifted by pad < V so that the vectors' stores are 16-byte aligned;
// past the row's end, zeros), and tile_sum adds them in a fixed order.
template <typename T, int V, int U, int NSMAX, bool ROWTOL>
__global__ void __launch_bounds__(RK_THREADS)
    rk_stage_combine_err_batched_kernel(
        const T* __restrict__ z, const T* __restrict__ k,
        const float* __restrict__ h, T* __restrict__ zn_out,
        float* __restrict__ partials, long long pstride, long long n,
        long long rows, RkRow b, RkRow e, float rtol, float atol,
        const float* __restrict__ rtol_row,
        const float* __restrict__ atol_row) {
  using P = typename Pack<T, V>::type;
  __shared__ __align__(16) float sq_s[RK_TILE + 8];
  const long long r = blockIdx.y;
  float rt = rtol, at = atol;
  if constexpr (ROWTOL) {
    rt = __ldg(rtol_row + r);
    at = __ldg(atol_row + r);
  }
  const float hv = __ldg(h + r);
  const long long lo = (long long)blockIdx.x * RK_TILE;
  const int len = (int)min((long long)RK_TILE, n - lo);
  const long long kstride = rows * n;
  const T* __restrict__ zt = z + r * n + lo;
  const T* __restrict__ kt = k + r * n + lo;
  T* __restrict__ ot = zn_out + r * n + lo;
  int head = 0;
  if constexpr (V > 1) {
    const int off = (int)((reinterpret_cast<uintptr_t>(zt) / sizeof(T)) % V);
    head = min((V - off) % V, len);
  }
  const int units = (len - head) / V;
  const int tail = head + units * V;
  float* s = sq_s + (V - head) % V;   // s + head + u * V is 16-byte aligned
  for (int q = len + threadIdx.x; q < RK_TILE; q += RK_THREADS) s[q] = 0.0f;
  const T* __restrict__ zi = zt + head;
  const T* __restrict__ ki = kt + head;
  T* __restrict__ oi = ot + head;
  for (int u0 = threadIdx.x; u0 < units; u0 += RK_THREADS * U) {
    P zr[U], kr[U][NSMAX];
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * RK_THREADS;
      if (u < units) {
        zr[q] = load_pack<T, V>(zi + u * V);
#pragma unroll
        for (int j = 0; j < NSMAX; ++j)
          if (stage_used(b, e, j))
            kr[q][j] = load_pack<T, V>(ki + j * kstride + u * V);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int u = u0 + q * RK_THREADS;
      if (u < units) {
        float zn[V], sq[V];
        combine_err_pack<T, V, NSMAX>(zr[q], kr[q], hv, b, e, rt, at, zn, sq);
        store_vec<T, V>(oi + u * V, zn);
        store_f32<V>(s + head + u * V, sq);
      }
    }
  }
  if ((int)threadIdx.x < head)
    s[threadIdx.x] = combine_err_one<T, NSMAX>(zt, kt, kstride, hv, ot,
                                               threadIdx.x, b, e, rt, at);
  if ((int)threadIdx.x < len - tail)
    s[tail + threadIdx.x] = combine_err_one<T, NSMAX>(
        zt, kt, kstride, hv, ot, tail + threadIdx.x, b, e, rt, at);
  __syncthreads();
  const float sum = tile_sum(s);
  if (threadIdx.x == 0) partials[r * pstride + blockIdx.x] = sum;
}

template <typename T, int V>
static void launch_increment(const void* z, const void* k, const void* h,
                             void* out, long long n, const RkRow& a,
                             int n_blocks, cudaStream_t st) {
  const T* zt = static_cast<const T*>(z);
  const T* kt = static_cast<const T*>(k);
  const float* hf = static_cast<const float*>(h);
  T* ot = static_cast<T*>(out);
  if (a.n <= RK_FEW_STAGES)
    rk_stage_increment_kernel<T, V, RK_FEW_STAGES>
        <<<n_blocks, RK_THREADS, 0, st>>>(zt, kt, hf, ot, n, a);
  else
    rk_stage_increment_kernel<T, V, RK_MAX_STAGES>
        <<<n_blocks, RK_THREADS, 0, st>>>(zt, kt, hf, ot, n, a);
}

template <typename T, int V>
static void launch_combine_err(const void* z, const void* k, const void* h,
                               void* zn, float* err, float* partials,
                               long long n, const RkRow& b, const RkRow& e,
                               float rtol, float atol, int n_blocks,
                               cudaStream_t st) {
  if (err != nullptr) {
    rk_stage_combine_err_kernel<T, V, true><<<n_blocks, RK_THREADS, 0, st>>>(
        static_cast<const T*>(z), static_cast<const T*>(k),
        static_cast<const float*>(h), static_cast<T*>(zn), err, partials, n,
        b, e, rtol, atol);
  } else {
    rk_stage_combine_err_kernel<T, V, false><<<n_blocks, RK_THREADS, 0, st>>>(
        static_cast<const T*>(z), static_cast<const T*>(k),
        static_cast<const float*>(h), static_cast<T*>(zn), nullptr, partials,
        n, b, e, rtol, atol);
  }
}

template <typename T, int V>
static void launch_combine(const void* z, const void* k, const void* h,
                           void* zn, float* err, long long n, const RkRow& b,
                           const RkRow& e, int n_blocks, cudaStream_t st) {
  rk_stage_combine_kernel<T, V><<<n_blocks, RK_THREADS, 0, st>>>(
      static_cast<const T*>(z), static_cast<const T*>(k),
      static_cast<const float*>(h), static_cast<T*>(zn), err, n, b, e);
}

template <typename T, int V>
static void launch_increment_batched(const void* z, const void* k,
                                     const void* h, void* out, long long n,
                                     long long rows, const RkRow& a,
                                     int n_blocks, cudaStream_t st) {
  const dim3 grid(n_blocks, static_cast<unsigned>(rows));
  const T* zt = static_cast<const T*>(z);
  const T* kt = static_cast<const T*>(k);
  const float* hf = static_cast<const float*>(h);
  T* ot = static_cast<T*>(out);
  if (a.n <= RK_FEW_STAGES)
    rk_stage_increment_batched_kernel<T, V, RK_FEW_STAGES>
        <<<grid, RK_THREADS, 0, st>>>(zt, kt, hf, ot, n, rows, a);
  else
    rk_stage_increment_batched_kernel<T, V, RK_MAX_STAGES>
        <<<grid, RK_THREADS, 0, st>>>(zt, kt, hf, ot, n, rows, a);
}

// K4/K5's vectors a thread and pass: RK_TILE_UNROLL, at most the tile's
// share; the scalar path covers a tile in one pass
constexpr int tile_unroll(int v) {
  return v == 1 ? RK_TILE / RK_THREADS
         : RK_TILE / (RK_THREADS * v) < 1 ? 1
         : RK_TILE / (RK_THREADS * v) < RK_TILE_UNROLL
             ? RK_TILE / (RK_THREADS * v)
             : RK_TILE_UNROLL;
}

template <typename T, int V, bool ROWTOL>
static void launch_combine_err_batched(
    const void* z, const void* k, const void* h, void* zn, float* partials,
    long long n, long long rows, const RkRow& b, const RkRow& e, float rtol,
    float atol, const float* rtol_row, const float* atol_row,
    long long n_tiles, long long pstride, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(rows));
  const T* zt = static_cast<const T*>(z);
  const T* kt = static_cast<const T*>(k);
  const float* hf = static_cast<const float*>(h);
  T* ot = static_cast<T*>(zn);
  if (b.n <= RK_FEW_STAGES)
    rk_stage_combine_err_batched_kernel<T, V, tile_unroll(V), RK_FEW_STAGES,
                                        ROWTOL><<<grid, RK_THREADS, 0, st>>>(
        zt, kt, hf, ot, partials, pstride, n, rows, b, e, rtol, atol,
        rtol_row, atol_row);
  else
    rk_stage_combine_err_batched_kernel<T, V, tile_unroll(V), RK_MAX_STAGES,
                                        ROWTOL><<<grid, RK_THREADS, 0, st>>>(
        zt, kt, hf, ot, partials, pstride, n, rows, b, e, rtol, atol,
        rtol_row, atol_row);
}

template <bool ROWTOL>
static int combine_err_batched(const void* z, const void* k, const void* h,
                               void* zn, void* partials, long long n,
                               long long rows, const RkRow* b,
                               const RkRow* e, float rtol, float atol,
                               const void* rtol_row, const void* atol_row,
                               int dtype, int vec, long long n_tiles,
                               long long pstride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // one partial per tile of RK_TILE elements of a row (one for n = 0)
  const long long tiles = n > RK_TILE ? (n + RK_TILE - 1) / RK_TILE : 1;
  if (b->n < 0 || b->n > RK_MAX_STAGES || e->n != b->n || n < 0 ||
      n_tiles != tiles || pstride < n_tiles || rows < 1 ||
      rows > RK_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partials);
  const float* rr = static_cast<const float*>(rtol_row);
  const float* ar = static_cast<const float*>(atol_row);
  if (dtype == 0) {
    if (vec)
      launch_combine_err_batched<float, 4, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_tiles,
          pstride, st);
    else
      launch_combine_err_batched<float, 1, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_tiles,
          pstride, st);
  } else if (dtype == 1) {
    if (vec)
      launch_combine_err_batched<__nv_bfloat16, 8, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_tiles,
          pstride, st);
    else
      launch_combine_err_batched<__nv_bfloat16, 1, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_tiles,
          pstride, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- C ABI
// dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16-byte vectors (the caller
// has checked N % width == 0 and 16-byte alignment; for K3, K4 and K5,
// that rows * N % width == 0 and the pointers share one offset modulo 16
// bytes), 0 = one element per load. n_blocks: the grid of K1/K2/K6
// (blocks per row for K3), chosen by the caller (it sizes K2's
// `partials`). n_tiles: K4/K5's partials per row, ceil(N / RK_TILE) (1
// for N = 0), checked here; pstride: the floats between two rows of them
// (>= n_tiles). rows: B of a batched (B, N) state. Each returns
// cudaGetLastError() after the launch.

extern "C" int rk_threads_per_block(void) { return RK_THREADS; }

extern "C" int rk_max_stages(void) { return RK_MAX_STAGES; }

extern "C" int rk_max_rows(void) { return RK_MAX_ROWS; }

extern "C" int rk_unroll(void) { return RK_UNROLL; }

extern "C" int rk_norm_tile(void) { return RK_TILE; }

extern "C" const char* rk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int rk_stage_increment(const void* z, const void* k,
                                  const void* h, void* out, long long n,
                                  const RkRow* a, int dtype, int vec,
                                  int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->n < 0 || a->n > RK_MAX_STAGES || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (vec) launch_increment<float, 4>(z, k, h, out, n, *a, n_blocks, st);
    else launch_increment<float, 1>(z, k, h, out, n, *a, n_blocks, st);
  } else if (dtype == 1) {
    if (vec)
      launch_increment<__nv_bfloat16, 8>(z, k, h, out, n, *a, n_blocks, st);
    else
      launch_increment<__nv_bfloat16, 1>(z, k, h, out, n, *a, n_blocks, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rk_stage_combine_err(const void* z, const void* k,
                                    const void* h, void* zn, void* err,
                                    void* partials, long long n,
                                    const RkRow* b, const RkRow* e,
                                    float rtol, float atol, int dtype,
                                    int vec, int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b->n < 0 || b->n > RK_MAX_STAGES || e->n != b->n || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* errp = static_cast<float*>(err);
  float* part = static_cast<float*>(partials);
  if (dtype == 0) {
    if (vec)
      launch_combine_err<float, 4>(z, k, h, zn, errp, part, n, *b, *e, rtol,
                                   atol, n_blocks, st);
    else
      launch_combine_err<float, 1>(z, k, h, zn, errp, part, n, *b, *e, rtol,
                                   atol, n_blocks, st);
  } else if (dtype == 1) {
    if (vec)
      launch_combine_err<__nv_bfloat16, 8>(z, k, h, zn, errp, part, n, *b,
                                           *e, rtol, atol, n_blocks, st);
    else
      launch_combine_err<__nv_bfloat16, 1>(z, k, h, zn, errp, part, n, *b,
                                           *e, rtol, atol, n_blocks, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rk_stage_combine(const void* z, const void* k, const void* h,
                                void* zn, void* err, long long n,
                                const RkRow* b, const RkRow* e, int dtype,
                                int vec, int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b->n < 0 || b->n > RK_MAX_STAGES || e->n != b->n || n_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  float* errp = static_cast<float*>(err);
  if (dtype == 0) {
    if (vec)
      launch_combine<float, 4>(z, k, h, zn, errp, n, *b, *e, n_blocks, st);
    else
      launch_combine<float, 1>(z, k, h, zn, errp, n, *b, *e, n_blocks, st);
  } else if (dtype == 1) {
    if (vec)
      launch_combine<__nv_bfloat16, 8>(z, k, h, zn, errp, n, *b, *e,
                                       n_blocks, st);
    else
      launch_combine<__nv_bfloat16, 1>(z, k, h, zn, errp, n, *b, *e,
                                       n_blocks, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rk_stage_increment_batched(const void* z, const void* k,
                                          const void* h, void* out,
                                          long long n, long long rows,
                                          const RkRow* a, int dtype, int vec,
                                          int n_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->n < 0 || a->n > RK_MAX_STAGES || n_blocks < 1 || rows < 1 ||
      rows > RK_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (vec)
      launch_increment_batched<float, 4>(z, k, h, out, n, rows, *a,
                                         n_blocks, st);
    else
      launch_increment_batched<float, 1>(z, k, h, out, n, rows, *a,
                                         n_blocks, st);
  } else if (dtype == 1) {
    if (vec)
      launch_increment_batched<__nv_bfloat16, 8>(z, k, h, out, n, rows, *a,
                                                 n_blocks, st);
    else
      launch_increment_batched<__nv_bfloat16, 1>(z, k, h, out, n, rows, *a,
                                                 n_blocks, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rk_stage_combine_err_batched(
    const void* z, const void* k, const void* h, void* zn, void* partials,
    long long n, long long rows, const RkRow* b, const RkRow* e, float rtol,
    float atol, int dtype, int vec, long long n_tiles, long long pstride,
    void* stream) {
  return combine_err_batched<false>(z, k, h, zn, partials, n, rows, b, e,
                                    rtol, atol, nullptr, nullptr, dtype, vec,
                                    n_tiles, pstride, stream);
}

extern "C" int rk_stage_combine_err_batched_rowtol(
    const void* z, const void* k, const void* h, void* zn, void* partials,
    long long n, long long rows, const RkRow* b, const RkRow* e,
    const void* rtol, const void* atol, int dtype, int vec,
    long long n_tiles, long long pstride, void* stream) {
  return combine_err_batched<true>(z, k, h, zn, partials, n, rows, b, e,
                                   0.0f, 0.0f, rtol, atol, dtype, vec,
                                   n_tiles, pstride, stream);
}
