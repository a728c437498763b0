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
//   K2 per row without the err store; norm partials (B, P), scalar
//   rtol/atol passed by value.
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
// The design therefore only has to stream: a grid-stride loop over
// 16-byte vectors (4 f32 or 8 bf16 per thread per load) when N is a
// multiple of the vector width and every base pointer is 16-byte aligned
// (then every row of a batched state starts aligned too), else one element
// per thread per load. The ragged tail is masked by the loop bound; nothing
// is padded or copied. The batched kernels use a 2-D grid: blockIdx.y is
// the row, and the same number of blocks per row as K1/K2 use for one
// state of N values covers the row with a grid-stride loop.
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
// blocks an SM was slower for both); K2, K4, K5 and K6 keep the rule and
// grid of the first paragraph.
// K1 and K3 read at most RK_FEW_STAGES stages through kernels that hold
// only that many stages' loads in registers.
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
// skipped by a branch that is uniform across the grid. The norm is reduced
// per block into partials[row * P + blockIdx.x] in a fixed order, without
// atomics: P depends on N alone, so a row's partials depend neither on B
// nor on the other rows, and the accept decision is the same run to run;
// the caller sums the partials of each row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RK_MAX_STAGES 7
#define RK_THREADS 256
#define RK_MAX_ROWS 65535   // gridDim.y
// K1/K3 with at most this many stages (HeunEuler's, Bogacki-Shampine's
// first rows) hold fewer loads in registers than with RK_MAX_STAGES
#define RK_FEW_STAGES 2
// K3's 16-byte vectors a thread and pass (2 and 4 were slower:
// tests/torch_k3_k10_ablations.py)
#define RK_UNROLL 1

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
// atol[r] from device memory): row r = blockIdx.y; partials (rows, P).
template <typename T, int V, bool ROWTOL>
__global__ void __launch_bounds__(RK_THREADS)
    rk_stage_combine_err_batched_kernel(
        const T* __restrict__ z, const T* __restrict__ k,
        const float* __restrict__ h, T* __restrict__ zn_out,
        float* __restrict__ partials, long long n, long long rows, RkRow b,
        RkRow e, float rtol, float atol, const float* __restrict__ rtol_row,
        const float* __restrict__ atol_row) {
  const long long r = blockIdx.y;
  float rt = rtol, at = atol;
  if constexpr (ROWTOL) {
    rt = __ldg(rtol_row + r);
    at = __ldg(atol_row + r);
  }
  const float sq = combine_err_row<T, V, false>(
      z + r * n, k + r * n, rows * n, __ldg(h + r), zn_out + r * n, nullptr,
      n, b, e, rt, at);
  block_sum_to(sq, partials + r * gridDim.x + blockIdx.x);
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

template <typename T, int V, bool ROWTOL>
static void launch_combine_err_batched(
    const void* z, const void* k, const void* h, void* zn, float* partials,
    long long n, long long rows, const RkRow& b, const RkRow& e, float rtol,
    float atol, const float* rtol_row, const float* atol_row, int n_blocks,
    cudaStream_t st) {
  const dim3 grid(n_blocks, static_cast<unsigned>(rows));
  rk_stage_combine_err_batched_kernel<T, V, ROWTOL>
      <<<grid, RK_THREADS, 0, st>>>(
          static_cast<const T*>(z), static_cast<const T*>(k),
          static_cast<const float*>(h), static_cast<T*>(zn), partials, n,
          rows, b, e, rtol, atol, rtol_row, atol_row);
}

template <bool ROWTOL>
static int combine_err_batched(const void* z, const void* k, const void* h,
                               void* zn, void* partials, long long n,
                               long long rows, const RkRow* b,
                               const RkRow* e, float rtol, float atol,
                               const void* rtol_row, const void* atol_row,
                               int dtype, int vec, int n_blocks,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b->n < 0 || b->n > RK_MAX_STAGES || e->n != b->n || n_blocks < 1 ||
      rows < 1 || rows > RK_MAX_ROWS)
    return static_cast<int>(cudaErrorInvalidValue);
  float* part = static_cast<float*>(partials);
  const float* rr = static_cast<const float*>(rtol_row);
  const float* ar = static_cast<const float*>(atol_row);
  if (dtype == 0) {
    if (vec)
      launch_combine_err_batched<float, 4, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_blocks,
          st);
    else
      launch_combine_err_batched<float, 1, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_blocks,
          st);
  } else if (dtype == 1) {
    if (vec)
      launch_combine_err_batched<__nv_bfloat16, 8, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_blocks,
          st);
    else
      launch_combine_err_batched<__nv_bfloat16, 1, ROWTOL>(
          z, k, h, zn, part, n, rows, *b, *e, rtol, atol, rr, ar, n_blocks,
          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- C ABI
// dtype: 0 = float32, 1 = bfloat16. vec: 1 = 16-byte vectors (the caller
// has checked N % width == 0 and 16-byte alignment; for K3, that rows * N
// % width == 0 and the pointers share one offset modulo 16 bytes), 0 = one
// element per load. n_blocks: the grid (per row for the batched kernels),
// chosen by the caller (it sizes `partials`). rows: B of a batched (B, N)
// state. Each returns cudaGetLastError() after the launch.

extern "C" int rk_threads_per_block(void) { return RK_THREADS; }

extern "C" int rk_max_stages(void) { return RK_MAX_STAGES; }

extern "C" int rk_max_rows(void) { return RK_MAX_ROWS; }

extern "C" int rk_unroll(void) { return RK_UNROLL; }

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
    float atol, int dtype, int vec, int n_blocks, void* stream) {
  return combine_err_batched<false>(z, k, h, zn, partials, n, rows, b, e,
                                    rtol, atol, nullptr, nullptr, dtype, vec,
                                    n_blocks, stream);
}

extern "C" int rk_stage_combine_err_batched_rowtol(
    const void* z, const void* k, const void* h, void* zn, void* partials,
    long long n, long long rows, const RkRow* b, const RkRow* e,
    const void* rtol, const void* atol, int dtype, int vec, int n_blocks,
    void* stream) {
  return combine_err_batched<true>(z, k, h, zn, partials, n, rows, b, e,
                                   0.0f, 0.0f, rtol, atol, dtype, vec,
                                   n_blocks, stream);
}
