// RMSNorm for Hopper (sm_90a): K7 of the port.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (_kernel): y = x * rsqrt(mean(x^2) + eps) * w over the last axis, with
// the statistic in f32 and the output in x's dtype. x is (rows, D) f32 or
// bf16; w is (D,) in its own dtype (f32 or bf16: the model keeps f32
// params in tests and bf16 at full width).
//
// What bounds it: bytes. Each element costs ~4 flops against 2 (bf16) or
// 4 (f32) bytes read and as many written, so the least time is
// 2 * rows * D * sizeof(x) over 3.35 TB/s: 80 us for the prefill shape
// (16384, 4096) bf16. At the decode rows (4, D) the bytes take 0.02 us and
// a launch alone takes longer: there the kernel is bound by its launch
// and by the latency of one round trip to device memory.
//
// Two kernels, one block per row (a grid-stride loop over rows covers more
// rows than blocks), chosen by kernels/rmsnorm.py::kernel_for:
//  * rmsnorm_one_pass, for rows that fit in registers: D a multiple of the
//    16-byte vector and x, w, y 16-byte aligned, with at most
//    RMS_MAX_THREADS x RMS_VPT vectors (D <= 16384 bf16, 8192 f32). The
//    block has ceil(vectors / RMS_VPT) threads rounded up to a warp
//    (2560, 4096 and 5120 bf16: 160, 256 and 320 threads, none idle).
//    Each thread loads its RMS_VPT vectors of w and of x together, before
//    the reduction (w with 16-byte loads), keeps x in registers, reduces
//    once, then scales and stores: one round trip to device memory and no
//    second read of x.
//  * rmsnorm_two_pass, the general path (D beyond the register budget, or
//    x, w or y unaligned): 256 threads; the first pass reads the row
//    (16-byte loads when D and x, y allow, else one element per load),
//    the second reads it again (it is still in L1), reads w, scales and
//    writes.
// Rule: the one-pass kernel wherever it applies, the prefill rows
// included. Times on an NVIDIA H100 80GB HBM3 at 700 W, cold L2
// (tests/torch_k9_times.py --kernel k7, PERF.md section 6): at (4, 4096)
// bf16 one-pass 6.1 us, two-pass 7.2 us, against a launch floor (an empty
// kernel, rmsnorm_noop) of 4.7 us; (4, 2560) 6.1 against 7.0; (4, 5120)
// 6.2 against 7.6; at (16384, 4096) one-pass 94 us, two-pass 99 us (bytes
// bound 80 us). 1, 4 or 8 vectors a thread instead of 2
// (tests/torch_k7_k8_ablations.py --kernel k7) were no faster at the
// decode rows and slower at the prefill rows.
//
// Arithmetic, the same in both: the sum of squares in f32, per thread
// over its elements in order, across the warp by shuffles and across the
// warps through shared memory in warp order (deterministic run to run),
// then (x * r) * w rounded once to x's dtype, as the plain version
// computes it; only the order of the sum differs from torch.mean's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RMS_THREADS 256      // two-pass kernel
#define RMS_VPT 2            // 16-byte vectors per thread, one-pass kernel
#define RMS_MAX_THREADS 1024
#define RMS_MAX_BLOCKS 65535

__device__ __forceinline__ float rms_to_f32(float x) { return x; }
__device__ __forceinline__ float rms_to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T rms_from_f32(float x);
template <>
__device__ __forceinline__ float rms_from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 rms_from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Sum of one value per thread over the block's `warps` warps, in a fixed
// order; the caller syncs before `red` is written again.
__device__ __forceinline__ float rms_block_sum(float v, float* red,
                                              int warps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < warps; ++i) s += red[i];
  return s;
}

// The V = 16 / sizeof(T) weights of x's vector i as f32, by 16-byte loads
// (8 bytes for f32 x with bf16 w); w is 16-byte aligned.
template <typename T, typename W>
__device__ __forceinline__ void rms_load_w(const W* __restrict__ w, int i,
                                           float (&f)[16 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  const W* p = w + (long long)i * V;
  if constexpr (V * sizeof(W) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = rms_to_f32(e[j]);
  } else {
#pragma unroll
    for (int c = 0; c < (int)(V * sizeof(W) / 16); ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const W* e = reinterpret_cast<const W*>(&raw);
#pragma unroll
      for (int j = 0; j < (int)(16 / sizeof(W)); ++j)
        f[c * (16 / sizeof(W)) + j] = rms_to_f32(e[j]);
    }
  }
}

template <typename T, typename W>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
    rmsnorm_one_pass(const T* __restrict__ x, const W* __restrict__ w,
                     T* __restrict__ y, long long rows, int d, float eps) {
  __shared__ float red[RMS_MAX_THREADS / 32];
  constexpr int V = 16 / sizeof(T);
  const int nvec = d / V, warps = blockDim.x >> 5;
  float wf[RMS_VPT][V];
  uint4 xr[RMS_VPT];
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * (long long)d);
    // x's and w's vectors together, before the reduction (w again for a
    // later row of the grid-stride loop: it stays in L1)
#pragma unroll
    for (int k = 0; k < RMS_VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nvec) {
        xr[k] = xv[i];
        rms_load_w<T, W>(w, i, wf[k]);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < RMS_VPT; ++k) {
      if (threadIdx.x + k * blockDim.x < nvec) {
        const T* e = reinterpret_cast<const T*>(&xr[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = rms_to_f32(e[j]);
          ss += f * f;
        }
      }
    }
    const float r = rsqrtf(rms_block_sum(ss, red, warps) / (float)d + eps);
    uint4* yv = reinterpret_cast<uint4*>(y + row * (long long)d);
#pragma unroll
    for (int k = 0; k < RMS_VPT; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i < nvec) {
        const T* e = reinterpret_cast<const T*>(&xr[k]);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j)
          o[j] = rms_from_f32<T>((rms_to_f32(e[j]) * r) * wf[k][j]);
        yv[i] = out;
      }
    }
    __syncthreads();  // red[] is rewritten by the next row
  }
}

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(RMS_THREADS)
    rmsnorm_two_pass(const T* __restrict__ x, const W* __restrict__ w,
                     T* __restrict__ y, long long rows, int d, float eps) {
  __shared__ float red[RMS_THREADS / 32];
  constexpr int V = 16 / sizeof(T);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * (long long)d;
    T* yr = y + row * (long long)d;
    float ss = 0.f;
    if (VEC) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      for (int i = threadIdx.x; i < d / V; i += RMS_THREADS) {
        uint4 raw = xv[i];
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = rms_to_f32(e[j]);
          ss += f * f;
        }
      }
    } else {
      for (int i = threadIdx.x; i < d; i += RMS_THREADS) {
        const float f = rms_to_f32(xr[i]);
        ss += f * f;
      }
    }
    const float tot = rms_block_sum(ss, red, RMS_THREADS / 32);
    const float r = rsqrtf(tot / (float)d + eps);
    if (VEC) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      uint4* yv = reinterpret_cast<uint4*>(yr);
      for (int i = threadIdx.x; i < d / V; i += RMS_THREADS) {
        uint4 raw = xv[i];
        const T* e = reinterpret_cast<const T*>(&raw);
        uint4 out;
        T* o = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = rms_to_f32(e[j]);
          o[j] = rms_from_f32<T>((f * r) * rms_to_f32(w[i * V + j]));
        }
        yv[i] = out;
      }
    } else {
      for (int i = threadIdx.x; i < d; i += RMS_THREADS) {
        const float f = rms_to_f32(xr[i]);
        yr[i] = rms_from_f32<T>((f * r) * rms_to_f32(w[i]));
      }
    }
    __syncthreads();  // red[] is rewritten by the next row
  }
}

// kernel codes: 0 = two-pass with one element per load, 1 = two-pass with
// 16-byte loads of x and y, 2 = one-pass
template <typename T, typename W>
static cudaError_t rms_launch(const void* x, const void* w, void* y,
                              long long rows, int d, float eps, int kernel,
                              int blocks, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const W* wp = static_cast<const W*>(w);
  T* yp = static_cast<T*>(y);
  if (kernel == 2) {
    constexpr int V = 16 / sizeof(T);
    if (d % V != 0) return cudaErrorInvalidValue;
    const int per = (d / V + RMS_VPT - 1) / RMS_VPT;
    const int threads = (per + 31) / 32 * 32;
    if (threads > RMS_MAX_THREADS) return cudaErrorInvalidValue;
    rmsnorm_one_pass<T, W><<<blocks, threads, 0, stream>>>(xp, wp, yp, rows,
                                                           d, eps);
  } else if (kernel == 1) {
    rmsnorm_two_pass<T, W, true><<<blocks, RMS_THREADS, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  } else if (kernel == 0) {
    rmsnorm_two_pass<T, W, false><<<blocks, RMS_THREADS, 0, stream>>>(
        xp, wp, yp, rows, d, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

__global__ void rms_noop_kernel() {}

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16
int rmsnorm_forward(const void* x, const void* w, void* y, long long rows,
                    int d, float eps, int x_dtype, int w_dtype, int kernel,
                    void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int blocks =
      rows < RMS_MAX_BLOCKS ? (int)rows : RMS_MAX_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)rms_launch<float, float>(x, w, y, rows, d, eps, kernel,
                                         blocks, s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)rms_launch<float, __nv_bfloat16>(x, w, y, rows, d, eps,
                                                 kernel, blocks, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)rms_launch<__nv_bfloat16, float>(x, w, y, rows, d, eps,
                                                 kernel, blocks, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)rms_launch<__nv_bfloat16, __nv_bfloat16>(
        x, w, y, rows, d, eps, kernel, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// An empty kernel of one warp on the same ctypes route: its time is the
// least any launch takes (the launch floor of chip_smoke's bounds).
int rmsnorm_noop(void* stream) {
  rms_noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rmsnorm_threads_per_block(void) { return RMS_THREADS; }

int rmsnorm_vectors_per_thread(void) { return RMS_VPT; }

int rmsnorm_max_threads(void) { return RMS_MAX_THREADS; }

}  // extern "C"
