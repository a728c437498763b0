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
// (16384, 4096) bf16; the (D,) weight is read once per row but stays in
// L1/L2.
//
// Design: one block of 256 threads per row (a grid-stride loop over rows
// covers more rows than blocks). A D = 4096 bf16 row is 8 KB: 512 16-byte
// vectors, two per thread. The first pass reads the row with 16-byte loads
// when D is a multiple of the vector width and x, y are 16-byte aligned
// (else one element per load), sums x^2 in f32 per thread, then across the
// warp by shuffles and across the 8 warps through shared memory in a fixed
// order (deterministic run to run). The second pass reads the row again
// (an 8 KB row is still in L1), scales and writes. The decode shape (4
// rows) launches 4 blocks; a ragged row count needs no padding. The
// products are (x * r) * w as in the plain version; only the order of the
// sum of squares differs from torch.mean's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RMS_THREADS 256
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

// Sum of one value per thread over the block, in a fixed order.
__device__ __forceinline__ float rms_block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < RMS_THREADS / 32; ++i) s += red[i];
  return s;
}

template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(RMS_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
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
    const float tot = rms_block_sum(ss, red);
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

template <typename T, typename W>
static cudaError_t rms_launch(const void* x, const void* w, void* y,
                              long long rows, int d, float eps, int vec,
                              int blocks, cudaStream_t stream) {
  if (vec)
    rmsnorm_kernel<T, W, true><<<blocks, RMS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), rows, d, eps);
  else
    rmsnorm_kernel<T, W, false><<<blocks, RMS_THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const W*>(w),
        static_cast<T*>(y), rows, d, eps);
  return cudaGetLastError();
}

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16
int rmsnorm_forward(const void* x, const void* w, void* y, long long rows,
                    int d, float eps, int x_dtype, int w_dtype, int vec,
                    void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const int blocks =
      rows < RMS_MAX_BLOCKS ? (int)rows : RMS_MAX_BLOCKS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && w_dtype == 0)
    return (int)rms_launch<float, float>(x, w, y, rows, d, eps, vec, blocks,
                                         s);
  if (x_dtype == 0 && w_dtype == 1)
    return (int)rms_launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, vec,
                                                 blocks, s);
  if (x_dtype == 1 && w_dtype == 0)
    return (int)rms_launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, vec,
                                                 blocks, s);
  if (x_dtype == 1 && w_dtype == 1)
    return (int)rms_launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d,
                                                         eps, vec, blocks, s);
  return (int)cudaErrorInvalidValue;
}

const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rmsnorm_threads_per_block(void) { return RMS_THREADS; }

}  // extern "C"
