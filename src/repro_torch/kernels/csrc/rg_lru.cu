// RG-LRU linear recurrence for Hopper (sm_90a): K10 of the port.
//
// Replaces the TPU kernel src/repro/kernels/rg_lru.py::rg_lru_pallas
// (_kernel): h_t = exp(log_a_t) * h_{t-1} + b_t over (B, S, C) in f32,
// h_{-1} = 0, log_a <= 0.
//
// What bounds it: bytes. The recurrence is one multiply-add and one exp
// per element against 12 bytes (log_a and b read, h written), so the least
// time is 3 * B * S * C * 4 bytes over 3.35 TB/s: 805 MB and 0.24 ms at
// the prefill shape (4, 4096, 4096).
//
// Stability: the TPU kernel walks each chunk sequentially because closed
// forms through cumprod(a) lose recent contributions once the decay
// underflows. This kernel walks sequentially too, and composes whole
// chunks only as (A, h) pairs: A = prod a over the chunk (an underflow to
// 0 is the right limit), h = the chunk's scan from 0. Nothing divides.
//
// Design: one thread per (b, c) channel walking all S steps would give
// only B * C = 16,384 threads, far too few loads in flight to stream at
// the memory rate. So the scan is chunked along S in three passes, each
// with consecutive threads on consecutive channels (coalesced 128-byte
// rows per warp):
//   1. chunk_ends: one thread per (b, chunk, c) scans its L steps from 0
//      and stores the chunk's (A, h_end) into (B, n_chunks, C) scratch;
//   2. carry: one thread per (b, c) walks the n_chunks chunk ends and
//      stores the state entering each chunk;
//   3. apply: one thread per (b, chunk, c) scans its L steps again from
//      the carried state and writes h.
// At L = 64 and (4, 4096, 4096) passes 1 and 3 run 1M threads each. The
// price is a second read of log_a and b (5 streams instead of 3); a
// single-pass scan with look-back across chunks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define LRU_THREADS 256

__global__ void __launch_bounds__(LRU_THREADS)
    rg_lru_chunk_ends(const float* __restrict__ log_a,
                      const float* __restrict__ b, float* __restrict__ a_end,
                      float* __restrict__ h_end, int S, int C, int L,
                      int n_chunks, long long total) {
  const long long idx = blockIdx.x * (long long)LRU_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long rest = idx / C;
  const int k = (int)(rest % n_chunks);
  const long long bb = rest / n_chunks;
  const int t0 = k * L;
  const int len = min(L, S - t0);
  const long long base = (bb * S + t0) * (long long)C + c;
  float A = 1.f, h = 0.f;
#pragma unroll 8
  for (int t = 0; t < len; ++t) {
    const float a = expf(log_a[base + (long long)t * C]);
    h = a * h + b[base + (long long)t * C];
    A = A * a;
  }
  a_end[idx] = A;
  h_end[idx] = h;
}

__global__ void __launch_bounds__(LRU_THREADS)
    rg_lru_carry(const float* __restrict__ a_end,
                 const float* __restrict__ h_end, float* __restrict__ carry,
                 int C, int n_chunks, long long total) {
  const long long idx = blockIdx.x * (long long)LRU_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long bb = idx / C;
  float h = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const long long at = (bb * n_chunks + k) * (long long)C + c;
    carry[at] = h;
    h = a_end[at] * h + h_end[at];
  }
}

__global__ void __launch_bounds__(LRU_THREADS)
    rg_lru_apply(const float* __restrict__ log_a, const float* __restrict__ b,
                 const float* __restrict__ carry, float* __restrict__ y,
                 int S, int C, int L, int n_chunks, long long total) {
  const long long idx = blockIdx.x * (long long)LRU_THREADS + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % C);
  const long long rest = idx / C;
  const int k = (int)(rest % n_chunks);
  const long long bb = rest / n_chunks;
  const int t0 = k * L;
  const int len = min(L, S - t0);
  const long long base = (bb * S + t0) * (long long)C + c;
  float h = carry[idx];
#pragma unroll 8
  for (int t = 0; t < len; ++t) {
    const long long at = base + (long long)t * C;
    h = expf(log_a[at]) * h + b[at];
    y[at] = h;
  }
}

extern "C" {

// log_a, b, y: (B, S, C) f32; a_end, h_end, carry: (B, n_chunks, C) f32
// scratch with n_chunks = ceil(S / L). Three launches on one stream.
int rg_lru_forward(const float* log_a, const float* b, float* y,
                   float* a_end, float* h_end, float* carry, int B, int S,
                   int C, int L, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = (S + L - 1) / L;
  const long long per_chunk = (long long)B * n_chunks * C;
  const long long per_chan = (long long)B * C;
  const long long g1 = (per_chunk + LRU_THREADS - 1) / LRU_THREADS;
  const long long g2 = (per_chan + LRU_THREADS - 1) / LRU_THREADS;
  if (g1 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rg_lru_chunk_ends<<<(unsigned)g1, LRU_THREADS, 0, s>>>(
      log_a, b, a_end, h_end, S, C, L, n_chunks, per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rg_lru_carry<<<(unsigned)g2, LRU_THREADS, 0, s>>>(a_end, h_end, carry, C,
                                                    n_chunks, per_chan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rg_lru_apply<<<(unsigned)g1, LRU_THREADS, 0, s>>>(log_a, b, carry, y, S, C,
                                                    L, n_chunks, per_chunk);
  return (int)cudaGetLastError();
}

const char* rg_lru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
