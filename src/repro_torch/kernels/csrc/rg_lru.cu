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
// underflows. This kernel walks sequentially too, and composes segments
// only as (A, h) pairs: A = prod a over the segment (an underflow to 0 is
// the right limit), h = the segment's scan from 0. Nothing divides.
//
// Design: one pass that reads log_a and b once and writes h once, with no
// scratch in device memory and no block waiting on another. One block of
// LRU_CT * LRU_NS threads owns one batch row b and LRU_CT consecutive
// channels, and walks all of S itself, in tiles of T = LRU_NS * LRU_L
// steps, so the state never crosses a block. In a tile, thread (seg, c)
// holds steps [seg * L, (seg + 1) * L) of channel c in registers (lanes on
// consecutive channels: 128-byte rows, coalesced):
//   1. segment scan: from 0 over its L steps, giving (A, h_end), which go
//      to shared memory;
//   2. compose (after one __syncthreads): the tile's carry-in pushed
//      through the (A, h_end) pairs of the segments before the thread's
//      own, in ascending order, is the state entering its segment; pushed
//      through all LRU_NS pairs it is the next tile's carry-in (every
//      thread of the channel computes it alike, in registers);
//   3. apply: the thread scans its L steps again from that state, out of
//      registers, and stores h.
// The pairs are double-buffered by tile parity, so one barrier a tile
// suffices: a thread writes buffer p of tile k + 2 only after the barrier
// of tile k + 1, which no thread passes before it has read tile k's.
// The next tile's log_a and b are loaded into registers right after this
// tile's values are taken (before the segment scan, the barrier and the
// compose), so each thread keeps 2 * L loads in flight while it computes.
// Steps past S read as (log_a, b) = (0, 0): the identity step.
//
// Bytes in flight (Little's law): the card needs about 3.35 TB/s x ~1.5 us
// / 132 SMs = 38 KB in flight per SM. A block of LRU_CT * LRU_NS = 256
// threads keeps one tile of 256 x 16 x 8 bytes = 32 KB of loads in flight;
// the 4L values a thread holds (about 100 registers) allow two blocks an
// SM: 64 KB. At call B's (2, 1000, 4096) the grid is 256 blocks, about
// two an SM, so the block's own bytes in flight set the rate: 128-thread
// blocks (LRU_NS = 4) took 0.043 ms there against 0.041, and no less at
// (4, 4096, 4096), where 512 blocks run in two waves
// (tests/torch_k3_k10_ablations.py).
//
// Grid rule: one block per (b, LRU_CT-channel tile), B * ceil(C / LRU_CT)
// blocks. A shape with B * C well under 132 * 2 * LRU_CT (8,448 at 32)
// leaves SMs idle and walks S at one tile's latency per T steps; the
// served shapes have B * C = 8,192 (call B) and 16,384 (call A).

#include <cuda_runtime.h>
#include <stdint.h>

#define LRU_CT 32   // channels a block (one lane each)
#define LRU_NS 8    // segments a tile (threads per channel)
#define LRU_L 16    // steps a segment (a thread's registers)

template <int L>
__device__ __forceinline__ void lru_load(const float* __restrict__ log_a,
                                         const float* __restrict__ b,
                                         long long at, long long stride,
                                         int t, int S, bool live,
                                         float (&ra)[L], float (&rb)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    const bool in = live && t + i < S;
    ra[i] = in ? __ldg(log_a + at + i * stride) : 0.f;
    rb[i] = in ? __ldg(b + at + i * stride) : 0.f;
  }
}

template <int CT, int NS, int L>
__global__ void __launch_bounds__(CT * NS)
    rg_lru_scan(const float* __restrict__ log_a, const float* __restrict__ b,
                float* __restrict__ y, int S, int C, int c_tiles) {
  constexpr int T = NS * L;
  __shared__ float pair_a[2][NS][CT];
  __shared__ float pair_h[2][NS][CT];
  const int c = threadIdx.x % CT;
  const int seg = threadIdx.x / CT;
  const int ch = (blockIdx.x % c_tiles) * CT + c;
  const long long row0 = (long long)(blockIdx.x / c_tiles) * S;
  const bool live = ch < C;
  const long long stride = C;
  const int n_tiles = (S + T - 1) / T;

  float ra[L], rb[L];
  lru_load<L>(log_a, b, (row0 + seg * L) * stride + ch, stride, seg * L, S,
              live, ra, rb);
  float carry = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * T + seg * L;
    float ea[L], eb[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      ea[i] = expf(ra[i]);
      eb[i] = rb[i];
    }
    if (k + 1 < n_tiles)
      lru_load<L>(log_a, b, (row0 + t0 + T) * stride + ch, stride, t0 + T, S,
                  live, ra, rb);
    float A = 1.f, h = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      h = ea[i] * h + eb[i];
      A = A * ea[i];
    }
    const int p = k & 1;
    pair_a[p][seg][c] = A;
    pair_h[p][seg][c] = h;
    __syncthreads();
    float hin = carry;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s == seg) h = hin;
      hin = pair_a[p][s][c] * hin + pair_h[p][s][c];
    }
    carry = hin;
    if (live) {
      float* out = y + (row0 + t0) * stride + ch;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        h = ea[i] * h + eb[i];
        if (t0 + i < S) out[i * stride] = h;
      }
    }
  }
}

extern "C" {

// The kernel's tile: channels a block, segments a tile, steps a segment.
void rg_lru_tile(int* ct, int* ns, int* l) {
  *ct = LRU_CT;
  *ns = LRU_NS;
  *l = LRU_L;
}

// log_a, b, y: (B, S, C) f32, contiguous. One launch on `stream`.
int rg_lru_forward(const float* log_a, const float* b, float* y, int B,
                   int S, int C, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int c_tiles = (C + LRU_CT - 1) / LRU_CT;
  const long long grid = (long long)B * c_tiles;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rg_lru_scan<LRU_CT, LRU_NS, LRU_L>
      <<<(unsigned)grid, LRU_CT * LRU_NS, 0,
         static_cast<cudaStream_t>(stream)>>>(log_a, b, y, S, C, c_tiles);
  return (int)cudaGetLastError();
}

const char* rg_lru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
