"""K10's and K3's designs against their alternatives: variants of
``csrc/rg_lru.cu`` and ``csrc/rk_stage.cu``, timed on one NVIDIA card.

    python3 tests/torch_k3_k10_ablations.py [--kernel k10|k3]
                                            [--variants NAME ...]

Each variant is the source with a few statements changed by text
substitution (and, for K3, the wrapper's grid rule or path decision
replaced), compiled with the port's nvcc flags into the git-ignored
``build/k3_k10_ablations/`` (all ``nvcc`` processes started together) and
timed on the same inputs, in turns (all variants, then all in reverse
order): K10 by ``torch_k9_times.time_k10`` (f32 at (4, 4096, 4096) and
(2, 1000, 4096)), K3 by ``torch_k9_times.time_k3`` (f32, HeunEuler's one
stage, at (8, 393,218) and (8, 393,216), and K1 at N = 3,145,728).

K10 (tiles of LRU_NS segments of LRU_L steps over LRU_CT channels; the
source's (LRU_CT, LRU_NS, LRU_L) are (32, 8, 16): 256 threads a block):

* ``base``: the source as it is (registers, the next tile's loads issued
  before this tile's scan);
* ``ns4``, ``ns2``: (32, 4, 16) and (32, 2, 16), blocks of 128 and 64
  threads;
* ``ct16``, ``ct64``: (16, 8, 16) and (64, 2, 16), 128 threads;
* ``l32``, ``l64``: (32, 4, 32) and (32, 4, 64), 32 or 64 steps a thread;
* ``no_prefetch``: each tile's loads issued at the top of its own step;
* ``ring2``, ``ring3``: (32, 4, 16) with log_a and b staged through a 2-
  or 3-tile ``cp.async`` ring in shared memory (4-byte copies, zero-filled
  past the edges; the segment scan writes exp(log_a) back in place and the
  apply scan reads it from there), two barriers a tile;
* ``ring3_l32``: the 3-tile ring at (32, 4, 32).

K3 (16-byte vectors, RK_UNROLL 1 a thread and pass, one pass over each
row; K1 shares the row code with one vector a pass):

* ``base``: the source and wrapper as they are;
* ``u2``, ``u4``: 2 or 4 vectors a thread and pass (the grid follows);
* ``wave``: at most one wave of blocks (132 SMs x 8 blocks of 256
  threads over all rows: K1's grid before it took K3's rule), a
  grid-stride loop covering the rest;
* ``all_stages``: registers for all 7 stages' loads at every stage count
  (no RK_FEW_STAGES bucket; K1 too);
* ``scalar``: the wrapper's path decision forced to the scalar path (the
  parent's design on the serving row).

Every variant is held against its plain version on its first round (K10
at (4, 4096, 4096) as max |difference| / max |plain|, bound 1e-5; K3
bitwise at (8, 393,218)). A substitution that no longer matches the
source stops the script. Prints one JSON line per variant and round,
then the card's name and power limit.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_k9_times as kt  # noqa: E402
from torch_k7_k8_ablations import patched, ptxas  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import rg_lru as lru  # noqa: E402
from repro_torch.kernels import rk_stage  # noqa: E402

OUT = ROOT / "build" / "k3_k10_ablations"

# ------------------------------------------------------------------ K10


def sizes(ct=32, ns=8, steps=16):
    return [("#define LRU_CT 32 ", f"#define LRU_CT {ct} "),
            ("#define LRU_NS 8 ", f"#define LRU_NS {ns} "),
            ("#define LRU_L 16 ", f"#define LRU_L {steps} ")]


NO_PREFETCH = [
    ("""  float ra[L], rb[L];
  lru_load<L>(log_a, b, (row0 + seg * L) * stride + ch, stride, seg * L, S,
              live, ra, rb);""", "  float ra[L], rb[L];"),
    ("""    const int t0 = k * T + seg * L;
""", """    const int t0 = k * T + seg * L;
    lru_load<L>(log_a, b, (row0 + t0) * stride + ch, stride, t0, S, live,
                ra, rb);
"""),
    ("""    if (k + 1 < n_tiles)
      lru_load<L>(log_a, b, (row0 + t0 + T) * stride + ch, stride, t0 + T, S,
                  live, ra, rb);
""", ""),
]

RING_KERNEL = r"""
__device__ __forceinline__ void lru_cp4(float* dst, const float* src,
                                        bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

template <int CT, int NS, int L>
__global__ void __launch_bounds__(CT * NS)
    rg_lru_scan(const float* __restrict__ log_a, const float* __restrict__ b,
                float* __restrict__ y, int S, int C, int c_tiles) {
  constexpr int T = NS * L, NT = CT * NS;
  extern __shared__ float ring[];  // [LRU_STAGES][2][T][CT]
  __shared__ float pair_a[NS][CT];
  __shared__ float pair_h[NS][CT];
  const int c = threadIdx.x % CT;
  const int seg = threadIdx.x / CT;
  const int c0 = (blockIdx.x % c_tiles) * CT;
  const long long row0 = (long long)(blockIdx.x / c_tiles) * S;
  const bool live = c0 + c < C;
  const long long stride = C;
  const int n_tiles = (S + T - 1) / T;
  auto load_tile = [&](int k) {
    if (k < n_tiles) {
      float* st = ring + (k % LRU_STAGES) * 2 * T * CT;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int e = i * NT + threadIdx.x;
        const int r = e / CT, cc = e % CT;
        const bool in = k * T + r < S && c0 + cc < C;
        const long long at = in ? (row0 + k * T + r) * stride + c0 + cc : 0;
        lru_cp4(st + r * CT + cc, log_a + at, in);
        lru_cp4(st + (T + r) * CT + cc, b + at, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int k = 0; k < LRU_STAGES - 1; ++k) load_tile(k);
  float carry = 0.f;
  for (int k = 0; k < n_tiles; ++k) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(LRU_STAGES - 2));
    __syncthreads();  // tile k landed; tile k - 1's stage is free
    load_tile(k + LRU_STAGES - 1);
    float* as = ring + (k % LRU_STAGES) * 2 * T * CT + seg * L * CT + c;
    const float* bs = as + T * CT;
    float A = 1.f, h = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const float a = expf(as[i * CT]);
      as[i * CT] = a;
      h = a * h + bs[i * CT];
      A = A * a;
    }
    pair_a[seg][c] = A;
    pair_h[seg][c] = h;
    __syncthreads();
    float hin = carry;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (s == seg) h = hin;
      hin = pair_a[s][c] * hin + pair_h[s][c];
    }
    carry = hin;
    const int t0 = k * T + seg * L;
    if (live) {
      float* out = y + (row0 + t0) * stride + c0 + c;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        h = as[i * CT] * h + bs[i * CT];
        if (t0 + i < S) out[i * stride] = h;
      }
    }
  }
}

"""

RING_LAUNCH = (
    """  rg_lru_scan<LRU_CT, LRU_NS, LRU_L>
      <<<(unsigned)grid, LRU_CT * LRU_NS, 0,
         static_cast<cudaStream_t>(stream)>>>(log_a, b, y, S, C, c_tiles);""",
    """  const int smem = LRU_STAGES * 2 * LRU_NS * LRU_L * LRU_CT * 4;
  cudaFuncSetAttribute(rg_lru_scan<LRU_CT, LRU_NS, LRU_L>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rg_lru_scan<LRU_CT, LRU_NS, LRU_L>
      <<<(unsigned)grid, LRU_CT * LRU_NS, smem,
         static_cast<cudaStream_t>(stream)>>>(log_a, b, y, S, C, c_tiles);""")


def ring(stages: int):
    """Substitutions for the cp.async ring (the kernel replaced whole)."""
    return [("RING", stages), RING_LAUNCH]


def k10_source(subs) -> str:
    text_subs = [s for s in subs if s[0] != "RING"]
    text = patched(build.CSRC_DIR / "rg_lru.cu", text_subs)
    for key, stages in (s for s in subs if s[0] == "RING"):
        start = text.index("template <int L>\n__device__ __forceinline__ "
                           "void lru_load")
        end = text.index('extern "C" {')
        text = (text[:start] + f"#define LRU_STAGES {stages}\n"
                + RING_KERNEL + text[end:])
    return text


K10_VARIANTS = {
    "base": [],
    "ns4": sizes(ns=4),
    "ns2": sizes(ns=2),
    "ct16": sizes(ct=16, ns=8),
    "ct64": sizes(ct=64, ns=2),
    "l32": sizes(ns=4, steps=32),
    "l64": sizes(ns=4, steps=64),
    "no_prefetch": NO_PREFETCH,
    "ring2": sizes(ns=4) + ring(2),
    "ring3": sizes(ns=4) + ring(3),
    "ring3_l32": sizes(ns=4, steps=32) + ring(3),
}

# ------------------------------------------------------------------ K3

K3_VARIANTS = {
    "base": [],
    "u2": [("#define RK_UNROLL 1", "#define RK_UNROLL 2")],
    "u4": [("#define RK_UNROLL 1", "#define RK_UNROLL 4")],
    "wave": [],
    "all_stages": [("#define RK_FEW_STAGES 2", "#define RK_FEW_STAGES 7")],
    "scalar": [],
}
K3_UNROLL = {"u2": 2, "u4": 4}
WRAPPER = (rk_stage.UNROLL, rk_stage.increment_blocks,
           rk_stage.row_vectorized)


def k3_wrapper(name: str):
    """(UNROLL, grid rule, path decision) the wrapper uses for a variant."""
    unroll, blocks, vectorized = WRAPPER
    if name == "wave":
        def blocks(n, dtype, vec, one_pass=blocks):
            # K3 runs K3_ROWS rows at its shapes, K1 one row of K1_N
            rows = 1 if n == kt.K1_N else kt.K3_ROWS
            return min(one_pass(n, dtype, vec),
                       -(-rk_stage.MAX_BLOCKS // rows)) if vec else \
                one_pass(n, dtype, vec)
    if name == "scalar":
        def vectorized(*_):
            return False
    return K3_UNROLL.get(name, unroll), blocks, vectorized


def k10_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A variant's library, bound without the wrapper's tile check (its
    tile may differ; the wrapper does not use it to launch)."""
    lru.bind(lib)
    lib._repro_bound = True
    return lib


def k3_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in rk_stage._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.rk_error_string.argtypes = [ctypes.c_int]
    lib.rk_error_string.restype = ctypes.c_char_p
    lib._repro_bound = True
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("k10", "k3"), default="k10")
    parser.add_argument("--variants", nargs="+")
    args = parser.parse_args(argv)
    variants = K10_VARIANTS if args.kernel == "k10" else K3_VARIANTS
    names = args.variants or list(variants)
    if not torch.cuda.is_available():
        print("torch_k3_k10_ablations: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in names:
        src = OUT / f"{args.kernel}_{name}.cu"
        src.write_text(k10_source(variants[name]) if args.kernel == "k10"
                       else patched(build.CSRC_DIR / "rk_stage.cu",
                                    variants[name]))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{args.kernel}_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    bind = k10_bind if args.kernel == "k10" else k3_bind
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        print(json.dumps({"kernel": args.kernel, "variant": name,
                          "ptxas": ptxas(log, "rg_lru_scan" if args.kernel
                                         == "k10" else "increment")}),
              flush=True)
        libs[name] = bind(ctypes.CDLL(str(OUT / f"lib{args.kernel}_{name}"
                                          ".so")))
    if args.kernel == "k10":
        mod, data = lru, kt.k10_inputs(0)
        la, x = data[0]
        want = lru.rg_lru_plain(la, x)
    else:
        mod, data = rk_stage, kt.k3_inputs(0)
        z, k, h = data[0][0]
        want = rk_stage.increment_batched_plain(z, k, h, kt.HEUN_STAGE)
    lib_of = mod._lib
    try:
        for r in range(2):
            for name in (names if r == 0 else names[::-1]):
                mod._lib = lambda lib=libs[name]: lib
                row = {"kernel": args.kernel, "variant": name, "round": r}
                if args.kernel == "k10":
                    if r == 0:
                        got = ops.rg_lru(la, x)
                        row["err"] = float((got - want).abs().max()
                                           / want.abs().max())
                    times = kt.time_k10(ops, data)
                else:
                    (rk_stage.UNROLL, rk_stage.increment_blocks,
                     rk_stage.row_vectorized) = k3_wrapper(name)
                    if r == 0:
                        row["bitwise"] = bool(torch.equal(
                            rk_stage.rk_stage_increment_batched(
                                z, k, h, kt.HEUN_STAGE), want))
                    times = kt.time_k3(rk_stage, data)
                print(json.dumps({**row, **times}), flush=True)
    finally:
        mod._lib = lib_of
        (rk_stage.UNROLL, rk_stage.increment_blocks,
         rk_stage.row_vectorized) = WRAPPER
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
