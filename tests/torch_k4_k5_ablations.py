"""K4's and K5's design against its alternatives: variants of
``csrc/rk_stage.cu``, timed on one NVIDIA card.

    python3 tests/torch_k4_k5_ablations.py [--variants NAME ...]

Each variant is the source with a few statements changed by text
substitution (and, where it says so, the wrapper's tile or path decision
replaced), compiled with the port's nvcc flags into the git-ignored
``build/k4_k5_ablations/`` (all ``nvcc`` processes started together) and
timed on the same inputs, in turns (all variants, then all in reverse
order), by ``torch_k9_times.time_k45``: f32, HeunEuler's weights, K4 and
K5 at the serving state (8, 393,218) and the batched block state (8,
393,216).

* ``base``: the source as it is: tiles of 2048 elements (RK_TILE), 2
  vectors of 16 bytes a thread and pass, each tile's r^2 summed through
  shared memory by position;
* ``t1024``, ``t4096``: tiles of 1024 or 4096 elements (the wrapper's
  NORM_TILE follows);
* ``u1``: one vector a thread and pass (two passes over a tile);
* ``shuffle``: no shared-memory order: each thread sums its own
  elements' r^2 as it makes them (vectors, then the head and tail), and
  K2's block reduction (warp shuffles, then the first warp) adds the
  threads' sums. Its element map follows the row's head, so its
  partials depend on the offset: the earlier per-block order, on the
  tile grid;
* ``scalar``: the wrapper's path decision forced to the scalar path (one
  element a thread and load, 8 a pass) on both rows;
* ``occ6``, ``occ8``: the kernel's launch bounds ask for 6 or 8 resident
  blocks an SM (at most 40 or 32 registers a thread);
* ``no_sum``: z_next only, no r^2 to shared memory and no tile sum (the
  partials are garbage): what streaming the bytes alone takes;
* ``no_sum_no_sync``: ``no_sum`` without the block's barrier.

On its first round every variant is held against the plain versions at
(8, 393,218): z_next bitwise, and K5's partials bitwise the plain tile
partials at its tile (``shuffle``: their row sums within 1e-6 of the
plain norm; ``no_sum*``: z_next only). A substitution that no longer
matches the source stops the script. Prints one JSON line per variant
and round, then the card's name and power limit.
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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rk_stage  # noqa: E402

OUT = ROOT / "build" / "k4_k5_ablations"
ROW_NORM_RTOL = 1e-6

SHUFFLE = [
    ("  float* s = sq_s + (V - head) % V;   // s + head + u * V is 16-byte "
     "aligned\n"
     "  for (int q = len + threadIdx.x; q < RK_TILE; q += RK_THREADS) "
     "s[q] = 0.0f;\n",
     "  float own = 0.0f;\n"),
    ("        store_f32<V>(s + head + u * V, sq);\n",
     "#pragma unroll\n"
     "        for (int i = 0; i < V; ++i) own = __fadd_rn(own, sq[i]);\n"),
    ("    s[threadIdx.x] = combine_err_one<T, NSMAX>(",
     "    own += combine_err_one<T, NSMAX>("),
    ("    s[tail + threadIdx.x] = combine_err_one<T, NSMAX>(",
     "    own += combine_err_one<T, NSMAX>("),
    ("  __syncthreads();\n"
     "  const float sum = tile_sum(s);\n"
     "  if (threadIdx.x == 0) partials[r * pstride + blockIdx.x] = sum;\n",
     "  block_sum_to(own, partials + r * pstride + blockIdx.x);\n"),
]

BOUNDS = ("__global__ void __launch_bounds__(RK_THREADS)\n"
          "    rk_stage_combine_err_batched_kernel(")
VARIANTS = {
    "base": [],
    "t1024": [("#define RK_TILE 2048", "#define RK_TILE 1024")],
    "t4096": [("#define RK_TILE 2048", "#define RK_TILE 4096")],
    "u1": [("#define RK_TILE_UNROLL 2", "#define RK_TILE_UNROLL 1")],
    "shuffle": SHUFFLE,
    "scalar": [],
    "occ6": [(BOUNDS, BOUNDS.replace("(RK_THREADS)", "(RK_THREADS, 6)"))],
    "occ8": [(BOUNDS, BOUNDS.replace("(RK_THREADS)", "(RK_THREADS, 8)"))],
    "no_sum": [("        store_f32<V>(s + head + u * V, sq);\n", ""),
               ("  const float sum = tile_sum(s);\n",
                "  const float sum = 0.0f;\n")],
    "no_sum_no_sync": [("        store_f32<V>(s + head + u * V, sq);\n", ""),
                       ("  __syncthreads();\n"
                        "  const float sum = tile_sum(s);\n",
                        "  const float sum = 0.0f;\n")],
}
TILES = {"t1024": 1024, "t4096": 4096}
WRAPPER = (rk_stage.NORM_TILE, rk_stage.row_vectorized)


def wrapper(name: str):
    """(NORM_TILE, path decision) the wrapper uses for a variant."""
    tile, vectorized = WRAPPER
    if name == "scalar":
        def vectorized(*_):
            return False
    return TILES.get(name, tile), vectorized


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A variant's library, bound without the wrapper's constant checks
    (its tile may differ; the wrapper passes its own)."""
    for fn, argtypes in rk_stage._SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.rk_error_string.argtypes = [ctypes.c_int]
    lib.rk_error_string.restype = ctypes.c_char_p
    lib._repro_bound = True
    return lib


def check(name: str, z, k, h, rt, at) -> dict:
    """The variant's K5 at (z, k) against the plain versions."""
    zn, part = rk_stage.rk_stage_combine_err_batched_rowtol(
        z, k, h, kt.HEUN_B, kt.HEUN_E, rt, at)
    zp, sqp = rk_stage.combine_err_batched_plain(z, k, h, kt.HEUN_B,
                                                 kt.HEUN_E, rt, at)
    row = {"z_next_bitwise": bool(torch.equal(zn, zp)),
           "partials": list(part.shape)}
    if name.startswith("no_sum"):
        row["ok"] = row["z_next_bitwise"]
    elif name == "shuffle":
        rel = float(((part.sum(-1) - sqp).abs() / sqp.abs()).max())
        row["norm_rel"] = rel
        row["ok"] = row["z_next_bitwise"] and rel <= ROW_NORM_RTOL
    else:
        want = rk_stage.combine_err_batched_tile_partials(
            z, k, h, kt.HEUN_B, kt.HEUN_E, rt, at, rk_stage.NORM_TILE)
        row["tile_partials_bitwise"] = bool(torch.equal(part, want))
        row["ok"] = row["z_next_bitwise"] and row["tile_partials_bitwise"]
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+")
    args = parser.parse_args(argv)
    names = args.variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_k4_k5_ablations: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in names:
        src = OUT / f"k45_{name}.cu"
        src.write_text(patched(build.CSRC_DIR / "rk_stage.cu",
                               VARIANTS[name]))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(OUT / f"libk45_{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        print(json.dumps({"variant": name, "ptxas": ptxas(
            log, "combine_err_batched")}), flush=True)
        libs[name] = bind(ctypes.CDLL(str(OUT / f"libk45_{name}.so")))
    data = kt.k45_inputs(0)
    lib_of = rk_stage._lib
    failed = []
    try:
        for r in range(2):
            for name in (names if r == 0 else names[::-1]):
                rk_stage._lib = lambda lib=libs[name]: lib
                rk_stage.NORM_TILE, rk_stage.row_vectorized = wrapper(name)
                row = {"variant": name, "round": r}
                if r == 0:
                    row.update(check(name, *data[0]))
                    if not row["ok"]:
                        failed.append(name)
                for kernel in ("k4", "k5"):
                    row.update(kt.time_k45(rk_stage, data, kernel))
                print(json.dumps(row), flush=True)
    finally:
        rk_stage._lib = lib_of
        rk_stage.NORM_TILE, rk_stage.row_vectorized = WRAPPER
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    if failed:
        print(f"torch_k4_k5_ablations: {failed} disagree with the plain "
              "versions", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
