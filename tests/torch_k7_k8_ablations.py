"""K7's and K8's designs against their alternatives and ablations:
variants of ``csrc/rmsnorm.cu`` and ``csrc/flash_attention.cu``, timed on
one NVIDIA card.

    python3 tests/torch_k7_k8_ablations.py [--kernel k7|k8]
                                           [--variants NAME ...]

Each variant is the source with a few statements changed by text
substitution, compiled with the port's nvcc flags into the git-ignored
``build/k7_k8_ablations/`` (all ``nvcc`` processes started together) and
timed on the same inputs, in turns (all variants, then all in reverse
order): K7 by ``torch_k9_times.time_k7`` (bf16 at the decode rows (4, D)
of D = 4096, 2560, 5120 and at (16384, 4096)), K8 by
``torch_k9_times.time_k8`` (recurrentgemma_9b's prefill, q (4, 16, 4096,
256) bf16, one kv head, window 2048 and 0).

K7 (the one-pass kernel; the two-pass one is timed alone in every
variant):

* ``base``: the source as it is (2 vectors of 16 bytes a thread);
* ``vpt1``, ``vpt4``, ``vpt8``: 1, 4 or 8 vectors a thread (blocks of
  512, 128 or 64 threads at D = 4096).

K8 (the bf16 kernel):

* ``base``: the source as it is;
* ``sync_loads``: every cp.async group waited for as soon as it is
  issued, so no load overlaps a product (the design's first milestone);
* ``masked_tiles``: every visited kv tile masked, none run as interior;
* ``longest_rows_first``: the query tiles with the most kv tiles launched
  first;
* ``bq128``: 128-query tiles, one block of 8 warps;
* ``bk32``: 32-key tiles, one buffer each for K and V;
* ``bk32_double``: 32-key tiles with two buffers each for K and V (tile
  j + 1 loads while tile j computes; one barrier a tile), the same shared
  memory as the source;
* ``bk64_double``: the same with 64-key tiles (169 KB, one block an SM);
* ``no_kv_fragments``: K's and V's fragments not read from shared memory
  (the products take registers instead; wrong output);
* ``no_pv``: without the P V products (wrong output);
* ``no_products``: without either product: loads, softmax, store.

The variants that compute the kernel's function are also held against
its plain version (K7 at (4, 4096) in bf16 ulps, bound 1; K8 at window
2048 as max |difference| / max |plain|, bound 1e-2). A substitution that
no longer matches the source stops the script. Prints one JSON line per
variant and round, then the card's name and power limit.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

import torch_k9_times as kt  # noqa: E402
from chip_smoke import _bf16_ulps  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rmsnorm as k7  # noqa: E402
from repro_torch.models.common import rmsnorm as rmsnorm_plain  # noqa: E402

OUT = ROOT / "build" / "k7_k8_ablations"

# ------------------------------------------------------------------ K7

K7_VARIANTS = {
    "base": [],
    **{f"vpt{n}": [("#define RMS_VPT 2", f"#define RMS_VPT {n}")]
       for n in (1, 4, 8)},
}

# ------------------------------------------------------------------ K8

SYNC_V = ("""    fa_cp_tile<HD, FA_BK, NTHREADS>(Vs, vg, k0, S);
    fa_cp_commit();""", """    fa_cp_tile<HD, FA_BK, NTHREADS>(Vs, vg, k0, S);
    fa_cp_commit();
    fa_cp_wait<0>();
    __syncthreads();""")
SYNC_K = ("""      fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, k0 + FA_BK, S);
      fa_cp_commit();""", """      fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, k0 + FA_BK, S);
      fa_cp_commit();
      fa_cp_wait<0>();""")
MASKED = ("if (j >= ilo && j <= ihi)", "if (j < 0)")
LONGEST_FIRST = ("const int q0 = blockIdx.x * BQ;",
                 "const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;")
BQ128 = ("#define FA_WARPS 4", "#define FA_WARPS 8")
BK32 = ("#define FA_BK 64", "#define FA_BK 32")
# two buffers each for K and V: Qs, then (K, V) of tile j's parity
DOUBLE = [
    ("const int smem = (BQ + 2 * FA_BK) * (HD + FA_PAD) * 2;",
     "const int smem = (BQ + 4 * FA_BK) * (HD + FA_PAD) * 2;"),
    ("""  fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, lo * FA_BK, S);
  fa_cp_commit();""", """  fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, lo * FA_BK, S);
  fa_cp_tile<HD, FA_BK, NTHREADS>(Vs, vg, lo * FA_BK, S);
  fa_cp_commit();"""),
    ("""    fa_cp_wait<0>();
    __syncthreads();  // K(j) has landed; every warp is done with V(j - 1)
    fa_cp_tile<HD, FA_BK, NTHREADS>(Vs, vg, k0, S);
    fa_cp_commit();""", """    const __nv_bfloat16* Kc = Ks + ((j - lo) & 1) * 2 * FA_BK * LD;
    const __nv_bfloat16* Vc = Kc + FA_BK * LD;
    fa_cp_wait<0>();
    __syncthreads();  // tile j has landed; tile j - 1's readers are done
    if (j < hi) {
      __nv_bfloat16* Kn = Ks + ((j + 1 - lo) & 1) * 2 * FA_BK * LD;
      fa_cp_tile<HD, FA_BK, NTHREADS>(Kn, kg, k0 + FA_BK, S);
      fa_cp_tile<HD, FA_BK, NTHREADS>(Kn + FA_BK * LD, vg, k0 + FA_BK, S);
      fa_cp_commit();
    }"""),
    ("fa_ldm4(kb, Ks + (nt * 8 + kr) * LD + kk * 16 + kc);",
     "fa_ldm4(kb, Kc + (nt * 8 + kr) * LD + kk * 16 + kc);"),
    ("""    __syncthreads();  // every warp is done with K(j)
    if (j < hi) {
      fa_cp_tile<HD, FA_BK, NTHREADS>(Ks, kg, k0 + FA_BK, S);
      fa_cp_commit();
    }""", ""),
    ("""    if (j < hi)
      fa_cp_wait<1>();
    else
      fa_cp_wait<0>();
    __syncthreads();  // V(j) has landed""", ""),
    ("fa_ldm4t(vb, Vs + (kk * 16 + ar) * LD + d * 8 + ac);",
     "fa_ldm4t(vb, Vc + (kk * 16 + ar) * LD + d * 8 + ac);"),
]
NO_KV_FRAGMENTS = [
    ("fa_ldm4(kb, Ks + (nt * 8 + kr) * LD + kk * 16 + kc);",
     "kb[0] = qa[0] ^ nt; kb[1] = qa[1]; kb[2] = qa[2]; kb[3] = qa[3] ^ kk;"),
    ("fa_ldm4t(vb, Vs + (kk * 16 + ar) * LD + d * 8 + ac);",
     "vb[0] = pa[0] ^ d; vb[1] = pa[1]; vb[2] = pa[2]; vb[3] = pa[3] ^ kk;"),
]
NO_PV = ("""        fa_mma(acc[d], pa, vb[0], vb[1]);
        fa_mma(acc[d + 1], pa, vb[2], vb[3]);""",
         """        acc[d][0] += __uint_as_float(vb[0] ^ vb[1] ^ pa[0] ^ pa[3]);
        acc[d + 1][0] += __uint_as_float(vb[2] ^ vb[3] ^ pa[1] ^ pa[2]);""")
NO_QK = ("""        fa_mma(s[nt], qa, kb[0], kb[1]);
        fa_mma(s[nt + 1], qa, kb[2], kb[3]);""",
         """        s[nt][0] += __uint_as_float(kb[0] ^ kb[1] ^ qa[0] ^ qa[3]);
        s[nt + 1][0] += __uint_as_float(kb[2] ^ kb[3] ^ qa[1] ^ qa[2]);""")

K8_VARIANTS = {
    "base": [],
    "sync_loads": [SYNC_V, SYNC_K],
    "masked_tiles": [MASKED],
    "longest_rows_first": [LONGEST_FIRST],
    "bq128": [BQ128],
    "bk32": [BK32],
    "bk32_double": [BK32] + DOUBLE,
    "bk64_double": DOUBLE,
    "no_kv_fragments": NO_KV_FRAGMENTS,
    "no_pv": [NO_PV],
    "no_products": [NO_PV, NO_QK],
}
WRONG = ("no_kv_fragments", "no_pv", "no_products")

KERNELS = {"k7": ("rmsnorm", K7_VARIANTS, k7),
           "k8": ("flash_attention", K8_VARIANTS, fa)}


def patched(source: Path, subs) -> str:
    text = source.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"torch_k7_k8_ablations: {source.name} no "
                             f"longer has {old.strip()[:60]!r}; update the "
                             "variants")
        text = text.replace(old, new)
    return text


def ptxas(log: str, entry_has: str) -> list:
    """ptxas's register and spill lines for the entries named so."""
    out, entry = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry_has in entry and ("Used" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def k7_bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """A variant's library with K7's argument types (its block-size
    constants may differ from the wrapper's: not checked)."""
    lib.rmsnorm_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_forward.restype = ctypes.c_int
    lib.rmsnorm_noop.argtypes = [ctypes.c_void_p]
    lib.rmsnorm_noop.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=list(KERNELS), default="k8")
    parser.add_argument("--variants", nargs="+")
    args = parser.parse_args(argv)
    source, variants, mod = KERNELS[args.kernel]
    names = args.variants or list(variants)
    if not torch.cuda.is_available():
        print("torch_k7_k8_ablations: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in names:
        src = OUT / f"{args.kernel}_{name}.cu"
        src.write_text(patched(build.CSRC_DIR / f"{source}.cu",
                               variants[name]))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o",
             str(OUT / f"lib{args.kernel}_{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    bind = k7_bind if args.kernel == "k7" else fa.bind
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        print(json.dumps({"kernel": args.kernel, "variant": name,
                          "ptxas": ptxas(log, "one_pass" if args.kernel
                                         == "k7" else "flash_fwd_bf16")}),
              flush=True)
        libs[name] = bind(ctypes.CDLL(str(OUT / f"lib{args.kernel}_{name}"
                                          ".so")))
    if args.kernel == "k7":
        data = kt.k7_inputs(0)
        x, w = data[0]
        want = rmsnorm_plain(x, w)
    else:
        data = kt.k8_inputs(0)
        want = fa.flash_attention_plain(*data, window=2048)
    lib_of = mod._lib
    try:
        for r in range(2):
            for name in (names if r == 0 else names[::-1]):
                mod._lib = lambda lib=libs[name]: lib
                row = {"kernel": args.kernel, "variant": name, "round": r}
                if args.kernel == "k7":
                    if r == 0:
                        row["bf16_ulps"] = _bf16_ulps(
                            torch, ops.rmsnorm(x, w), want)
                    times = kt.time_k7(ops, k7, data)
                else:
                    if r == 0 and name not in WRONG:
                        got = ops.flash_attention(*data, window=2048)
                        row["err"] = float(
                            (got.float() - want.float()).abs().max()
                            / want.float().abs().max())
                    times = kt.time_k8(ops, *data)
                print(json.dumps({**row, **times}), flush=True)
    finally:
        mod._lib = lib_of
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
