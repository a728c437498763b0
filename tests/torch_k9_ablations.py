"""Where K9's time goes: ablated copies of ``csrc/ssd_scan.cu``, timed on
one NVIDIA card.

    python3 tests/torch_k9_ablations.py

Each variant is the source with a few statements removed by text
substitution (so its outputs are wrong; only its time means anything),
compiled with the port's nvcc flags into the git-ignored
``build/k9_ablations/`` and timed by ``torch_k9_times.time_tree`` on the
same inputs, in turns (all variants, then all in reverse order):

* ``base``: the source as it is;
* ``k1_no_mma``: kernel 1 without its mma.sync (loads, cumsum, stores);
* ``k3_no_intra``: kernel 3 without the key-tile loop's work (the key
  blocks still stream);
* ``k3_no_streams``: and without any copy or load from device memory (no
  state, key blocks, C, dt or cs);
* ``k3_skeleton``: and without the state's split, C h^T and the store of
  y: what is left is the blocks' launch, their barriers and the loops.

A substitution that no longer matches the source stops the script.
Prints one JSON line per variant and round, then the card's name and
power limit.
"""

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
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import ssd_scan as k9  # noqa: E402

SOURCE = build.CSRC_DIR / "ssd_scan.cu"
OUT = ROOT / "build" / "k9_ablations"

NO_INTRA = ("const int njt = kb < rb ? W : warp + 1;", "const int njt = 0;")
NO_STATE = ("    ssd_cp16(Hs + (4 * i / N) * LDH + 4 * i % N, hp + 4 * i);",
            "    if (i < 0) ssd_cp16(Hs, hp);")
NO_KEYS = ("""    ssd_cp_rows<NTHREADS>(dst, LDB,""",
           """    if (kb < 0) ssd_cp_rows<NTHREADS>(dst, LDB,""")
NO_KEYS_X = ("""    ssd_cp_rows<NTHREADS>(dst + QB * LDB, LDX,""",
             """    if (kb < 0) ssd_cp_rows<NTHREADS>(dst + QB * LDB, LDX,""")
NO_C = ("""    cf[kk][0] = ssd_ld32(ca + kk * 16);
    cf[kk][1] = ssd_ld32(cb + kk * 16);
    cf[kk][2] = ssd_ld32(ca + kk * 16 + 8);
    cf[kk][3] = ssd_ld32(cb + kk * 16 + 8);""",
        """    cf[kk][0] = kk; cf[kk][1] = ia; cf[kk][2] = ib; cf[kk][3] = t;""")
NO_DT = ("""    dts[i] = dt[(row0 + i) * H + h];
    cs[i] = cs_in[(row0 + i) * H + h];""", """    dts[i] = 0.01f * i;
    cs[i] = -0.01f * i;""")
NO_SPLIT = ("""    const float2 v = *w;
    uint2 hl;
    ssd_split(v.x, v.y, hl.x, hl.y);
    *reinterpret_cast<uint2*>(w) = hl;""", """    if (i < 0) *w = make_float2(0.f, 0.f);""")
NO_INTER = ("""      ssd_mma(acc[pt], cf[kk], w0.x, w1.x);
      ssd_mma(acc[pt], cf[kk], w0.y, w1.y);""",
            """      acc[pt][0] += __uint_as_float(w0.x ^ w1.y);""")
NO_Y = ("""    *reinterpret_cast<uint32_t*>(ya + col) =
        ssd_pack_f32(acc[pt][0], acc[pt][1]);
    *reinterpret_cast<uint32_t*>(yb + col) =
        ssd_pack_f32(acc[pt][2], acc[pt][3]);""",
        """    if (acc[pt][0] == 1234.5f) *reinterpret_cast<uint32_t*>(ya + col) =
        ssd_pack_f32(acc[pt][0], acc[pt][1]);
    if (acc[pt][2] == 1234.5f) *reinterpret_cast<uint32_t*>(yb + col) =
        ssd_pack_f32(acc[pt][2], acc[pt][3]);""")
K1_NO_MMA = ("""          ssd_mma(acc[k], xh, bb[0], bb[1]);
          ssd_mma(acc[k], xl, bb[0], bb[1]);
          ssd_mma(acc[k + 1], xh, bb[2], bb[3]);
          ssd_mma(acc[k + 1], xl, bb[2], bb[3]);""",
             """          acc[k][0] += __uint_as_float(bb[0] ^ bb[1] ^ xh[0] ^ xl[1]);
          acc[k + 1][0] += __uint_as_float(bb[2] ^ bb[3] ^ xh[2] ^ xl[3]);""")

STREAMS = [NO_INTRA, NO_STATE, NO_KEYS, NO_KEYS_X, NO_C, NO_DT]
VARIANTS = {
    "base": [],
    "k1_no_mma": [K1_NO_MMA],
    "k3_no_intra": [NO_INTRA],
    "k3_no_streams": STREAMS,
    "k3_skeleton": STREAMS + [NO_SPLIT, NO_INTER, NO_Y],
}


def patched(subs) -> str:
    text = SOURCE.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"torch_k9_ablations: the source no longer has "
                             f"{old.strip()[:60]!r}; update the variants")
        text = text.replace(old, new)
    return text


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k9_ablations: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(patched(subs))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", file=sys.stderr)
            return 1
        libs[name] = k9.bind(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    data = kt.inputs(0)
    lib_of = k9._lib
    try:
        for r in range(2):
            names = list(libs) if r == 0 else list(libs)[::-1]
            for name in names:
                k9._lib = lambda lib=libs[name]: lib
                print(json.dumps({"variant": name, "round": r,
                                  **kt.time_tree(ops, k9, *data)}),
                      flush=True)
    finally:
        k9._lib = lib_of
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
