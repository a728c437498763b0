"""Where K9.3's time goes: variants of ``csrc/ssd_scan.cu``'s wgmma kernel
(``ssd_chunk_scan_wgmma``), timed on one NVIDIA card.

    python3 tests/torch_k9_ablations.py [--variants NAME ...]

Each variant is the source with a few lines changed by text substitution,
compiled with the port's nvcc flags into the git-ignored
``build/k9_ablations/`` (all ``nvcc`` processes started together) and
timed at mamba2_2_7b's call A (x (4, 4096, 80, 64) bf16, one group of
state 128, chunk 256; ``torch_k9_times.inputs``) on the same inputs, in
turns (all variants, then all in reverse order), the wgmma kernel forced:

* ``base``: the source as it is;
* ``no_overlap``: S of a step waited for together with the product issued
  beside it, so the decay runs with nothing in flight;
* ``one_warpgroup``: one consumer warpgroup owning all four query blocks
  of a tile (``SSD_WG_NWG`` 1);
* ``bk32``, ``bk128``: key tiles of 32 or 128 keys (``SSD_WG_BK``);
* ``stages3``, ``stages4``: a ring of three or four stages
  (``SSD_WG_STAGES``; at four, all key tiles of a chunk of 256 at once);
* ``no_lo`` (wrong output; time only): without the lo terms of M and of
  the state, one product each instead of two;
* ``no_inter`` (wrong output): without C h_prevᵀ;
* ``loads_only`` (wrong output): without any wgmma; the loads, barriers,
  the state's split, the decay and the store remain.

The variants that keep the arithmetic (the first seven) are held against
``chunk_outputs`` (y beyond one bf16 ulp, as a share of max |y|). A
substitution that no longer matches the source stops the script. Prints
one JSON line per variant with ptxas's register and spill lines, one per
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
from chip_smoke import _ssd_err  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ssd_scan as k9  # noqa: E402

SOURCE = build.CSRC_DIR / "ssd_scan.cu"
OUT = ROOT / "build" / "k9_ablations"

WAIT1 = ("  fa_wgmma_wait<1>();  // S is done; the pending product runs on",
         "  fa_wgmma_wait<0>();")
MX_LO = ("    fa_wgmma_rs(y, ml[kk], dx);\n", "")
INTER_HI = ("      ssd_issue_cbt<SSD_WG_P>(y[q], cx.sc + cx.rb[q] * C_BYTES, "
            "cx.sh, 0);\n", "")
INTER_LO = ("""      ssd_issue_cbt<SSD_WG_P>(y[q], cx.sc + cx.rb[q] * C_BYTES,
                              cx.sh + H_BYTES, 1);
""", "")
S_ISSUE = ("""  ssd_issue_cbt<BK>(s, cx.sc + cx.rb[K] * C_BYTES,
                    cx.sb + ssd_stage(j) * B_BYTES, 0);
""", "")
MX_ISSUE = ("    ssd_issue_mx<BK>(y[PK], mh, ml, cx.sx + ssd_stage(pj) * "
            "X_BYTES);\n", "")
MX_LAST = ("  ssd_issue_mx<BK>(y[NS - 1], mh, ml, cx.sx + ssd_stage(last) * "
           "X_BYTES);\n", "")


def define(name, old, new):
    return (f"#define {name} {old}\n", f"#define {name} {new}\n")


VARIANTS = {
    "base": [],
    "no_overlap": [WAIT1],
    "one_warpgroup": [define("SSD_WG_NWG", 2, 1)],
    "bk32": [define("SSD_WG_BK", 64, 32)],
    "bk128": [define("SSD_WG_BK", 64, 128)],
    "stages3": [define("SSD_WG_STAGES", 2, 3)],
    "stages4": [define("SSD_WG_STAGES", 2, 4)],
    "no_lo": [MX_LO, INTER_LO],
    "no_inter": [INTER_HI, INTER_LO],
    "loads_only": [S_ISSUE, MX_ISSUE, MX_LAST, INTER_HI, INTER_LO],
}
EXACT = ("base", "no_overlap", "one_warpgroup", "bk32", "bk128", "stages3",
         "stages4")


def patched(subs) -> str:
    text = SOURCE.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"torch_k9_ablations: the source does not have "
                             f"{old.strip()[:60]!r} once; update the "
                             "variants")
        text = text.replace(old, new)
    return text


def ptxas(log: str) -> list:
    """ptxas's register and spill lines for the wgmma kernel, and its
    performance warnings about it."""
    out, entry = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif "ssd_chunk_scan_wgmma" in entry and ("Used" in line
                                                   or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
        if "C7515" in line or "C7520" in line or "C7508" in line:
            out.append(line.split(":", 1)[-1].strip()[:160])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="+", choices=list(VARIANTS))
    args = parser.parse_args(argv)
    names = args.variants or list(VARIANTS)
    if not torch.cuda.is_available():
        print("torch_k9_ablations: no CUDA device", file=sys.stderr)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(patched(VARIANTS[name]))
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
        print(json.dumps({"variant": name, "ptxas": ptxas(log)}), flush=True)
        libs[name] = k9.bind(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    x, dt, a, bm, cm = kt.inputs(0)
    q = kt.CHUNK
    cs, states = k9.chunk_states(x, dt, a, bm, q)
    h_prev, _ = k9.state_pass(states, cs, q)
    want = k9.chunk_outputs(x, dt, cs, bm, cm, h_prev, q).to(x.dtype)
    del states
    lib_of = k9._lib
    try:
        for r in range(2):
            for name in (names if r == 0 else names[::-1]):
                k9._lib = lambda lib=libs[name]: lib
                row = {"variant": name, "round": r}

                def run(kernel="wgmma"):
                    return k9.ssd_chunk_scan(x, dt, cs, bm, cm, h_prev, q,
                                             kernel=kernel)
                if r == 0 and name in EXACT:
                    row["err"] = _ssd_err(torch, run(), want)
                row["wgmma_ms"] = kt.time_ms(run)
                if name == "base":
                    row["mma_sync_ms"] = kt.time_ms(lambda: run("mma_sync"))
                print(json.dumps(row), flush=True)
    finally:
        k9._lib = lib_of
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
