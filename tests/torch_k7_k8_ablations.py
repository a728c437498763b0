"""K7's and K8's designs against their alternatives and ablations:
variants of ``csrc/rmsnorm.cu`` and ``csrc/flash_attention.cu``, timed on
one NVIDIA card.

    python3 tests/torch_k7_k8_ablations.py [--kernel k7|k8]
                                           [--variants NAME ...]
                                           [--out DIR]

Each variant is the source with a few statements changed by text
substitution, compiled with the port's nvcc flags into ``--out`` (by
default the git-ignored ``build/k7_k8_ablations/``; all ``nvcc``
processes started together) and
timed on the same inputs, in turns (all variants, then all in reverse
order): K7 by ``torch_k9_times.time_k7`` (bf16 at the decode rows (4, D)
of D = 4096, 2560, 5120 and at (16384, 4096)), K8 by
``torch_k9_times.time_k8`` (bf16: recurrentgemma_9b's prefill, q (4, 16,
4096, 256), one kv head, window 2048 and 0; causal q (4, 64, 4096, 128)
with 8 kv heads and (2, 24, 1024, 64)).

K7 (the one-pass kernel; the two-pass one is timed alone in every
variant):

* ``base``: the source as it is (2 vectors of 16 bytes a thread);
* ``vpt1``, ``vpt4``, ``vpt8``: 1, 4 or 8 vectors a thread (blocks of
  512, 128 or 64 threads at D = 4096).

K8 (the wgmma kernel; each variant rewrites ``FA_NWG``, ``FA_STAGES``,
the ``FA_CFG(head dim, BK)`` lines or statements of the source):

* ``base``: the source as it is;
* ``no_overlap``: the softmax of tile j after S(j) and before P(j) V(j),
  nothing of its own warpgroup in flight beside it;
* ``no_pingpong``: the two warpgroups issue their products as they come,
  not in turns;
* ``neither``: no overlap and no ping-pong;
* ``stages3``: a ring of 3 stages at head dims 64 and 128 (at 256 three
  do not fit in shared memory);
* ``one_warpgroup``: one consumer warpgroup, 64-query tiles, no
  ping-pong and no setmaxnreg (a block of 256 threads has 255 registers
  a thread);
* ``bk_small``: kv tiles of 64 keys at head dims 64 and 128, 32 at 256;
* ``tile_major``, ``head_major``: the blocks of one query tile of every
  head together (the longest rows of all heads first), or a head's tiles
  together, whatever the size of K and V (the source takes the second
  where they fill more than half the L2);
* ``rescale_always``: O rescaled at every tile, also where no row's
  maximum moved;
* ``no_pv``: without the P V products (wrong output): loads, S, softmax.

Planted faults, checked and not timed: ``fault_diag`` drops the diagonal
kv tile of every warpgroup whose rows start at 2048 or later (a fault
confined to the long rows); ``fault_stage`` has P V read V from the
other ring stage past a warpgroup's 16th tile; ``fault_scale`` makes the
rows of every warpgroup that starts at 2048 or later 2% too large (as a
row sum that missed 2% of its weight would), which leaves max |difference|
on the first rows.

Every variant is held against the plain version at each case's first
window (K7 at (4, 4096) in bf16 ulps, bound 1; K8 as chip_smoke's two
gates: ``err``, max |difference| / max |plain|, bound ``ATT_BF16_RTOL``,
and ``rows_err``, the max over tiles of 16 rows of ||difference|| /
||plain||, bound ``ATT_BF16_ROWS_RTOL``). A substitution that no longer
matches the source stops the script. Prints one JSON line per variant
and round, then the card's name and power limit.
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
from chip_smoke import (ATT_BF16_ROWS_RTOL, ATT_BF16_RTOL,  # noqa: E402
                        _bf16_ulps, _rel, _rows_rel)
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

def bk(**by_dh):
    """The FA_CFG lines with the kv tile of the head dims in by_dh ("d64"
    etc.) changed."""
    base = {64: 128, 128: 128, 256: 64}
    return [(f"FA_CFG({dh}, {old})", f"FA_CFG({dh}, {by_dh[f'd{dh}']})")
            for dh, old in base.items() if f"d{dh}" in by_dh]


OVERLAPPED = ("  if (wlo <= whi) {\n    fa_bar_wait(bar_k + 8 * stage(wlo)",
              "    turn_begin();  // no row of this warpgroup before S\n"
              "    turn_end();\n  }\n")
SERIAL = """  for (int j = wlo; j <= whi; ++j) {
    fa_bar_wait(bar_k + 8 * stage(j), parity(j));
    turn_begin();
    fa_wgmma_fence();
    fa_issue_qk<HD, BQ, BK>(s, qa, sk + stage(j) * KV_BYTES);
    fa_wgmma_commit();
    turn_end();
    fa_wgmma_wait<0>();
    fa_fence_regs(s);
    fa_bar_arrive(bar_ek + 8 * stage(j));
    fa_softmax_class(j >= wilo && j <= wihi, s, m_r, l_r, alpha,
                     scale_log2, j * BK, qpos, t, S, window);
    fa_rescale(acc, alpha);
    fa_pack_p<BK>(p, s);
    fa_bar_wait(bar_v + 8 * stage(j), parity(j));
    fa_wgmma_fence();
    fa_issue_pv<HD, BK>(acc, p, sv + stage(j) * KV_BYTES);
    fa_wgmma_commit();
    fa_wgmma_wait<0>();
    fa_fence_regs(acc);
    fa_bar_arrive(bar_ev + 8 * stage(j));
  }
"""
# one turn a block tile, none for the last P V
NO_OVERLAP = [(*OVERLAPPED, SERIAL),
              ("const int all_turns = hi - lo + 2;",
               "const int all_turns = hi - lo + 1;")]
NO_PINGPONG = [
    ("auto turn_begin = [&]() { fa_named_sync(3 + cw, 256); };",
     "auto turn_begin = [&]() {};"),
    ("if (++turns < all_turns || cw == 0) fa_named_arrive(4 - cw, 256);",
     "++turns;"),
    ("if (cw == 1) fa_named_arrive(3, 256);", "")]
NO_SETMAXNREG = [('asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\\n");',
                  ""),
                 ('asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\\n");',
                  "")]
NO_PV = ("""    fa_wgmma_rs(acc, p[kk], fa_desc(va + kk * 2048, BK * 128, 1024));""",
         """    acc[kk % (HD / 8)][0] += __uint_as_float(p[kk][0] ^ p[kk][3]);""")
SOFTMAX_J = "      fa_softmax_class(j >= wilo && j <= wihi, s, m_r, l_r, alpha,"
FAULT_DIAG = (SOFTMAX_J, """      if (j == whi && qw >= 2048)
        for (int nt = 0; nt < NT; ++nt)
          s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = FA_NEG_INF;
""" + SOFTMAX_J)
PV_J = "fa_issue_pv<HD, BK>(acc, p, sv + stage(j - 1) * KV_BYTES);"
FAULT_STAGE = (PV_J, "fa_issue_pv<HD, BK>(acc, p, sv + (stage(j - 1) ^ "
                     "(j - 1 - wlo >= 16)) * KV_BYTES);")
INV = ("  const float inv0 = 1.f / fmaxf(l_r[0], 1e-30f),\n"
       "              inv1 = 1.f / fmaxf(l_r[1], 1e-30f);\n")
FAULT_SCALE = (INV, INV.replace("1.f /", "(qw >= 2048 ? 1.02f : 1.f) /"))

L2_RULE = "#define FA_L2_HALF_BYTES (25.0 * (1 << 20))"
RESCALE_SKIP = ("  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] "
                "!= 1.f)) return;\n")

K8_VARIANTS = {
    "base": [],
    "no_overlap": NO_OVERLAP,
    "no_pingpong": NO_PINGPONG,
    "neither": NO_OVERLAP + NO_PINGPONG,
    "stages3": [("#define FA_STAGES 2",
                 "#define FA_STAGES (HD == 256 ? 2 : 3)")],
    "one_warpgroup": [("#define FA_NWG 2", "#define FA_NWG 1"),
                      *NO_PINGPONG, *NO_SETMAXNREG],
    "bk_small": bk(d64=64, d128=64, d256=32),
    "rescale_always": [(RESCALE_SKIP, "")],
    "tile_major": [(L2_RULE, "#define FA_L2_HALF_BYTES 1e30")],
    "head_major": [(L2_RULE, "#define FA_L2_HALF_BYTES 0.0")],
    "no_pv": [NO_PV],
    "fault_diag": [FAULT_DIAG],
    "fault_stage": [FAULT_STAGE],
    "fault_scale": [FAULT_SCALE],
}
FAULTS = ("fault_diag", "fault_stage", "fault_scale")

KERNELS = {"k7": ("rmsnorm", K7_VARIANTS, k7),
           "k8": ("flash_attention", K8_VARIANTS, fa)}


def patched(source: Path, subs) -> str:
    """The source with each (old, new) replaced, and each (first, last,
    new) the text from first to the end of last."""
    text = source.read_text()
    for *old, new in subs:
        if any(text.count(o) != 1 for o in old):
            raise SystemExit(f"torch_k7_k8_ablations: {source.name} does "
                             f"not have {old[0].strip()[:60]!r} once; "
                             "update the variants")
        a = text.index(old[0])
        b = text.index(old[-1], a) + len(old[-1])
        text = text[:a] + new + text[b:]
    return text


def ptxas(log: str, entry_has: str) -> list:
    """ptxas's register and spill lines for the entries named so, and its
    performance warnings about them (a serialized wgmma)."""
    out, entry = [], ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry_has in entry and ("Used" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
        elif "Performance Loss" in line and entry_has in line:
            out.append(line.split(":", 1)[-1].strip()[:160])
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
    parser.add_argument("--out", type=Path, default=OUT)
    args = parser.parse_args(argv)
    source, variants, mod = KERNELS[args.kernel]
    names = args.variants or list(variants)
    if not torch.cuda.is_available():
        print("torch_k7_k8_ablations: no CUDA device", file=sys.stderr)
        return 2
    out = args.out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name in names:
        src = out / f"{args.kernel}_{name}.cu"
        src.write_text(patched(build.CSRC_DIR / f"{source}.cu",
                               variants[name]))
        procs[name] = subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-o",
             str(out / f"lib{args.kernel}_{name}.so"), str(src)],
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
                                         == "k7" else "flash_fwd_wgmma")}),
              flush=True)
        libs[name] = bind(ctypes.CDLL(str(out / f"lib{args.kernel}_{name}"
                                          ".so")))
    if args.kernel == "k7":
        data = kt.k7_inputs(0)
        x, w = data[0]
        want = rmsnorm_plain(x, w)
    else:
        data = kt.k8_inputs(0)
        want = [fa.flash_attention_plain(*d, window=w[0])
                for d, (_, w) in zip(data, kt.K8_CASES)]
    lib_of = mod._lib
    timed = [n for n in names if n not in FAULTS]
    try:
        for r in range(2):
            for name in (names if r == 0 else timed[::-1]):
                mod._lib = lambda lib=libs[name]: lib
                row = {"kernel": args.kernel, "variant": name, "round": r}
                times = {}
                if args.kernel == "k7":
                    if r == 0:
                        row["bf16_ulps"] = _bf16_ulps(
                            torch, ops.rmsnorm(x, w), want)
                    times = kt.time_k7(ops, k7, data)
                else:
                    if r == 0:
                        got = [ops.flash_attention(*d, window=w[0])
                               for d, (_, w) in zip(data, kt.K8_CASES)]
                        row["err"] = max(map(_rel, got, want))
                        row["rows_err"] = max(_rows_rel(torch, a, b)
                                              for a, b in zip(got, want))
                        row["passes"] = {
                            "err": row["err"] <= ATT_BF16_RTOL,
                            "rows_err":
                            row["rows_err"] <= ATT_BF16_ROWS_RTOL}
                        del got
                    if name not in FAULTS:
                        times = kt.time_k8(ops, data)
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
