"""Tables of the dry-run reports in results/dryrun_torch/*/*.json.

The counterpart of ``repro/launch/report.py``; the one column whose
meaning changed is ``trace (s)`` (the seconds one counted step took on
fake tensors) in place of the reference's ``compile (s)``::

    PYTHONPATH=src python -m repro_torch.launch.report \\
        [--dir results/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List


def load_all(base: str) -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(base, "*", "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if "arch" not in r:          # the NODE cells under node/
            continue
        name = os.path.basename(path)[:-5]
        parts = name.split("__")
        r["_file"] = name
        r["_tag"] = parts[2] if len(parts) > 2 else ""
        rows.append(r)
    return rows


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _tag(r: Dict) -> str:
    return r["arch"] + (" (NODE)" if r.get("node_mode") else "") \
        + (f" [{r['_tag']}]" if r.get("_tag") else "")


def roofline_table(rows: List[Dict], mesh: str) -> str:
    hdr = ("| arch | shape | kind | t_comp (s) | t_mem (s) | t_coll (s) "
           "| dominant | useful/counted | roofline frac | HBM/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r.get("skipped") or r["mesh"] != mesh:
            continue
        roof = r["roofline"]
        mem = r.get("memory_analysis", {})
        hbm = (mem.get("argument_bytes") or 0) + \
            (mem.get("temp_bytes") or 0)
        out.append(
            f"| {_tag(r)} | {r['shape']} | {r['kind']} "
            f"| {roof['t_compute']:.3e} | {roof['t_memory']:.3e} "
            f"| {roof['t_collective']:.3e} | {roof['dominant']} "
            f"| {roof['useful_flop_ratio']:.2f} "
            f"| {roof['roofline_fraction']:.3f} "
            f"| {fmt_bytes(hbm / r['n_devices'] if hbm else None)} |\n")
    return "".join(out)


def dryrun_table(rows: List[Dict], mesh: str) -> str:
    hdr = ("| arch | shape | trace (s) | flops/dev | bytes/dev "
           "| coll bytes/dev | top collectives |\n"
           "|---|---|---|---|---|---|---|\n")
    out = [hdr]
    for r in rows:
        if r.get("skipped") or r["mesh"] != mesh:
            continue
        roof = r["roofline"]
        coll = sorted(roof["coll_by_kind"].items(), key=lambda kv: -kv[1])
        cstr = ", ".join(f"{k}:{fmt_bytes(v)}" for k, v in coll[:2])
        out.append(
            f"| {_tag(r)} | {r['shape']} | {r['trace_s']} "
            f"| {roof['flops_per_device']:.2e} "
            f"| {roof['bytes_per_device']:.2e} "
            f"| {roof['coll_bytes_per_device']:.2e} | {cstr} |\n")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    rows = load_all(args.dir)
    for mesh in sorted({r["mesh"] for r in rows if not r.get("skipped")}):
        n = sum(1 for r in rows if not r.get("skipped")
                and r["mesh"] == mesh)
        print(f"\n## Mesh {mesh} — {n} cells\n")
        print(dryrun_table(rows, mesh))
        print(roofline_table(rows, mesh))


if __name__ == "__main__":
    main()
