"""The port's report tables (``launch/report.py``) against the
reference's (``repro/launch/report.py``) on the same row dicts: every
data row equal; of the headers, only the columns whose meaning changed
differ (``compile (s)`` → ``trace (s)``; HLO FLOPs and bytes → the
counted ones). Then ``load_all`` and ``main`` on a report the port's dry
run wrote."""

import json

import pytest

from repro.launch import report as jreport
from repro_torch.launch import dryrun, report
from repro_torch.configs import get_smoke_config

CHANGED = {("compile (s)", "trace (s)"), ("HLO flops/dev", "flops/dev"),
           ("HLO bytes/dev", "bytes/dev"), ("useful/HLO", "useful/counted")}


def _row(arch, shape, kind, mesh, tag="", node=False, skipped=False,
         scale=1.0):
    if skipped:
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "full-attention arch skips long_500k", "_tag": ""}
    roof = {"t_compute": 1.5e-3 * scale, "t_memory": 2.5e-3 * scale,
            "t_collective": 4e-4 * scale, "dominant": "memory",
            "useful_flop_ratio": 0.8123, "roofline_fraction": 0.3456,
            "flops_per_device": 1.234e12 * scale,
            "bytes_per_device": 5.6e9 * scale,
            "coll_bytes_per_device": 7.8e8 * scale,
            "coll_by_kind": {"all-gather": 5e8 * scale,
                             "all-reduce": 2.8e8 * scale,
                             "reduce-scatter": 1e3}}
    return {"arch": arch, "shape": shape, "kind": kind, "mesh": mesh,
            "node_mode": node, "n_devices": 256, "compile_s": 12.34,
            "trace_s": 12.34, "_tag": tag,
            "memory_analysis": {"argument_bytes": int(3e9 * scale),
                                "temp_bytes": int(1.2e9 * scale)},
            "roofline": roof}


ROWS = [_row("qwen2_72b", "train_4k", "train", "pod16x16"),
        _row("deepseek_moe_16b", "decode_32k", "decode", "pod16x16",
             tag="v2", scale=0.01),
        _row("mamba2_2_7b", "prefill_32k", "prefill", "pod2x16x16",
             node=True, scale=3.0),
        _row("qwen2_72b", "long_500k", None, None, skipped=True)]


def _split(table):
    lines = table.strip("\n").split("\n")
    return [c.strip() for c in lines[0].strip("|").split("|")], lines[1:]


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("name", ["roofline_table", "dryrun_table"])
def test_tables_match_reference(name, mesh):
    got_hdr, got = _split(getattr(report, name)(ROWS, mesh))
    want_hdr, want = _split(getattr(jreport, name)(ROWS, mesh))
    assert got == want
    assert len(got_hdr) == len(want_hdr)
    for g, w in zip(got_hdr, want_hdr):
        assert g == w or (w, g) in CHANGED, (w, g)


def test_fmt_bytes_matches_reference():
    for b in (None, 0, 1023, 1024, 5.5e6, 3e9, 7e12, 2e16):
        assert report.fmt_bytes(b) == jreport.fmt_bytes(b)


def test_load_and_render_a_dry_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    dryrun.run_cell("mamba2_2_7b", "prefill", mesh="none",
                    config=get_smoke_config("mamba2_2_7b"),
                    plan=(16, 2, "prefill"), tag="smoke")
    (tmp_path / "node").mkdir()
    (tmp_path / "node" / "cell.json").write_text(json.dumps({"cell": "x"}))
    rows = report.load_all(str(tmp_path))
    assert [r["_file"] for r in rows] == ["mamba2_2_7b__prefill__smoke"]
    assert rows[0]["_tag"] == "smoke"
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "## Mesh none — 1 cells" in out
    assert "| mamba2_2_7b [smoke] | prefill |" in out
