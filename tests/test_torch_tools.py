"""The port's checkers (``repro_torch.tools``) against the lint, CLI, docs
and schema tests of ``tests/test_tools.py``: pass/fail fixture cases for
``check_bench_schema`` (and an artifact the port's ``emit_json`` writes),
``check_docs`` over the README's port section, the ``solver_lint`` CLI and
the analyzer CLI ``python -m repro_torch.analysis``."""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

from repro_torch.tools import check_bench_schema, check_docs

REPO = pathlib.Path(__file__).resolve().parent.parent


def _cli(args, **env_extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, env={**env, **env_extra},
        capture_output=True, text=True)


# ---------------------------------------------------------------------------
# check_bench_schema


GOOD_LINE = json.dumps({"bench": "solve", "metrics": {"ms": 1.5, "n": 3}})


def test_bench_schema_accepts_valid_artifacts(tmp_path):
    (tmp_path / "BENCH_solve.json").write_text(GOOD_LINE + "\n")
    assert check_bench_schema.main(["prog", str(tmp_path)]) == 0


def test_bench_schema_rejects_bad_lines(tmp_path, capsys):
    bad = "\n".join([
        GOOD_LINE,
        json.dumps({"bench": "", "metrics": {"ms": 1.0}}),
        json.dumps({"bench": "x", "metrics": {}}),
        json.dumps({"bench": "x", "metrics": {"ms": float("inf")}}),
        "not json at all",
    ])
    (tmp_path / "BENCH_bad.json").write_text(bad + "\n")
    assert check_bench_schema.main(["prog", str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "non-empty string" in out
    assert "not valid JSON" in out


def test_bench_schema_rejects_empty_artifact_dir(tmp_path):
    assert check_bench_schema.main(["prog", str(tmp_path)]) == 1


def test_bench_schema_accepts_the_ports_emit_json(tmp_path, monkeypatch,
                                                  capsys):
    from repro_torch.benchmarks import common

    monkeypatch.setenv("BENCH_ARTIFACT_DIR", str(tmp_path))
    common.emit_json("toy gradient/aca", {"rel_err": 5.2e-4, "steps": 13,
                                         "device": "cpu"})
    common.emit_json("toy gradient/aca", {"rel_err": 5.3e-4, "steps": 13,
                                         "device": "cpu"})
    assert [p.name for p in tmp_path.iterdir()] == \
        ["BENCH_toy_gradient_aca.json"]
    capsys.readouterr()
    res = _cli(["-m", "repro_torch.tools.check_bench_schema", str(tmp_path)])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "bench schema OK (1 artifact files)" in res.stdout


# ---------------------------------------------------------------------------
# check_docs


def _docs_fixture(tmp_path, section, head="# readme\n", tail=""):
    text = head + "## The PyTorch/CUDA port (`src/repro_torch/`)\n" \
        + textwrap.dedent(section) + tail
    (tmp_path / "README.md").write_text(text)
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "page.md").write_text("page\n")
    return tmp_path


def test_check_docs_passes_on_good_fixture(tmp_path, monkeypatch):
    _docs_fixture(
        tmp_path,
        """\
        [page](docs/page.md) and `repro_torch.core.odeint` live here.

        ```python
        from repro_torch.core import odeint
        x = 1 + 1
        ```
        """,
    )
    monkeypatch.setattr(check_docs, "ROOT", tmp_path)
    assert check_docs.check_section() == []
    assert check_docs.check_links() == []
    assert check_docs.check_snippets() == []
    assert check_docs.check_symbol_refs() == []


def test_check_docs_catches_broken_link(tmp_path, monkeypatch):
    _docs_fixture(tmp_path, "[gone](docs/missing.md)\n")
    monkeypatch.setattr(check_docs, "ROOT", tmp_path)
    errors = check_docs.check_links()
    assert errors and "broken link" in errors[0]
    assert "README.md:3" in errors[0]


def test_check_docs_catches_bad_snippet(tmp_path, monkeypatch):
    _docs_fixture(tmp_path,
                  "```python\nimport repro_torch\ndef f(:\n```\n")
    monkeypatch.setattr(check_docs, "ROOT", tmp_path)
    errors = check_docs.check_snippets()
    assert errors and "does not parse" in errors[0]


def test_check_docs_catches_dead_symbol_ref(tmp_path, monkeypatch):
    _docs_fixture(
        tmp_path,
        "see `repro_torch.core.odeint` (fine) and "
        "`repro_torch.core.not_a_symbol` (dead)\n",
    )
    monkeypatch.setattr(check_docs, "ROOT", tmp_path)
    errors = check_docs.check_symbol_refs()
    assert len(errors) == 1
    assert "repro_torch.core.not_a_symbol" in errors[0]
    assert "README.md:3" in errors[0]


def test_check_docs_reads_only_the_port_section(tmp_path, monkeypatch):
    # refs and links outside the section, and refs inside code fences,
    # are not the port checker's
    _docs_fixture(
        tmp_path,
        "```python\n# `repro_torch.core.not_a_symbol` in code\n```\n",
        head="# readme\n[gone](docs/missing.md) `repro_torch.nope`\n",
        tail="## Repo map\n`repro_torch.nope_either`\n",
    )
    monkeypatch.setattr(check_docs, "ROOT", tmp_path)
    assert check_docs.check_symbol_refs() == []
    assert check_docs.check_links() == []


def test_check_docs_cli_passes_on_repo():
    res = _cli(["-m", "repro_torch.tools.check_docs"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "port docs check OK" in res.stdout


# ---------------------------------------------------------------------------
# solver_lint CLI


def test_solver_lint_cli_fails_on_violation_and_baseline_suppresses(tmp_path):
    target = tmp_path / "core" / "api.py"
    target.parent.mkdir(parents=True)
    target.write_text('def f(grad_method="definitely_not_real"):\n    pass\n')

    res = _cli(["-m", "repro_torch.tools.solver_lint", str(target),
                "--baseline", "", "--root", str(tmp_path)])
    assert res.returncode == 1, res.stdout + res.stderr
    assert "registry-drift" in res.stdout
    assert "core/api.py:1" in res.stdout

    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps([{
        "rule": "registry-drift", "path": "core/api.py",
        "match": "definitely_not_real",
        "justification": "test fixture"}]))
    res = _cli(["-m", "repro_torch.tools.solver_lint", str(target),
                "--baseline", str(baseline), "--root", str(tmp_path)])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "1 suppressed" in res.stdout


def test_solver_lint_cli_each_rule_fails_on_an_injected_file(tmp_path):
    files = {
        "pkg/a.py": "assert 1\n",
        "core/stepper.py": "def f(z):\n    return z.item()\n",
        "pkg/b.py": "import torch.distributed as dist\ndist.barrier()\n",
        "core/api.py": 'def f(on_failure="explode"):\n    pass\n',
    }
    for rel, src in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    res = _cli(["-m", "repro_torch.tools.solver_lint", str(tmp_path),
                "--root", str(tmp_path)])
    assert res.returncode == 1, res.stdout + res.stderr
    for rule in ("bare-assert", "host-read", "collective-direct",
                 "registry-drift"):
        assert f"[{rule}]" in res.stdout, res.stdout
    assert "4 finding(s)" in res.stdout


def test_solver_lint_cli_refuses_an_unjustified_baseline(tmp_path):
    baseline = tmp_path / "baseline.json"
    baseline.write_text(json.dumps([{
        "rule": "bare-assert", "path": "x.py", "match": "assert",
        "justification": ""}]))
    res = _cli(["-m", "repro_torch.tools.solver_lint", "src/repro_torch",
                "--baseline", str(baseline)])
    assert res.returncode != 0
    assert "justification" in res.stderr


def test_solver_lint_cli_clean_on_port_src():
    res = _cli(["-m", "repro_torch.tools.solver_lint", "src/repro_torch",
                "--stale-baseline-check"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert "0 finding(s)" in res.stdout


# ---------------------------------------------------------------------------
# the analyzer CLI


def test_analyzer_cli_single_config(tmp_path):
    report = tmp_path / "report.txt"
    res = _cli(["-m", "repro_torch.analysis", "--configs", "naive-solo",
                "--device", "cpu", "--report", str(report), "--profile"])
    assert res.returncode == 0, res.stdout + res.stderr
    assert report.exists() and "0 finding(s)" in report.read_text()
    assert "residual naive-solo 0 bytes (budget None)" in res.stdout
    assert "reads naive-solo naive-trial@1=7it/0+1 outside=2 " \
        "collectives=0" in res.stdout


def test_analyzer_cli_lists_the_reference_matrix():
    from repro.analysis import config_names

    res = _cli(["-m", "repro_torch.analysis", "--list"])
    assert res.returncode == 0
    names = res.stdout.split()
    assert len(names) == 37
    assert names == config_names()
