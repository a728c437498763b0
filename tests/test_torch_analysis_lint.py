"""The port's AST lint (``repro_torch.analysis.ast_lint``) against
``tests/test_analysis_lint.py``: every rule catches an injected violation
with file:line provenance, the baseline mechanism round-trips, the port's
source is clean under the port's own baseline, and a host read added to
``adaptive_while_solve``'s trial loop is caught."""

import json
import pathlib
import textwrap

import pytest

from repro_torch.analysis import (
    BASELINE_PATH,
    BaselineEntry,
    Finding,
    Report,
    lint_file,
    lint_paths,
    load_baseline,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _lint_snippet(tmp_path, rel, source):
    """Write ``source`` at tmp_path/rel and lint it with repo-relative paths."""
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return lint_file(str(path), root=str(tmp_path))


# ---------------------------------------------------------------------------
# rule injections


def test_bare_assert_caught_with_provenance(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "pkg/mod.py",
        """\
        def f(x):
            y = x + 1
            assert y > 0, "bad"
            return y
        """,
    )
    byrule = [f for f in findings if f.rule == "bare-assert"]
    assert len(byrule) == 1
    assert byrule[0].path == "pkg/mod.py"
    assert byrule[0].line == 3
    assert byrule[0].snippet == 'assert y > 0, "bad"'


def test_collective_direct_import_caught(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "pkg/bad_import.py",
        """\
        from torch.distributed import all_reduce

        def f(x):
            return all_reduce(x)
        """,
    )
    hits = [f for f in findings if f.rule == "collective-direct"]
    assert len(hits) == 1 and hits[0].line == 1


def test_collective_direct_attribute_caught(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "pkg/bad_attr.py",
        """\
        import torch
        import torch.distributed as dist

        def f(x):
            y = torch.gather(x, 0, x.long())     # a tensor op, not a collective
            dist.all_reduce(y)
            torch.distributed.broadcast(y, 0)
            return y
        """,
    )
    hits = sorted(f.line for f in findings if f.rule == "collective-direct")
    assert hits == [6, 7]


def test_collective_allowed_in_collectives_module(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "distributed/collectives.py",
        """\
        import torch.distributed as dist

        def g(x):
            dist.all_gather([x], x)
        """,
    )
    assert not [f for f in findings if f.rule == "collective-direct"]


def test_host_read_caught(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "core/integrate.py",
        """\
        def step(z, live):
            n = int(z.sum())
            s = z.max().item()
            m = z.tolist()
            while bool(live.any() & (z[0] > 0)):
                pass
            return n, s, m
        """,
    )
    hits = sorted(f.line for f in findings if f.rule == "host-read")
    assert hits == [2, 3, 4, 5]


def test_host_read_ignores_non_engine_files(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "data/loader.py",
        """\
        def load(x):
            return x.sum().item()
        """,
    )
    assert not [f for f in findings if f.rule == "host-read"]


def test_host_read_allows_static_casts(tmp_path):
    # float()/int() of names and constant arithmetic are static parameters
    findings = _lint_snippet(
        tmp_path,
        "core/stepper.py",
        """\
        def order_scale(order, max_steps):
            return float(order), int(-(-max_steps ** 0.5 // 1)), float(2 ** 31)
        """,
    )
    assert not [f for f in findings if f.rule == "host-read"]


def test_host_read_follows_names_bound_to_computed_values(tmp_path):
    # int(n_max) reads n.max() as surely as int(n.max()) does; a name
    # rebound from a parameter on the cast's own line stays static
    findings = _lint_snippet(
        tmp_path,
        "core/odeint_aca.py",
        """\
        def sweep(n, code, steps):
            n_max = n.max()
            live, (first, *rest) = n > 0, n.sort()
            code = int(code)
            return int(n_max), bool(live), float(first), int(steps), code
        """,
    )
    hits = [(f.line, f.snippet) for f in findings if f.rule == "host-read"]
    assert [line for line, _ in hits] == [5, 5, 5], hits


def test_registry_drift_caught(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "core/api.py",
        """\
        def solve(grad_method="aca", on_failure="explode"):
            if grad_method == "bogus_method":
                pass
            ladder = [{"solver": "nope5", "grad_method": "aca"}]
            solver = "alf" if grad_method == "mali" else "dopri5"
            return ladder
        """,
    )
    lines = sorted(f.line for f in findings if f.rule == "registry-drift")
    assert lines == [1, 2, 4]  # bad on_failure default, bad compare, bad rung


def test_registry_drift_accepts_live_names(tmp_path):
    findings = _lint_snippet(
        tmp_path,
        "core/api.py",
        """\
        def solve(solver="dopri5", grad_method="mali", on_failure="warn"):
            solver = "alf" if grad_method == "mali" else "rk4"
            return get_tableau("bosh3")
        """,
    )
    assert not [f for f in findings if f.rule == "registry-drift"]


# ---------------------------------------------------------------------------
# baseline mechanics


def test_baseline_requires_justification(tmp_path):
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps(
        [{"rule": "bare-assert", "path": "x.py", "match": "assert",
          "justification": "  "}]))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(str(bad))


def test_baseline_requires_all_keys(tmp_path):
    bad = tmp_path / "baseline.json"
    bad.write_text(json.dumps([{"rule": "bare-assert"}]))
    with pytest.raises(ValueError, match="missing keys"):
        load_baseline(str(bad))


def test_baseline_covers_by_rule_path_and_snippet():
    entry = BaselineEntry(
        rule="host-read", path="repro_torch/core/odeint_aca.py",
        match="n_host = ck.n.tolist()", justification="one read a sweep")
    f = Finding(rule="host-read", path="src/repro_torch/core/odeint_aca.py",
                line=381, message="m", snippet="n_host = ck.n.tolist()")
    assert entry.covers(f)
    # different rule, different file, or different snippet -> not covered
    assert not entry.covers(Finding(rule="bare-assert", path=f.path,
                                    line=1, message="m", snippet=f.snippet))
    assert not entry.covers(Finding(rule="host-read",
                                    path="src/repro/core/odeint_aca.py",
                                    line=1, message="m", snippet=f.snippet))
    assert not entry.covers(Finding(rule="host-read", path=f.path,
                                    line=1, message="m", snippet="x.tolist()"))


def test_report_active_suppressed_and_stale():
    entries = [
        BaselineEntry(rule="r", path="a.py", match="x", justification="j"),
        BaselineEntry(rule="r", path="gone.py", match="y", justification="j"),
    ]
    rep = Report(baseline=entries)
    rep.add(Finding(rule="r", path="a.py", line=1, message="m", snippet="x"))
    rep.add(Finding(rule="r", path="b.py", line=2, message="m", snippet="z"))
    assert [f.path for f in rep.active()] == ["b.py"]
    assert [f.path for f in rep.suppressed()] == ["a.py"]
    assert [e.path for e in rep.stale_baseline()] == ["gone.py"]
    assert not rep.ok
    assert "1 finding(s), 1 suppressed" in rep.render()


# ---------------------------------------------------------------------------
# the port at HEAD is clean under its own baseline


def test_port_is_clean_under_its_baseline():
    baseline = load_baseline(BASELINE_PATH)
    assert all(b.justification.strip() for b in baseline)
    report = Report(baseline=baseline)
    report.extend(lint_paths([str(PORT)], root=str(REPO)))
    assert report.active() == [], report.render()
    # and the baseline carries no dead entries
    assert report.stale_baseline() == []


def test_host_read_added_to_the_trial_loop_fails_the_lint(tmp_path):
    # a patched copy of core/integrate.py with one more read in
    # adaptive_while_solve's trial loop: one active host-read finding at
    # that line, under the port's baseline
    src = (PORT / "core" / "integrate.py").read_text()
    anchor = "        cost_hooks.trial(carry=(t, z, h))\n"
    assert src.count(anchor) == 2
    patched = src.replace(anchor, anchor + "        _ = float(h.sum())\n", 1)
    path = tmp_path / "repro_torch" / "core" / "integrate.py"
    path.parent.mkdir(parents=True)
    path.write_text(patched)
    report = Report(baseline=load_baseline(BASELINE_PATH))
    report.extend(lint_file(str(path), root=str(tmp_path)))
    active = report.active()
    line = patched.splitlines().index("        _ = float(h.sum())") + 1
    assert [(f.rule, f.line) for f in active] == [("host-read", line)]
