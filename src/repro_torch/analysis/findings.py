"""Findings, reports, and the baseline/suppression mechanism for the port's
solver-lint.

The port's copy of ``repro/analysis/findings.py`` (the port imports nothing
of the reference). Every analysis rule (the run passes of
``analysis/rules.py`` and the AST passes of ``analysis/ast_lint.py``) emits
:class:`Finding` records with file:line provenance.  A findings report is
just a sorted list of findings rendered one-per-line; CI fails on any
finding that is not matched by an entry in the baseline file.

Baseline entries suppress *intentional* exceptions and must carry a written
justification.  Matching is by (rule, path-suffix, source-substring) rather
than line number so the baseline survives unrelated edits to the file.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Iterable, Sequence


@dataclass(frozen=True)
class Finding:
    """One rule violation with provenance.

    ``path`` is repo-relative when the rule can produce one (AST rules),
    or the file of the op's innermost frame for the run passes
    (``repro_torch/...`` inside the package).  ``line`` is 1-indexed;
    0 means "no line available" (e.g. a whole-config budget violation).
    ``snippet`` is the stripped source line (or a symbolic description for
    run findings) used for baseline matching.
    """

    rule: str
    path: str
    line: int
    message: str
    snippet: str = ""

    def render(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    match: str
    justification: str

    def covers(self, f: Finding) -> bool:
        if f.rule != self.rule:
            return False
        if not f.path.endswith(self.path):
            return False
        hay = f.snippet or f.message
        return self.match in hay


@dataclass
class Report:
    """Accumulated findings plus the baseline that filters them."""

    findings: list[Finding] = field(default_factory=list)
    baseline: Sequence[BaselineEntry] = ()

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Iterable[Finding]) -> None:
        self.findings.extend(findings)

    def active(self) -> list[Finding]:
        """Findings not covered by any baseline entry."""
        out = []
        for f in self.findings:
            if not any(b.covers(f) for b in self.baseline):
                out.append(f)
        return out

    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if any(b.covers(f) for b in self.baseline)]

    def stale_baseline(self) -> list[BaselineEntry]:
        """Baseline entries that no longer match any finding (candidates for removal)."""
        return [b for b in self.baseline if not any(b.covers(f) for f in self.findings)]

    def render(self, *, verbose: bool = False) -> str:
        lines = []
        act = sorted(self.active(), key=lambda f: (f.path, f.line, f.rule))
        for f in act:
            lines.append(f.render())
        sup = self.suppressed()
        if verbose:
            for f in sorted(sup, key=lambda f: (f.path, f.line, f.rule)):
                lines.append(f"suppressed {f.render()}")
        lines.append(
            f"solver-lint: {len(act)} finding(s), {len(sup)} suppressed by baseline"
        )
        return "\n".join(lines)

    @property
    def ok(self) -> bool:
        return not self.active()


def load_baseline(path: str) -> list[BaselineEntry]:
    """Load the baseline/suppression file (JSON list of entries).

    Each entry must provide ``rule``, ``path``, ``match``, and a non-empty
    ``justification`` — suppressions without a written justification are a
    hard error so the baseline can't silently accrete.
    """
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    if not isinstance(raw, list):
        raise ValueError(f"baseline file {path!r} must be a JSON list of entries")
    entries = []
    for i, item in enumerate(raw):
        if not isinstance(item, dict):
            raise ValueError(f"baseline entry {i} in {path!r} is not an object")
        missing = {"rule", "path", "match", "justification"} - set(item)
        if missing:
            raise ValueError(
                f"baseline entry {i} in {path!r} missing keys: {sorted(missing)}"
            )
        if not str(item["justification"]).strip():
            raise ValueError(
                f"baseline entry {i} in {path!r} has an empty justification; "
                "every suppression must say why it is intentional"
            )
        entries.append(
            BaselineEntry(
                rule=str(item["rule"]),
                path=str(item["path"]),
                match=str(item["match"]),
                justification=str(item["justification"]),
            )
        )
    return entries
