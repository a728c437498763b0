"""Docs health check of the port: the README's port section.

The counterpart of ``tools/check_docs.py``, over the part of ``README.md``
under the heading ``## The PyTorch/CUDA port`` (down to the next ``## ``
heading). Four gates:

1. every relative link resolves to an existing file (anchors stripped;
   http(s)/mailto links skipped);
2. every fenced ```python block that imports ``repro_torch`` parses
   (``compile()`` only — no execution);
3. every public symbol of ``repro_torch.core`` (its ``__all__``) has a
   real docstring (a dataclass's or NamedTuple's generated
   ``Name(field, ...)`` does not count);
4. every backticked ``repro_torch.*`` dotted reference outside code fences
   resolves against the live package (import the module prefix, getattr
   the rest).

Exits non-zero with one line per violation::

    PYTHONPATH=src python -m repro_torch.tools.check_docs
"""

from __future__ import annotations

import importlib
import inspect
import pathlib
import re
import sys

ROOT = pathlib.Path(__file__).resolve().parents[3]
SECTION = "## The PyTorch/CUDA port"

_LINK = re.compile(r"\[[^\]]*\]\(([^)\s]+)\)")
_SKIP = ("http://", "https://", "mailto:")
_PY_FENCE = re.compile(r"^```python[^\n]*\n(.*?)^```", re.M | re.S)
_IMPORTS_PORT = re.compile(r"^\s*(from|import)\s+repro_torch\b", re.M)
_PORT_REF = re.compile(
    r"`(repro_torch(?:\.[A-Za-z_][A-Za-z0-9_]*)+)(?:\(\))?`")
_FENCE_LINE = re.compile(r"^\s*```")


def port_section():
    """(README path, the section's text, the line number it starts at);
    the text is empty when the README or the heading is missing."""
    readme = ROOT / "README.md"
    if not readme.exists():
        return readme, "", 0
    lines = readme.read_text().splitlines(keepends=True)
    start = next((i for i, ln in enumerate(lines)
                  if ln.startswith(SECTION)), None)
    if start is None:
        return readme, "", 0
    end = next((i for i in range(start + 1, len(lines))
                if lines[i].startswith("## ")), len(lines))
    return readme, "".join(lines[start:end]), start + 1


def _where(readme: pathlib.Path) -> str:
    try:
        return str(readme.relative_to(ROOT))
    except ValueError:
        return str(readme)


def check_section() -> list:
    readme, text, _ = port_section()
    if not readme.exists():
        return [f"{_where(readme)}: file missing"]
    if not text:
        return [f"{_where(readme)}: no '{SECTION}' section"]
    return []


def check_links() -> list:
    readme, text, first = port_section()
    errors = []
    for m in _LINK.finditer(text):
        target = m.group(1)
        if target.startswith(_SKIP) or target.startswith("#"):
            continue
        path = target.split("#", 1)[0]
        if not (readme.parent / path).resolve().exists():
            line = first + text.count("\n", 0, m.start())
            errors.append(f"{_where(readme)}:{line}: broken link -> {target}")
    return errors


def check_snippets() -> list:
    """Syntax-check every fenced ```python block that imports
    ``repro_torch`` (compile only)."""
    readme, text, first = port_section()
    errors = []
    for m in _PY_FENCE.finditer(text):
        code = m.group(1)
        if not _IMPORTS_PORT.search(code):
            continue
        lineno = first + text.count("\n", 0, m.start()) + 1
        where = f"{_where(readme)}:{lineno}"
        try:
            compile(code, where, "exec")
        except SyntaxError as e:
            errors.append(f"{where}: python snippet does not parse "
                          f"(line {e.lineno} of block: {e.msg})")
    return errors


def _is_auto_doc(obj) -> bool:
    doc = obj.__doc__ or ""
    name = getattr(obj, "__name__", "")
    return doc.strip().startswith(f"{name}(")


def check_docstrings() -> list:
    core = importlib.import_module("repro_torch.core")
    errors = []
    for sym in core.__all__:
        obj = getattr(core, sym, None)
        if obj is None:
            errors.append(f"repro_torch.core.{sym}: exported but missing")
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)
                or inspect.ismodule(obj)):
            continue  # plain data (tuples of names etc.)
        doc = inspect.getdoc(obj)
        if not doc or not doc.strip() or _is_auto_doc(obj):
            errors.append(f"repro_torch.core.{sym}: missing docstring")
    return errors


def _resolves(dotted: str) -> bool:
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        try:
            for attr in parts[i:]:
                obj = getattr(obj, attr)
        except AttributeError:
            return False
        return True
    return False


def check_symbol_refs() -> list:
    """Resolve every backticked ``repro_torch.*`` reference outside code
    fences."""
    readme, text, first = port_section()
    errors, checked = [], {}
    in_fence = False
    for k, line in enumerate(text.splitlines()):
        if _FENCE_LINE.match(line):
            in_fence = not in_fence
            continue
        if in_fence:
            continue
        for m in _PORT_REF.finditer(line):
            dotted = m.group(1)
            if dotted not in checked:
                checked[dotted] = _resolves(dotted)
            if not checked[dotted]:
                errors.append(
                    f"{_where(readme)}:{first + k}: `{dotted}` does not "
                    "resolve against the live repro_torch package")
    return errors


def main(argv=None) -> int:
    errors = check_section()
    if not errors:
        errors = (check_links() + check_snippets() + check_docstrings()
                  + check_symbol_refs())
    for e in errors:
        print(f"FAIL {e}")
    if errors:
        return 1
    print("port docs check OK (links + python snippets + public docstrings "
          "+ repro_torch.* symbol refs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
