"""AST-level lint of the port's source: solver-stack rules grep can't state.

The counterpart of ``repro/analysis/ast_lint.py``, its four rules turned
to torch:

* ``bare-assert`` — ``assert`` used for validation: asserts vanish under
  ``python -O`` and give unnamed errors; user-reachable checks raise named
  ValueErrors. Internal invariants may be baselined with a justification.
* ``host-read`` (the reference's ``jit-host-leak``) — ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, or ``bool``/``float``/``int``
  of a computed value (an expression with a call, subscript or
  comparison, or a name its function bound to one earlier) in the engine
  files ``core/{integrate,stepper,controller,odeint_*}.py``: each
  reads a tensor on the host, a device sync on the card. Casts of
  parameters, attributes and constants (static settings) pass. The
  intentional reads of
  the trial loops are baselined site by site; the truth tests of tensors
  (``if accept:``, ``while live.any():``) have no call to see, and the
  ``host-sync`` run pass counts them.
* ``collective-direct`` (the reference's ``shard-map-direct``) — a
  ``torch.distributed`` collective called anywhere but
  ``distributed/{collectives,regions}.py``, where the sharded solve's and
  the sharded LM's collectives live and are counted.
* ``registry-drift`` — string literals in the port's ``core/api.py``
  (defaults, comparisons, fallback-ladder rungs, ``get_tableau`` calls)
  that no longer resolve against its live ``GRAD_METHODS`` /
  ``ON_FAILURE_POLICIES`` / tableau registry.
"""

from __future__ import annotations

import ast
import os
from typing import Iterable, List, Set

from .findings import Finding

#: files allowed to call torch.distributed collectives
COLLECTIVE_FILES = ("distributed/collectives.py", "distributed/regions.py")

#: torch.distributed functions that move data between ranks or wait on them
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_object",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "broadcast", "broadcast_object_list", "reduce",
    "gather", "gather_object", "scatter", "scatter_object_list", "send",
    "recv", "isend", "irecv", "batch_isend_irecv", "barrier",
    "monitored_barrier",
})

#: the solver modules whose host reads sync the card in the hot loops
ENGINE_FILE_SUFFIXES = tuple(
    f"core/{m}.py"
    for m in (
        "integrate",
        "stepper",
        "controller",
        "odeint_aca",
        "odeint_adjoint",
        "odeint_naive",
        "odeint_mali",
    )
)

#: Tensor methods that read a tensor on the host
HOST_READ_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: nodes that make an expression a computed value: bool/float/int of one
#: reads a tensor (of plain names, attributes and constants: a static cast)
_COMPUTED = (ast.Call, ast.Subscript, ast.Compare, ast.BoolOp)


def _computed(expr) -> bool:
    return any(isinstance(n, _COMPUTED) for n in ast.walk(expr))


def _bound_names(target) -> Set[str]:
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        return set().union(*(_bound_names(t) for t in target.elts))
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return set()


def _computed_names(func) -> List[tuple]:
    """(line, name) of every name ``func`` binds to a computed value."""
    out = []
    for node in ast.walk(func):
        if isinstance(node, ast.Assign) and _computed(node.value):
            for t in node.targets:
                out += [(node.lineno, n) for n in _bound_names(t)]
        elif (isinstance(node, (ast.AnnAssign, ast.AugAssign))
              and node.value is not None and _computed(node.value)):
            out += [(node.lineno, n) for n in _bound_names(node.target)]
    return out


def _cast_reads(tree) -> List[ast.Call]:
    """``bool``/``float``/``int`` calls of a computed value, or of a name
    the enclosing function bound to one on an earlier line."""
    out = []

    def visit(node, bound):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, _computed_names(child))
                continue
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Name)
                    and child.func.id in ("bool", "float", "int")
                    and child.args):
                arg = child.args[0]
                if _computed(arg) or (isinstance(arg, ast.Name) and any(
                        n == arg.id and line < child.lineno
                        for line, n in bound)):
                    out.append(child)
            visit(child, bound)

    visit(tree, [])
    return out


#: solver names dispatched at the api level rather than the tableau registry
NON_TABLEAU_SOLVERS = frozenset({"alf"})


def _rel(path: str, root: str) -> str:
    try:
        return os.path.relpath(path, root)
    except ValueError:
        return path


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _is_engine_file(path: str) -> bool:
    return _norm(path).endswith(ENGINE_FILE_SUFFIXES)


def _source_line(lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


# ---------------------------------------------------------------------------
# per-file rules


def _check_bare_assert(tree, rel, lines) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Assert):
            out.append(
                Finding(
                    rule="bare-assert",
                    path=rel,
                    line=node.lineno,
                    message=(
                        "bare assert: validation must raise a named "
                        "ValueError (asserts vanish under python -O); "
                        "baseline internal invariants with justification"
                    ),
                    snippet=_source_line(lines, node.lineno),
                )
            )
    return out


def _check_host_read(tree, rel, lines) -> List[Finding]:
    if not _is_engine_file(rel):
        return []
    out = []

    def hit(node, what):
        out.append(
            Finding(
                rule="host-read",
                path=rel,
                line=node.lineno,
                message=(
                    f"{what} in a solver engine module: a host read, a "
                    "device sync on the card; baseline intentional reads "
                    "with justification"
                ),
                snippet=_source_line(lines, node.lineno),
            )
        )

    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in HOST_READ_METHODS and not node.args):
            hit(node, f".{node.func.attr}() call")
    for node in _cast_reads(tree):
        hit(node, f"{node.func.id}() applied to a computed value")
    out.sort(key=lambda f: f.line)
    return out


def _dist_names(tree) -> Set[str]:
    """Names bound to ``torch.distributed`` (``import torch.distributed as
    dist``, ``from torch import distributed``) and ``torch`` itself."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    names.add(a.asname)
                elif a.name.split(".")[0] == "torch" and not a.asname:
                    names.add("torch")
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    names.add(a.asname or a.name)
    return names


def _check_collective_direct(tree, rel, lines) -> List[Finding]:
    if _norm(rel).endswith(COLLECTIVE_FILES):
        return []
    dist = _dist_names(tree)
    out = []

    def hit(node, what):
        out.append(
            Finding(
                rule="collective-direct",
                path=rel,
                line=node.lineno,
                message=(
                    f"{what}: call collectives only through "
                    "repro_torch.distributed.collectives / regions, where "
                    "they are counted and kept out of the trial loops"
                ),
                snippet=_source_line(lines, node.lineno),
            )
        )

    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "") \
                .startswith("torch.distributed"):
            for a in node.names:
                if a.name in COLLECTIVES:
                    hit(node, f"direct import of collective {a.name!r} from "
                              f"{node.module!r}")
        elif isinstance(node, ast.Call) and isinstance(node.func,
                                                       ast.Attribute):
            fn = node.func
            if fn.attr not in COLLECTIVES:
                continue
            base, dotted = fn.value, []
            while isinstance(base, ast.Attribute):
                dotted.append(base.attr)
                base = base.value
            if not isinstance(base, ast.Name) or base.id not in dist:
                continue
            chain = [base.id] + dotted[::-1]
            # dist.<collective> or torch.distributed.<collective>
            if chain == [base.id] and base.id != "torch" or \
                    chain == ["torch", "distributed"]:
                hit(node, f"direct collective call "
                          f"{'.'.join(chain + [fn.attr])}()")
    return out


def _collect_solver_strings(value) -> List[ast.Constant]:
    """Constant strings an assignment can bind to a registry-named variable
    (literal strings and conditional chains of them)."""
    if isinstance(value, ast.Constant) and isinstance(value.value, str):
        return [value]
    if isinstance(value, ast.IfExp):
        return _collect_solver_strings(value.body) + _collect_solver_strings(
            value.orelse
        )
    return []


def _check_registry_drift(tree, rel, lines) -> List[Finding]:
    if not _norm(rel).endswith("core/api.py"):
        return []
    from repro_torch.core.api import GRAD_METHODS, ON_FAILURE_POLICIES
    from repro_torch.core.tableaus import get_tableau

    def solver_ok(name: str) -> bool:
        if name in NON_TABLEAU_SOLVERS:
            return True
        try:
            get_tableau(name)
            return True
        except (KeyError, ValueError):
            return False

    checkers = {
        "solver": (solver_ok, "tableau registry (or 'alf')"),
        "grad_method": (lambda s: s in GRAD_METHODS, f"GRAD_METHODS={GRAD_METHODS}"),
        "on_failure": (
            lambda s: s in ON_FAILURE_POLICIES,
            f"ON_FAILURE_POLICIES={ON_FAILURE_POLICIES}",
        ),
    }

    out = []

    def check(node, key, value):
        ok, registry = checkers[key]
        if not ok(value):
            out.append(
                Finding(
                    rule="registry-drift",
                    path=rel,
                    line=node.lineno,
                    message=(
                        f"string {value!r} for {key!r} does not resolve "
                        f"against the live {registry}"
                    ),
                    snippet=_source_line(lines, node.lineno),
                )
            )

    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            # fallback-ladder rungs: {"solver": ..., "grad_method": ...}
            for k, v in zip(node.keys, node.values):
                if (
                    isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                    and k.value in checkers
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    check(v, k.value, v.value)
        elif isinstance(node, ast.Compare) and isinstance(node.left, ast.Name):
            key = node.left.id
            if key in checkers:
                for comp in node.comparators:
                    if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
                        check(comp, key, comp.value)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id in checkers:
                    for const in _collect_solver_strings(node.value):
                        check(const, target.id, const.value)
        elif isinstance(node, ast.Call):
            fn = node.func
            fname = fn.id if isinstance(fn, ast.Name) else getattr(fn, "attr", "")
            if fname == "get_tableau" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    check(arg, "solver", arg.value)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # keyword defaults like solver="dopri5", grad_method="aca"
            a = node.args
            pos = a.posonlyargs + a.args
            for arg, default in zip(pos[len(pos) - len(a.defaults) :], a.defaults):
                if (
                    arg.arg in checkers
                    and isinstance(default, ast.Constant)
                    and isinstance(default.value, str)
                ):
                    check(default, arg.arg, default.value)
            for arg, default in zip(a.kwonlyargs, a.kw_defaults):
                if (
                    default is not None
                    and arg.arg in checkers
                    and isinstance(default, ast.Constant)
                    and isinstance(default.value, str)
                ):
                    check(default, arg.arg, default.value)
    return out


RULES = (
    _check_bare_assert,
    _check_host_read,
    _check_collective_direct,
    _check_registry_drift,
)


def lint_file(path: str, root: str = ".") -> List[Finding]:
    rel = _norm(_rel(path, root))
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [
            Finding(
                rule="syntax",
                path=rel,
                line=exc.lineno or 0,
                message=f"file does not parse: {exc.msg}",
                snippet="",
            )
        ]
    lines = source.splitlines()
    findings: List[Finding] = []
    for rule in RULES:
        findings += rule(tree, rel, lines)
    return findings


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted list of .py files."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in filenames:
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        elif p.endswith(".py"):
            out.append(p)
    return sorted(out)


def lint_paths(paths: Iterable[str], root: str = ".") -> List[Finding]:
    findings: List[Finding] = []
    for path in iter_python_files(paths):
        findings += lint_file(path, root)
    return findings
