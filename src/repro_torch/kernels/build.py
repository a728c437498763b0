"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds), under
``build/repro_torch/`` at the repository root — a directory that
``.gitignore`` lists. The library's file name carries a hash of its
source and flags, so an edited source builds anew and an unchanged one
loads the library already built. A failed build raises ``RuntimeError``
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in the log
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    """One compiled source: where it went and what the compiler said."""
    name: str
    path: Path
    seconds: float        # nvcc wall time; 0.0 when loaded from an earlier build
    log: str              # nvcc's and ptxas's output ("" when loaded)
    built: bool


_LOADED: Dict[str, Tuple[ctypes.CDLL, BuildInfo]] = {}


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, on PATH and in "
        "/usr/local/cuda/bin): the port's CUDA kernels need the CUDA "
        "toolkit to build")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise RuntimeError(f"no CUDA source {src}")
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


def _start(nvcc: str, src: Path, out: Path):
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so.tmp",
                               dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def build_all(names: Iterable[str] = None) -> List[BuildInfo]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no current library yet, all ``nvcc`` processes started together, and
    load each. Returns one ``BuildInfo`` per source."""
    names = sorted(p.stem for p in CSRC_DIR.glob("*.cu")) \
        if names is None else list(names)
    todo = []
    for name in names:
        src, out = _target(name)
        if name not in _LOADED and not out.is_file():
            todo.append((name, src, out))
    built = {}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        running = [(name, out, *_start(nvcc, src, out))
                   for name, src, out in todo]
        failed = []
        for name, out, proc, tmp, cmd in running:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"$ {' '.join(cmd)}\n{log}")
                if os.path.exists(tmp):
                    os.unlink(tmp)
                continue
            os.replace(tmp, out)
            built[name] = (time.perf_counter() - t0, log)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for name in names:
        if name not in _LOADED:
            _, out = _target(name)
            seconds, log = built.get(name, (0.0, ""))
            info = BuildInfo(name=name, path=out, seconds=seconds, log=log,
                             built=name in built)
            _LOADED[name] = (ctypes.CDLL(str(out)), info)
    return [_LOADED[name][1] for name in names]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LOADED:
        build_all([name])
    return _LOADED[name][0]
