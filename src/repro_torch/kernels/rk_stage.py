"""K1 and K2: the fused Runge-Kutta stage kernels and their plain versions.

* ``rk_stage_increment`` (K1): ``z + h * sum_j a_j k_j`` — the argument of
  each stage's field evaluation, and with the ``b`` row the solution
  combine of the ACA replay. Replaces
  ``repro/kernels/rk_stage.py::rk_stage_increment_pallas``.
* ``rk_stage_combine_err`` (K2): ``z_next = z + h * sum_i b_i k_i``,
  ``err = h * sum_i e_i k_i`` (returned only with ``with_err``) and the
  per-block partial sums of ``(err / (atol + rtol * max(|z|, |z_next|)))^2``.
  Replaces ``repro/kernels/rk_stage.py::rk_stage_combine_err_pallas``.

The CUDA source is ``csrc/rk_stage.cu``. Each wrapper takes the plain
PyTorch version for a tensor on the CPU only; for a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches per
wrapper. The plain versions accumulate in the Pallas body's order (zero
weights skipped, f32 accumulation, output in z's dtype), which the
kernels reproduce bit for bit; only the norm's summation order differs.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import build

MAX_STAGES = 7
THREADS = 256
# 8 resident blocks of 256 threads on each of the H100's 132 SMs; the
# grid-stride loop covers the rest. K2's partials buffer has one slot per
# block, so the grid depends on N alone and the norm is deterministic.
MAX_BLOCKS = 132 * 8

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_WIDTH = {torch.float32: 4, torch.bfloat16: 8}   # 16-byte vectors

launches = {"rk_stage_increment": 0, "rk_stage_combine_err": 0}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0


# ------------------------------------------------------------ plain versions

def increment_plain(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                    a: Sequence[float]) -> torch.Tensor:
    """z + h * sum_j a_j k_j over the first k.shape[0] weights of ``a``."""
    acc = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    for j, aj in enumerate(tuple(a)[: k.shape[0]]):
        if aj != 0.0:
            acc = acc + aj * k[j].float()
    return (z.float() + h * acc).to(z.dtype)


def combine_err_plain(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                      b: Sequence[float], e: Sequence[float], rtol: float,
                      atol: float, with_err: bool = True
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                 torch.Tensor]:
    """(z_next, err or None, (1,) sum of squared scaled errors)."""
    zf = z.float()
    acc = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    err = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    for i, (bi, ei) in enumerate(zip(b, e)):
        ki = k[i].float()
        if bi != 0.0:
            acc = acc + bi * ki
        if ei != 0.0:
            err = err + ei * ki
    zn = zf + h * acc
    err = h * err
    scale = atol + rtol * torch.maximum(zf.abs(), zn.abs())
    r = err / scale
    sq = torch.sum(r * r).reshape(1)
    return zn.to(z.dtype), (err if with_err else None), sq


# ------------------------------------------------------------------ wrappers

class _Row(ctypes.Structure):
    _fields_ = [("w", ctypes.c_float * MAX_STAGES), ("n", ctypes.c_int)]


def _row(weights: Sequence[float]) -> _Row:
    weights = tuple(weights)
    row = _Row()
    for j, w in enumerate(weights):
        row.w[j] = w
    row.n = len(weights)
    return row


_SIGNATURES = {
    "rk_stage_increment": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.POINTER(_Row), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p],
    "rk_stage_combine_err": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(_Row), ctypes.POINTER(_Row), ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
}


def _lib() -> ctypes.CDLL:
    lib = build.load("rk_stage")
    if not getattr(lib, "_repro_bound", False):
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.rk_error_string.argtypes = [ctypes.c_int]
        lib.rk_error_string.restype = ctypes.c_char_p
        lib.rk_threads_per_block.restype = ctypes.c_int
        lib.rk_max_stages.restype = ctypes.c_int
        if (lib.rk_threads_per_block() != THREADS
                or lib.rk_max_stages() != MAX_STAGES):
            raise RuntimeError(
                "rk_stage.cu and rk_stage.py disagree on the block size or "
                "the stage limit")
        lib._repro_bound = True
    return lib


def _check_launch(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {code} "
            f"({lib.rk_error_string(code).decode()})")


def _check_inputs(what: str, z: torch.Tensor, k: torch.Tensor,
                  h: torch.Tensor) -> None:
    if z.dim() != 1 or k.dim() != 2 or k.shape[1] != z.shape[0]:
        raise ValueError(
            f"{what}: expects z (N,) and k (s, N); got {tuple(z.shape)} and "
            f"{tuple(k.shape)}")
    if z.dtype not in _DTYPE_CODE or k.dtype != z.dtype:
        raise ValueError(
            f"{what}: z and k must share one dtype among float32/bfloat16; "
            f"got {z.dtype} and {k.dtype}")
    if k.shape[0] > MAX_STAGES:
        raise ValueError(
            f"{what}: at most {MAX_STAGES} stages; got {k.shape[0]}")
    if z.device != k.device or h.device != z.device:
        raise ValueError(
            f"{what}: z, k and h must lie on one device; got {z.device}, "
            f"{k.device}, {h.device}")
    if h.numel() != 1:
        raise ValueError(f"{what}: h must hold one value; got {tuple(h.shape)}")


def _on_card(what: str, z: torch.Tensor, k: torch.Tensor) -> None:
    if z.device.type != "cuda":
        raise ValueError(
            f"{what}: the kernel runs on a CUDA device and the plain "
            f"version on the CPU; got a tensor on {z.device}")
    if not (z.is_contiguous() and k.is_contiguous()):
        raise ValueError(f"{what}: z and k must be contiguous")


def _vectorized(n: int, dtype: torch.dtype, *tensors: torch.Tensor) -> bool:
    return n % _VEC_WIDTH[dtype] == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def grid_blocks(n: int, dtype: torch.dtype, vec: bool) -> int:
    """The kernels' grid for N elements (also K2's partials length)."""
    units = n // _VEC_WIDTH[dtype] if vec else n
    return max(1, min(-(-units // THREADS), MAX_BLOCKS))


def _h_device(h: torch.Tensor) -> torch.Tensor:
    return h.reshape(()).to(torch.float32).contiguous()


def rk_stage_increment(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                       a: Sequence[float]) -> torch.Tensor:
    """K1: z + h * sum_j a_j k_j with z (N,), k (j, N), h a one-element f32
    tensor on z's device, ``a`` the tableau row (only its first j weights
    are read)."""
    _check_inputs("rk_stage_increment", z, k, h)
    a = tuple(float(w) for w in tuple(a)[: k.shape[0]])
    if z.device.type == "cpu":
        return increment_plain(z, k, h, a)
    _on_card("rk_stage_increment", z, k)
    lib = _lib()
    n = z.shape[0]
    hd = _h_device(h)
    out = torch.empty_like(z)
    vec = _vectorized(n, z.dtype, z, k, out)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = lib.rk_stage_increment(
            z.data_ptr(), k.data_ptr(), hd.data_ptr(), out.data_ptr(), n,
            ctypes.byref(_row(a)), _DTYPE_CODE[z.dtype], int(vec),
            grid_blocks(n, z.dtype, vec), stream)
    _check_launch(lib, code, "rk_stage_increment")
    launches["rk_stage_increment"] += 1
    return out


def rk_stage_combine_err(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                         b: Sequence[float], e: Sequence[float], rtol: float,
                         atol: float, *, with_err: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    torch.Tensor]:
    """K2: (z_next (N,), err (N,) f32 or None, norm partials (n_blocks,)
    f32). Summing the partials and dividing by N gives ``error_ratio``
    squared."""
    _check_inputs("rk_stage_combine_err", z, k, h)
    b = tuple(float(w) for w in b)
    e = tuple(float(w) for w in e)
    if len(b) != k.shape[0] or len(e) != k.shape[0]:
        raise ValueError(
            f"rk_stage_combine_err: {k.shape[0]} stages but {len(b)} b and "
            f"{len(e)} e weights")
    if z.device.type == "cpu":
        return combine_err_plain(z, k, h, b, e, rtol, atol, with_err)
    _on_card("rk_stage_combine_err", z, k)
    lib = _lib()
    n = z.shape[0]
    hd = _h_device(h)
    zn = torch.empty_like(z)
    err = torch.empty(n, dtype=torch.float32, device=z.device) \
        if with_err else None
    tensors = (z, k, zn) + ((err,) if with_err else ())
    vec = _vectorized(n, z.dtype, *tensors)
    n_blocks = grid_blocks(n, z.dtype, vec)
    partials = torch.empty(n_blocks, dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = lib.rk_stage_combine_err(
            z.data_ptr(), k.data_ptr(), hd.data_ptr(), zn.data_ptr(),
            err.data_ptr() if with_err else None, partials.data_ptr(), n,
            ctypes.byref(_row(b)), ctypes.byref(_row(e)), rtol, atol,
            _DTYPE_CODE[z.dtype], int(vec), n_blocks, stream)
    _check_launch(lib, code, "rk_stage_combine_err")
    launches["rk_stage_combine_err"] += 1
    return zn, err, partials
