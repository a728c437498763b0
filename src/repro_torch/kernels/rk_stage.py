"""K1-K5: the fused Runge-Kutta stage kernels and their plain versions.

* ``rk_stage_increment`` (K1): ``z + h * sum_j a_j k_j`` — the argument of
  each stage's field evaluation, and with the ``b`` row the solution
  combine of the ACA replay. Replaces
  ``repro/kernels/rk_stage.py::rk_stage_increment_pallas``.
* ``rk_stage_combine_err`` (K2): ``z_next = z + h * sum_i b_i k_i``,
  ``err = h * sum_i e_i k_i`` (returned only with ``with_err``) and the
  per-block partial sums of ``(err / (atol + rtol * max(|z|, |z_next|)))^2``.
  Replaces ``repro/kernels/rk_stage.py::rk_stage_combine_err_pallas``.
* ``rk_stage_increment_batched`` (K3): K1 on each row of a (B, N) state
  with the row's own stepsize h (B,); k is (j, B, N). A row with h = 0
  passes through. Replaces ``rk_stage_increment_batched_pallas``.
* ``rk_stage_combine_err_batched`` (K4): K2 per row, without the err
  store, with per-row norm partials (B, P) and scalar tolerances.
  Replaces ``rk_stage_combine_err_batched_pallas``.
* ``rk_stage_combine_err_batched_rowtol`` (K5): K4 with (B,) tolerances
  read per row; a row at K4's tolerance gives K4's bits. Replaces
  ``rk_stage_combine_err_batched_rowtol_pallas``.

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
# the batched kernels' rows are the grid's y dimension
MAX_ROWS = 65535

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_WIDTH = {torch.float32: 4, torch.bfloat16: 8}   # 16-byte vectors

launches = {"rk_stage_increment": 0, "rk_stage_combine_err": 0,
            "rk_stage_increment_batched": 0,
            "rk_stage_combine_err_batched": 0,
            "rk_stage_combine_err_batched_rowtol": 0}


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


def increment_batched_plain(z: torch.Tensor, k: torch.Tensor,
                            h: torch.Tensor,
                            a: Sequence[float]) -> torch.Tensor:
    """Per row b: z_b + h_b * sum_j a_j k_{j,b}; z (B, N), k (j, B, N),
    h (B,)."""
    acc = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    for j, aj in enumerate(tuple(a)[: k.shape[0]]):
        if aj != 0.0:
            acc = acc + aj * k[j].float()
    return (z.float() + h.float()[:, None] * acc).to(z.dtype)


def combine_err_batched_plain(z: torch.Tensor, k: torch.Tensor,
                              h: torch.Tensor, b: Sequence[float],
                              e: Sequence[float], rtol, atol
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(z_next (B, N), (B,) per-row sums of squared scaled errors).

    ``rtol``/``atol`` are floats (K4) or (B,) tensors (K5): a row's
    tolerance enters its scale exactly as the float does, so a row at
    tolerance τ gives the bits of the all-τ scalar form.
    """
    zf = z.float()
    acc = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    err = torch.zeros(z.shape, dtype=torch.float32, device=z.device)
    for i, (bi, ei) in enumerate(zip(b, e)):
        ki = k[i].float()
        if bi != 0.0:
            acc = acc + bi * ki
        if ei != 0.0:
            err = err + ei * ki
    hv = h.float()[:, None]
    zn = zf + hv * acc
    err = hv * err
    if isinstance(rtol, torch.Tensor):
        rtol = rtol.float()[:, None]
    if isinstance(atol, torch.Tensor):
        atol = atol.float()[:, None]
    scale = atol + rtol * torch.maximum(zf.abs(), zn.abs())
    r = err / scale
    return zn.to(z.dtype), torch.sum(r * r, dim=-1)


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
    "rk_stage_increment_batched": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.POINTER(_Row),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    "rk_stage_combine_err_batched": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(_Row), ctypes.POINTER(_Row), ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "rk_stage_combine_err_batched_rowtol": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(_Row), ctypes.POINTER(_Row), ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
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
        lib.rk_max_rows.restype = ctypes.c_int
        if (lib.rk_threads_per_block() != THREADS
                or lib.rk_max_stages() != MAX_STAGES
                or lib.rk_max_rows() != MAX_ROWS):
            raise RuntimeError(
                "rk_stage.cu and rk_stage.py disagree on the block size, "
                "the stage limit or the row limit")
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


# ------------------------------------------------------ batched wrappers

def _check_batched(what: str, z: torch.Tensor, k: torch.Tensor,
                   h: torch.Tensor) -> None:
    if z.dim() != 2 or k.dim() != 3 or tuple(k.shape[1:]) != tuple(z.shape):
        raise ValueError(
            f"{what}: expects z (B, N) and k (s, B, N); got "
            f"{tuple(z.shape)} and {tuple(k.shape)}")
    if z.dtype not in _DTYPE_CODE or k.dtype != z.dtype:
        raise ValueError(
            f"{what}: z and k must share one dtype among float32/bfloat16; "
            f"got {z.dtype} and {k.dtype}")
    if k.shape[0] > MAX_STAGES:
        raise ValueError(
            f"{what}: at most {MAX_STAGES} stages; got {k.shape[0]}")
    if not 1 <= z.shape[0] <= MAX_ROWS:
        raise ValueError(
            f"{what}: between 1 and {MAX_ROWS} rows; got {z.shape[0]}")
    if z.device != k.device or h.device != z.device:
        raise ValueError(
            f"{what}: z, k and h must lie on one device; got {z.device}, "
            f"{k.device}, {h.device}")
    if tuple(h.shape) != (z.shape[0],):
        raise ValueError(
            f"{what}: h must hold one stepsize per row, shape "
            f"({z.shape[0]},); got {tuple(h.shape)}")


def _rows_device(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous()


def rk_stage_increment_batched(z: torch.Tensor, k: torch.Tensor,
                               h: torch.Tensor,
                               a: Sequence[float]) -> torch.Tensor:
    """K3: per row b, z_b + h_b * sum_j a_j k_{j,b} with z (B, N), k (j, B,
    N), h (B,) on z's device, ``a`` the tableau row (its first j weights
    are read). A row with h_b = 0 returns z_b."""
    _check_batched("rk_stage_increment_batched", z, k, h)
    a = tuple(float(w) for w in tuple(a)[: k.shape[0]])
    if z.device.type == "cpu":
        return increment_batched_plain(z, k, h, a)
    _on_card("rk_stage_increment_batched", z, k)
    lib = _lib()
    rows, n = z.shape
    hd = _rows_device(h)
    out = torch.empty_like(z)
    vec = _vectorized(n, z.dtype, z, k, out)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        code = lib.rk_stage_increment_batched(
            z.data_ptr(), k.data_ptr(), hd.data_ptr(), out.data_ptr(), n,
            rows, ctypes.byref(_row(a)), _DTYPE_CODE[z.dtype], int(vec),
            grid_blocks(n, z.dtype, vec), stream)
    _check_launch(lib, code, "rk_stage_increment_batched")
    launches["rk_stage_increment_batched"] += 1
    return out


def _combine_err_batched(what: str, z, k, h, b, e, rtol, atol, row_tol):
    _check_batched(what, z, k, h)
    b = tuple(float(w) for w in b)
    e = tuple(float(w) for w in e)
    if len(b) != k.shape[0] or len(e) != k.shape[0]:
        raise ValueError(
            f"{what}: {k.shape[0]} stages but {len(b)} b and {len(e)} e "
            "weights")
    if row_tol:
        for name, tol in (("rtol", rtol), ("atol", atol)):
            if not (isinstance(tol, torch.Tensor)
                    and tuple(tol.shape) == (z.shape[0],)
                    and tol.device == z.device):
                raise ValueError(
                    f"{what}: {name} must be a ({z.shape[0]},) tensor on "
                    f"{z.device}")
    if z.device.type == "cpu":
        zn, sq = combine_err_batched_plain(z, k, h, b, e, rtol, atol)
        return zn, sq[:, None]
    _on_card(what, z, k)
    lib = _lib()
    rows, n = z.shape
    hd = _rows_device(h)
    zn = torch.empty_like(z)
    vec = _vectorized(n, z.dtype, z, k, zn)
    n_blocks = grid_blocks(n, z.dtype, vec)
    partials = torch.empty((rows, n_blocks), dtype=torch.float32,
                           device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        common = (z.data_ptr(), k.data_ptr(), hd.data_ptr(), zn.data_ptr(),
                  partials.data_ptr(), n, rows, ctypes.byref(_row(b)),
                  ctypes.byref(_row(e)))
        tail = (_DTYPE_CODE[z.dtype], int(vec), n_blocks, stream)
        if row_tol:
            rt, at = _rows_device(rtol), _rows_device(atol)
            code = lib.rk_stage_combine_err_batched_rowtol(
                *common, rt.data_ptr(), at.data_ptr(), *tail)
        else:
            code = lib.rk_stage_combine_err_batched(
                *common, rtol, atol, *tail)
    _check_launch(lib, code, what)
    launches[what] += 1
    return zn, partials


def rk_stage_combine_err_batched(z: torch.Tensor, k: torch.Tensor,
                                 h: torch.Tensor, b: Sequence[float],
                                 e: Sequence[float], rtol: float,
                                 atol: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: (z_next (B, N), norm partials (B, P) f32) with scalar rtol and
    atol. Summing a row's partials and dividing by N gives that row's
    ``error_ratio`` squared."""
    return _combine_err_batched("rk_stage_combine_err_batched", z, k, h, b,
                                e, float(rtol), float(atol), False)


def rk_stage_combine_err_batched_rowtol(z: torch.Tensor, k: torch.Tensor,
                                        h: torch.Tensor, b: Sequence[float],
                                        e: Sequence[float],
                                        rtol: torch.Tensor,
                                        atol: torch.Tensor
                                        ) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """K5: K4 with (B,) tolerance tensors on z's device, one per row."""
    return _combine_err_batched("rk_stage_combine_err_batched_rowtol", z, k,
                                h, b, e, rtol, atol, True)
