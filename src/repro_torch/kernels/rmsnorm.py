"""K7: RMSNorm on the card, with its plain version.

``rmsnorm`` replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas``:
``y = x * rsqrt(mean(x^2) + eps) * w`` over the last axis of x (..., D),
f32 statistics, output in x's dtype, the (D,) weight in its own dtype.
The CUDA source is ``csrc/rmsnorm.cu``. For a tensor on the CPU the
wrapper takes the plain version, ``models.common.rmsnorm`` (the reference
oracle ``rmsnorm_ref`` is the reference model's own ``rmsnorm``); for a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches, and ``variant_launches`` the launches of each of its two CUDA
kernels (``kernel_for`` picks one: the one-pass kernel for rows that fit
in registers, the two-pass kernel otherwise). ``noop`` launches an empty
kernel on the same route, whose time is the least any launch takes.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.models.common import rmsnorm as rmsnorm_plain

from . import build

THREADS = 256           # two-pass kernel
VPT = 2                 # 16-byte vectors per thread, one-pass kernel
MAX_THREADS = 1024      # one-pass kernel: one block of at most this per row
KERNELS = ("one_pass", "two_pass")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kernel codes of rmsnorm_forward
_TWO_PASS_SCALAR, _TWO_PASS_VEC, _ONE_PASS = 0, 1, 2

launches = {"rmsnorm": 0}
variant_launches = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    launches["rmsnorm"] = 0
    for k in KERNELS:
        variant_launches[k] = 0


def one_pass_max_d(itemsize: int) -> int:
    """The widest row the one-pass kernel holds in registers: MAX_THREADS
    threads of VPT 16-byte vectors (16384 bf16, 8192 f32)."""
    return MAX_THREADS * VPT * (16 // itemsize)


def kernel_for(d: int, itemsize: int, aligned: bool) -> str:
    """K7's kernel for rows of d elements of itemsize bytes: "one_pass"
    where D is a whole number of 16-byte vectors, x, w and y are 16-byte
    aligned (``aligned``) and the row fits one_pass_max_d, at any number
    of rows (timed faster than the two-pass kernel at the prefill rows
    too); "two_pass" otherwise."""
    if aligned and (d * itemsize) % 16 == 0 \
            and d <= one_pass_max_d(itemsize):
        return "one_pass"
    return "two_pass"


def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if not getattr(lib, "_repro_bound", False):
        lib.rmsnorm_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.rmsnorm_forward.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        lib.rmsnorm_noop.argtypes = [ctypes.c_void_p]
        lib.rmsnorm_noop.restype = ctypes.c_int
        for fn in ("threads_per_block", "vectors_per_thread",
                   "max_threads"):
            getattr(lib, f"rmsnorm_{fn}").restype = ctypes.c_int
        if (lib.rmsnorm_threads_per_block(), lib.rmsnorm_vectors_per_thread(),
                lib.rmsnorm_max_threads()) != (THREADS, VPT, MAX_THREADS):
            raise RuntimeError(
                "rmsnorm.cu and rmsnorm.py disagree on the block sizes")
        lib._repro_bound = True
    return lib


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """The card kernels of the serving path have no backward (the
    reference's have no custom_vjp): refuse inputs that want a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{what}: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or on tensors that need no gradient")


def _check(code: int, lib: ctypes.CDLL, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {code} "
            f"({lib.rmsnorm_error_string(code).decode()})")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6, *,
            kernel: Optional[str] = None) -> torch.Tensor:
    """K7: RMSNorm of x (..., D) with weight w (D,); output in x's dtype.
    ``kernel`` ("one_pass" or "two_pass") overrides ``kernel_for`` on a
    CUDA tensor, for timing one against the other; the one-pass kernel
    raises where it does not apply."""
    d = x.shape[-1]
    if x.dim() < 1 or tuple(w.shape) != (d,):
        raise ValueError(
            f"rmsnorm: expects x (..., D) and w (D,); got {tuple(x.shape)} "
            f"and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"rmsnorm: x and w must be float32 or bfloat16; got {x.dtype} "
            f"and {w.dtype}")
    if w.device != x.device:
        raise ValueError(
            f"rmsnorm: x and w must lie on one device; got {x.device} and "
            f"{w.device}")
    if kernel not in (None,) + KERNELS:
        raise ValueError(f"rmsnorm: kernel must be one of {KERNELS}; got "
                         f"{kernel!r}")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(
            f"rmsnorm: the kernel runs on a CUDA device and the plain "
            f"version on the CPU; got a tensor on {x.device}")
    forward_only("rmsnorm", x, w)
    lib = _lib()
    x2 = x.contiguous()
    wc = w.contiguous()
    rows = x2.numel() // d if d else 0
    y = torch.empty_like(x2)
    if rows == 0:
        return y
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, wc, y))
    chosen = kernel_for(d, x2.element_size(), aligned)
    if kernel == "one_pass" and chosen != "one_pass":
        raise ValueError(
            f"rmsnorm: the one-pass kernel takes 16-byte aligned rows of a "
            f"whole number of 16-byte vectors, D <= "
            f"{one_pass_max_d(x2.element_size())}; got D = {d}, aligned "
            f"{aligned}")
    chosen = kernel or chosen
    if chosen == "one_pass":
        code = _ONE_PASS
    elif (d * x2.element_size()) % 16 == 0 and x2.data_ptr() % 16 == 0 \
            and y.data_ptr() % 16 == 0:
        code = _TWO_PASS_VEC
    else:
        code = _TWO_PASS_SCALAR
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _check(lib.rmsnorm_forward(
            x2.data_ptr(), wc.data_ptr(), y.data_ptr(), rows, d, float(eps),
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], code, stream),
            lib, "rmsnorm")
    launches["rmsnorm"] += 1
    variant_launches[chosen] += 1
    return y


def noop(device) -> None:
    """Launch an empty kernel (one warp) on ``device``'s current stream
    through the same ctypes route as K7: the launch floor. Not counted."""
    lib = _lib()
    with torch.cuda.device(device):
        _check(lib.rmsnorm_noop(
            torch.cuda.current_stream(device).cuda_stream), lib, "noop")
