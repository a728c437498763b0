"""K7: RMSNorm on the card, with its plain version.

``rmsnorm`` replaces ``repro/kernels/rmsnorm.py::rmsnorm_pallas``:
``y = x * rsqrt(mean(x^2) + eps) * w`` over the last axis of x (..., D),
f32 statistics, output in x's dtype, the (D,) weight in its own dtype.
The CUDA source is ``csrc/rmsnorm.cu``. For a tensor on the CPU the
wrapper takes the plain version, ``models.common.rmsnorm`` (the reference
oracle ``rmsnorm_ref`` is the reference model's own ``rmsnorm``); for a
CUDA tensor it launches the kernel or raises. ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.models.common import rmsnorm as rmsnorm_plain

from . import build

THREADS = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"rmsnorm": 0}


def reset_launches() -> None:
    launches["rmsnorm"] = 0


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
        lib.rmsnorm_threads_per_block.restype = ctypes.c_int
        if lib.rmsnorm_threads_per_block() != THREADS:
            raise RuntimeError(
                "rmsnorm.cu and rmsnorm.py disagree on the block size")
        lib._repro_bound = True
    return lib


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """The card kernels of the serving path have no backward (the
    reference's have no custom_vjp): refuse inputs that want a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{what}: the CUDA kernel is forward-only; call it under "
            "torch.no_grad() or on tensors that need no gradient")


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """K7: RMSNorm of x (..., D) with weight w (D,); output in x's dtype."""
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
    vec = (d * x2.element_size()) % 16 == 0 and x2.data_ptr() % 16 == 0 \
        and y.data_ptr() % 16 == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.rmsnorm_forward(
            x2.data_ptr(), wc.data_ptr(), y.data_ptr(), rows, d, float(eps),
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], int(vec), stream)
    if code != 0:
        raise RuntimeError(
            f"rmsnorm launch failed: CUDA error {code} "
            f"({lib.rmsnorm_error_string(code).decode()})")
    launches["rmsnorm"] += 1
    return y
