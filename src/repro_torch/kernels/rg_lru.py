"""K10: the RG-LRU linear recurrence on the card, with its plain version.

``rg_lru`` replaces ``repro/kernels/rg_lru.py::rg_lru_pallas``:
``h_t = exp(log_a_t) * h_{t-1} + b_t`` over (B, S, C) in f32 from h = 0.
The CUDA source is ``csrc/rg_lru.cu``: one pass in which a block owns a
batch row and ``TILE_CHANNELS`` channels and walks all of S in tiles of
``SEGMENTS`` segments of ``SEGMENT_STEPS`` steps, sequential inside each
segment, the segments composed as (A, h) pairs. ``rg_lru_plain`` is a
log-depth doubling scan of (a, b) pairs in f32 — the algorithm of the
reference's ``lax.associative_scan`` (``rg_lru_ref``, and the model's
``rglru_scan``), composing ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``;
it is also the model's plain route. For a tensor on the CPU the wrapper
takes it; for a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches (one per call).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cost_hooks

from . import build
from .rmsnorm import forward_only, plain_tensors

# the card's tile (csrc/rg_lru.cu's LRU_CT, LRU_NS, LRU_L): channels a
# block, segments a tile, steps a segment
TILE_CHANNELS, SEGMENTS, SEGMENT_STEPS = 32, 8, 16

launches = {"rg_lru": 0}


def reset_launches() -> None:
    launches["rg_lru"] = 0


def rg_lru_plain(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h (B, S, C) f32 by doubling: after the pass with offset d, position
    t holds the composition of steps max(0, t - 2d + 1)..t."""
    a = torch.exp(log_a.float())
    h = b.float()
    s = h.shape[1]
    d = 1
    while d < s:
        h = torch.cat([h[:, :d], a[:, d:] * h[:, :-d] + h[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return h


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/rg_lru.cu``) with its argument types."""
    lib.rg_lru_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rg_lru_forward.restype = ctypes.c_int
    lib.rg_lru_tile.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    lib.rg_lru_tile.restype = None
    lib.rg_lru_error_string.argtypes = [ctypes.c_int]
    lib.rg_lru_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    lib = build.load("rg_lru")
    if not getattr(lib, "_repro_bound", False):
        bind(lib)
        tile = [ctypes.c_int() for _ in range(3)]
        lib.rg_lru_tile(*(ctypes.byref(t) for t in tile))
        if tuple(t.value for t in tile) != (TILE_CHANNELS, SEGMENTS,
                                            SEGMENT_STEPS):
            raise RuntimeError(
                "rg_lru.cu and rg_lru.py disagree on the tile: "
                f"{tuple(t.value for t in tile)}")
        lib._repro_bound = True
    return lib


def work(numel: int):
    """K10's work, (FLOPs by dtype, bytes): log_a and b read, h written,
    f32; an exp, a multiply and an add an element."""
    return {"f32": 3 * numel}, 3 * 4 * numel


def rg_lru(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10: h (B, S, C) f32 solving h_t = exp(log_a_t) h_{t-1} + b_t."""
    plain_tensors("rg_lru", log_a, b)
    if log_a.dim() != 3 or log_a.shape != b.shape:
        raise ValueError(
            f"rg_lru: expects log_a and b of one shape (B, S, C); got "
            f"{tuple(log_a.shape)} and {tuple(b.shape)}")
    if log_a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(
            f"rg_lru: log_a and b must be float32; got {log_a.dtype} and "
            f"{b.dtype}")
    if log_a.device != b.device:
        raise ValueError(
            f"rg_lru: log_a and b must lie on one device; got "
            f"{log_a.device} and {b.device}")
    if cost_hooks.active() is not None:
        return cost_hooks.run_kernel("rg_lru", work(log_a.numel()),
                                     lambda: rg_lru(log_a, b))
    if build.shapes_only(log_a):
        return torch.empty_like(log_a.contiguous())
    if log_a.device.type == "cpu":
        return rg_lru_plain(log_a, b)
    if log_a.device.type != "cuda":
        raise ValueError(
            f"rg_lru: the kernel runs on a CUDA device and the plain version "
            f"on the CPU; got a tensor on {log_a.device}")
    forward_only("rg_lru", log_a, b)
    lib = _lib()
    bsz, s, c = log_a.shape
    la, bc = log_a.contiguous(), b.contiguous()
    y = torch.empty_like(la)
    if y.numel() == 0:
        return y
    with torch.cuda.device(log_a.device):
        stream = torch.cuda.current_stream(log_a.device).cuda_stream
        code = lib.rg_lru_forward(la.data_ptr(), bc.data_ptr(), y.data_ptr(),
                                  bsz, s, c, stream)
    if code != 0:
        raise RuntimeError(
            f"rg_lru launch failed: CUDA error {code} "
            f"({lib.rg_lru_error_string(code).decode()})")
    launches["rg_lru"] += 1
    return y
