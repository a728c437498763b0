"""K8: causal / sliding-window GQA flash attention on the card, with its
plain version.

``flash_attention`` replaces
``repro/kernels/flash_attention.py::flash_attention_pallas``: q (B, H, S,
dh), k and v (B, Hkv, S, dh) with H a multiple of Hkv, query i attending
key j iff j <= i and (window == 0 or j > i - window), output (B, H, S, dh)
in q's dtype. The CUDA source is ``csrc/flash_attention.cu``; it takes
any S, and head dims 16, 32, 64, 128 and 256. ``kernel_for`` picks one of
its three kernels: in bf16 ``wgmma`` (TMA loads into a ring guarded by
mbarriers, both products on wgmma) at head dims 64, 128 and 256, the
main paths', and ``mma_sync`` (mma.sync, 64 x 64 tiles) at 16 and
32; ``f32`` (plain FMAs) for float32. ``tiles`` gives a bf16 kernel's
query and kv tiles by head dim, read from the source's constants, and
``kv_tiles`` its rule for the kv tiles a query tile visits and the
interior ones among them, which it runs without a mask.

``flash_attention_plain`` is the reference oracle's arithmetic
(``flash_attention_ref``: ``full_attention`` over expanded KV) with the
scores, the softmax and the products in f32. For a tensor on the CPU the
wrapper takes it; for a CUDA tensor it launches the kernel or raises.
``launches`` counts kernel launches, and ``variant_launches`` the launches
of each of the three kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import cost_hooks

from . import build
from .rmsnorm import forward_only, plain_tensors

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
KERNELS = ("wgmma", "mma_sync", "f32")
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.float32, torch.bfloat16)
# kernel codes of flash_attention_forward
_KERNEL_CODE = {"f32": 0, "mma_sync": 1, "wgmma": 2}

launches = {"flash_attention": 0}
variant_launches = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    launches["flash_attention"] = 0
    for k in KERNELS:
        variant_launches[k] = 0


def kernel_for(dh: int, itemsize: int) -> str:
    """K8's kernel for head dim dh and elements of itemsize bytes: "f32"
    for float32; in bf16 "wgmma" at head dims 64, 128 and 256 (every main
    path's), "mma_sync" at 16 and 32 (SMOKE configs and tests), where a
    64-row warpgroup tile and 128-byte swizzled rows do not fit."""
    if itemsize == 4:
        return "f32"
    return "wgmma" if dh in WGMMA_HEAD_DIMS else "mma_sync"


@functools.lru_cache(maxsize=None)
def source_config() -> Dict[str, object]:
    """The bf16 kernels' tile constants as ``csrc/flash_attention.cu``
    defines them: the wgmma kernel's consumer warpgroups (``FA_NWG``),
    ring stages (``FA_STAGES``) and kv tile by head dim (its ``FA_CFG``
    lines), and the mma_sync kernel's warps (``FA_WARPS``) and kv tile
    (``FA_BK``)."""
    text = (build.CSRC_DIR / "flash_attention.cu").read_text()
    define = {name: int(value) for name, value in re.findall(
        r"^#define (FA_\w+) (\d+)$", text, re.M)}
    return {"nwg": define["FA_NWG"], "stages": define["FA_STAGES"],
            "bk": {int(dh): int(bk) for dh, bk in re.findall(
                r"^FA_CFG\((\d+), (\d+)\)$", text, re.M)},
            "warps": define["FA_WARPS"], "mma_sync_bk": define["FA_BK"]}


def tiles(dh: int) -> Tuple[int, int]:
    """The bf16 kernel's (query tile, kv tile) at head dim dh: 64 rows a
    consumer warpgroup (wgmma) or 16 a warp (mma_sync)."""
    cfg = source_config()
    if kernel_for(dh, 2) == "wgmma":
        return 64 * cfg["nwg"], cfg["bk"][dh]
    return 16 * cfg["warps"], cfg["mma_sync_bk"]


def band_mask(s: int, window: int, device=None) -> torch.Tensor:
    """(s, s) bool: query i attends key j iff j <= i and (window == 0 or
    j > i - window)."""
    qi = torch.arange(s, device=device)[:, None]
    kj = torch.arange(s, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def band_pairs(s: int, window: int) -> int:
    """(query, key) pairs of causal attention over s positions, each query
    seeing min(q + 1, window) keys (window 0: all q + 1)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def work(b: int, h: int, hkv: int, s: int, dh: int, window: int,
         itemsize: int):
    """K8's work, (FLOPs by dtype, bytes): q read and o written, k and v
    read once; 4·dh FLOPs a (query, key) pair in the band (q·k and p·v),
    in q's dtype on the tensor cores."""
    key = "bf16" if itemsize == 2 else "f32"
    return ({key: 4 * dh * b * h * band_pairs(s, window)},
            itemsize * (2 * b * h * s * dh + 2 * b * hkv * s * dh))


def kv_tiles(q0: int, s: int, window: int, bq: int,
             bk: int) -> Tuple[int, int, int, int]:
    """The kv tiles of ``bk`` keys that the query tile of rows [q0,
    min(q0 + bq, s) - 1] visits, (lo, hi), inclusive, and the interior
    ones among them, (ilo, ihi) (none when ilo > ihi), as the bf16 kernels
    compute them (``csrc/flash_attention.cu``, ``fa_tiles``; ``tiles``
    gives (bq, bk) by head dim, and the wgmma kernel applies the rule per
    64-row warpgroup too): every key of an interior tile is live for every
    row of the query tile, so the kernel skips its mask; a tile outside
    (lo, hi) holds no live key."""
    q_last = min(q0 + bq, s) - 1
    hi = q_last // bk
    lo = (q0 - window + 1) // bk if window > 0 and q0 - window + 1 > 0 \
        else 0
    ihi = (q0 + 1) // bk - 1
    ilo = -(-(q_last - window + 1) // bk) \
        if window > 0 and q_last - window + 1 > 0 else 0
    return lo, hi, ilo, ihi


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Dense masked attention over expanded KV in f32; (B, H, S, dh)."""
    h, hkv, dh = q.shape[1], k.shape[1], q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    ke = torch.repeat_interleave(k, h // hkv, dim=1).float()
    ve = torch.repeat_interleave(v, h // hkv, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    s = torch.where(band_mask(q.shape[2], window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, ve).to(q.dtype)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/flash_attention.cu``) with its functions'
    argument and result types set, once."""
    if not getattr(lib, "_repro_bound", False):
        lib.flash_attention_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]  # ..., scale, kernel, stream
        lib.flash_attention_forward.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.load("flash_attention"))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """K8: causal (window 0) or sliding-window GQA attention."""
    plain_tensors("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: expects q (B, H, S, dh) and k, v (B, Hkv, S, "
            f"dh); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, dh = q.shape
    hkv = k.shape[1]
    if k.shape[0] != b or k.shape[2] != s or k.shape[3] != dh \
            or hkv == 0 or h % hkv != 0:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not match q "
            f"{tuple(q.shape)} (batch, length and head dim equal; H a "
            "multiple of Hkv)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share one dtype among "
            f"float32/bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(
            f"flash_attention: q, k, v must lie on one device; got "
            f"{q.device}, {k.device}, {v.device}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0; got {window}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if cost_hooks.active() is not None:
        return cost_hooks.run_kernel("flash_attention", work(
            b, h, hkv, s, dh, window, q.element_size()),
            lambda: flash_attention(q, k, v, window=window, scale=scale))
    if build.shapes_only(q):
        return torch.empty_like(q.contiguous())
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention: the kernel runs on a CUDA device and the "
            f"plain version on the CPU; got a tensor on {q.device}")
    if dh not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {dh} not among {HEAD_DIMS}")
    forward_only("flash_attention", q, k, v)
    lib = _lib()
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    if qc.numel() == 0:
        return out
    if any(t.data_ptr() % 16 for t in (qc, kc, vc, out)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    chosen = kernel_for(dh, q.element_size())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_forward(
            qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(), b,
            h, hkv, s, dh, int(window), float(scale), _KERNEL_CODE[chosen],
            stream)
    if code != 0:
        raise RuntimeError(
            f"flash_attention launch failed ({chosen} kernel): CUDA error "
            f"{code} ({lib.flash_attention_error_string(code).decode()})")
    launches["flash_attention"] += 1
    variant_launches[chosen] += 1
    return out
