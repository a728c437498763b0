"""K9: the Mamba-2 SSD chunk scan on the card, with its plain version.

``ssd_scan`` replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas``: x
(B, S, H, P), dt (B, S, H) f32 post-softplus, a (H,) f32 negative, B and C
(B, S, G, N) with G dividing H (head h reads group h // (H/G)), chunks of
``chunk`` steps, an optional initial state h0 (B, H, P, N). It returns
(y (B, S, H, P) in x's dtype, h_last (B, H, P, N) f32): the TPU kernel keeps
the final state on chip, this one writes it, so a prefill needs no second,
plain scan for its cache. The CUDA source is ``csrc/ssd_scan.cu`` (bf16 on
the tensor cores, f32 with plain FMAs); it needs S divisible by ``chunk``
(the model pads with dt = 0) and ``chunk`` divisible by 16; in bf16 it
takes the (head dim, state) pairs (64, 128) (mamba2_2_7b) and (16, 16) (its
SMOKE config and the reference tests' ``ssm`` config), in f32 multiples of
16.

``ssd_chunked`` is the plain scan in f32, and the Mamba-2 model's plain
route (the reference oracle ``ssd_scan_ref`` is likewise the reference
model's own); ``ssd_scan_plain`` is it with y cast to x's dtype. For a
tensor on the CPU the wrapper takes it; for a CUDA tensor it launches the
kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from .rmsnorm import forward_only

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = {"ssd_scan": 0}


def reset_launches() -> None:
    launches["ssd_scan"] = 0


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = cs[..., i] - cs[..., j] (the sum of x over
    (j, i]) for j <= i, else -inf; cs (..., Q) is x's inclusive cumsum."""
    q = cs.shape[-1]
    diff = cs[..., :, None] - cs[..., None, :]
    idx = torch.arange(q, device=cs.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.where(mask, diff, float("-inf"))


def chunk_cumsum(da: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumsum of f32 ``da`` along ``dim``, summed in f64 and
    rounded once to f32. The exponents exp(cs_i - cs_j) amplify any
    rounding of cs (at -16 per step cs reaches the thousands, where an f32
    ulp is 2.4e-4), and an f32 cumsum's rounding depends on its summation
    order, which differs between devices and K9; the f64 sum rounds to the
    same f32 cs everywhere."""
    return torch.cumsum(da.double(), dim=dim).float()


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan in f32. x (B,S,H,P), dt (B,S,H) post-softplus,
    a (H,) negative, b_mat/c_mat (B,S,G,N) with G dividing H (head h reads
    group h // (H/G)), h0 (B,H,P,N) or None. Returns (y (B,S,H,P) f32,
    h_last (B,H,P,N) f32)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if s % chunk != 0:
        raise ValueError(
            f"mamba2 ssd: sequence length {s} not divisible by chunk {chunk}")
    nc = s // chunk
    rep = h // g

    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bf = torch.repeat_interleave(b_mat.float(), rep, dim=2).reshape(
        bsz, nc, chunk, h, n)
    cf = torch.repeat_interleave(c_mat.float(), rep, dim=2).reshape(
        bsz, nc, chunk, h, n)

    da = dtc * a.float()[None, None, None, :]           # (B,nc,Q,H)
    da_cum = chunk_cumsum(da, 2)                         # within-chunk
    da_total = da_cum[:, :, -1]                          # (B,nc,H)

    # intra-chunk (diagonal-block) output
    l_mat = torch.exp(_segsum(da_cum.transpose(2, 3)))   # (B,nc,H,Q,Q)
    cb = torch.einsum("bcqhn,bckhn->bchqk", cf, bf)      # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", cb * l_mat, dtc, xf)

    # chunk boundary states
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cum)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bf,
                          dtc * decay_to_end, xf)        # (B,nc,H,P,N)

    # inter-chunk sequential scan over chunk states (pre-states kept)
    hc = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hc)
        hc = hc * torch.exp(da_total[:, c])[..., None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)                  # (B,nc,H,P,N)

    # inter-chunk contribution to the outputs
    decay_from_start = torch.exp(da_cum)                 # (B,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cf, h_prev,
                           decay_from_start)

    y = (y_diag + y_inter).reshape(bsz, s, h, p)
    return y, hc


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked`` in f32, y cast to x's dtype."""
    y, h_last = ssd_chunked(x, dt, a, b_mat, c_mat, chunk, h0=h0)
    return y.to(x.dtype), h_last


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    if not getattr(lib, "_repro_bound", False):
        lib.ssd_scan_forward.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.ssd_scan_forward.restype = ctypes.c_int
        lib.ssd_scan_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.ssd_scan_smem_bytes.restype = ctypes.c_int
        lib.ssd_scan_smem_limit.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _check(x, dt, a, b_mat, c_mat, chunk, h0) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_mat.dim() != 4 \
            or b_mat.shape != c_mat.shape:
        raise ValueError(
            f"ssd_scan: expects x (B, S, H, P), dt (B, S, H), a (H,), B and "
            f"C (B, S, G, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{tuple(a.shape)}, {tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) \
            or tuple(b_mat.shape[:2]) != (bsz, s) or g == 0 or h % g != 0:
        raise ValueError(
            f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, B/C "
            f"{tuple(b_mat.shape)} (G must divide H)")
    if h0 is not None and tuple(h0.shape) != (bsz, h, p, n):
        raise ValueError(
            f"ssd_scan: h0 must be {(bsz, h, p, n)}; got {tuple(h0.shape)}")
    if chunk <= 0 or s % chunk != 0:
        raise ValueError(
            f"ssd_scan: sequence length {s} not divisible by chunk {chunk}")
    if x.dtype not in _DTYPE_CODE or b_mat.dtype != x.dtype \
            or c_mat.dtype != x.dtype:
        raise ValueError(
            f"ssd_scan: x, B and C must share one dtype among "
            f"float32/bfloat16; got {x.dtype}, {b_mat.dtype}, {c_mat.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32 or (
            h0 is not None and h0.dtype != torch.float32):
        raise ValueError("ssd_scan: dt, a and h0 must be float32")
    others = (dt, a, b_mat, c_mat) + ((h0,) if h0 is not None else ())
    if any(t.device != x.device for t in others):
        raise ValueError("ssd_scan: all inputs must lie on one device")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: (y (B, S, H, P) in x's dtype, h_last (B, H, P, N) f32)."""
    _check(x, dt, a, b_mat, c_mat, chunk, h0)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, a, b_mat, c_mat, chunk, h0=h0)
    if x.device.type != "cuda":
        raise ValueError(
            f"ssd_scan: the kernel runs on a CUDA device and the plain "
            f"version on the CPU; got a tensor on {x.device}")
    forward_only("ssd_scan", x, dt, a, b_mat, c_mat,
                 *((h0,) if h0 is not None else ()))
    lib = _lib()
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    code = _DTYPE_CODE[x.dtype]
    smem = lib.ssd_scan_smem_bytes(p, n, chunk, code)
    if smem < 0 or smem > lib.ssd_scan_smem_limit():
        raise ValueError(
            f"ssd_scan: the kernel does not take head dim {p}, state {n}, "
            f"chunk {chunk} in {x.dtype} (chunk a multiple of 16; bf16 (head "
            "dim, state) in (64, 128), (16, 16); f32 multiples of 16; "
            f"shared memory {smem} of at most {lib.ssd_scan_smem_limit()} "
            "bytes)")
    if bsz > 65535:
        raise ValueError(f"ssd_scan: at most 65535 sequences; got {bsz}")
    xc, dtc, ac = x.contiguous(), dt.contiguous(), a.contiguous()
    bc, cc = b_mat.contiguous(), c_mat.contiguous()
    hc = h0.contiguous() if h0 is not None else None
    y = torch.empty_like(xc)
    h_last = torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0:
        return y, h_last.zero_() if hc is None else h_last.copy_(hc)
    if any(t.data_ptr() % 16 for t in (xc, bc, cc, y)):
        raise ValueError("ssd_scan: x, B and C must be 16-byte aligned")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_forward(
            xc.data_ptr(), dtc.data_ptr(), ac.data_ptr(), bc.data_ptr(),
            cc.data_ptr(), hc.data_ptr() if hc is not None else None,
            y.data_ptr(), h_last.data_ptr(), bsz, s, h, g, p, n, chunk, code,
            stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan launch failed: CUDA error {err} "
            f"({lib.ssd_scan_error_string(err).decode()})")
    launches["ssd_scan"] += 1
    return y, h_last
