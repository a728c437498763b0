"""K9: the Mamba-2 SSD chunk scan on the card, with its plain version.

``ssd_scan`` replaces ``repro/kernels/ssd_scan.py::ssd_scan_pallas``: x
(B, S, H, P), dt (B, S, H) f32 post-softplus, a (H,) f32 negative, B and C
(B, S, G, N) with G dividing H (head h reads group h // (H/G)), chunks of
``chunk`` steps, an optional initial state h0 (B, H, P, N). It returns
(y (B, S, H, P) in x's dtype, h_last (B, H, P, N) f32): the TPU kernel keeps
the final state on chip, this one writes it, so a prefill needs no second,
plain scan for its cache. The CUDA source is ``csrc/ssd_scan.cu``; it
needs S divisible by ``chunk`` (the model pads with dt = 0) and ``chunk``
divisible by 16. In bf16 it takes the (head dim, state) pairs (64, 128)
(mamba2_2_7b) and (16, 16) (its SMOKE config and the reference tests'
``ssm`` config) and runs three kernels on the tensor cores, each
chunk-parallel: ``ssd_chunk_state`` (the chunk cumsum cs and each chunk's
own state S_c), ``ssd_state_pass`` (the recurrence over the chunks, in
place: S_c becomes the state before chunk c) and ``ssd_chunk_scan`` (y),
on an f32 scratch of B·S·H + B·nc·H·P·N values. In f32 (multiples of 16)
it runs one kernel with plain FMAs. ``ssd_chunk_scan`` is one of two
kernels, which ``kernel_for`` picks: ``wgmma`` (TMA loads into a ring
guarded by mbarriers, C Bᵀ, its decayed product with x and C h_prevᵀ on
wgmma) at (64, 128) and chunks of whole 64-row query blocks, the main
path's; ``mma_sync`` (mma.sync, 16-row warp tiles) everywhere else.
``source_config`` reads the wgmma kernel's constants from the source,
``chunk_tiles`` and ``warpgroup_of`` are its rules for the key tiles a
64-row query block visits and for the warpgroup that owns it.

``ssd_chunked`` is the plain scan in f32, and the Mamba-2 model's plain
route (the reference oracle ``ssd_scan_ref`` is likewise the reference
model's own); it is the composition of the three kernels' plain versions
``chunk_states``, ``state_pass`` and ``chunk_outputs``, and
``ssd_scan_plain`` is it with y cast to x's dtype. For a tensor on the CPU
each wrapper takes its plain version; for a CUDA tensor it launches its
kernel or raises. ``launches`` counts kernel launches: ``ssd_scan`` one
per call, and each of the three bf16 kernels (``PARTS``) one per launch;
``variant_launches`` the launches of each of K9.3's two kernels.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import cost_hooks

from . import build
from .rmsnorm import forward_only, plain_tensors

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# the bf16 path's three kernels, each launched once per bf16 ssd_scan call
PARTS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
launches = {"ssd_scan": 0, **{part: 0 for part in PARTS}}
# K9.3's kernels (the third part), by the codes of ssd_chunk_scan_kernel
KERNELS = ("wgmma", "mma_sync")
_KERNEL_CODE = {"mma_sync": 1, "wgmma": 2}
variant_launches = {k: 0 for k in KERNELS}


def reset_launches() -> None:
    for key in launches:
        launches[key] = 0
    for key in KERNELS:
        variant_launches[key] = 0


@functools.lru_cache(maxsize=None)
def source_config() -> Dict[str, int]:
    """The wgmma kernel's constants as ``csrc/ssd_scan.cu`` defines them:
    the (head dim, state) it takes (``p``, ``n``), the query rows of a
    block (``rows``), its consumer warpgroups (``nwg``), the keys of a ring
    stage (``bk``) and the ring's stages (``stages``)."""
    text = (build.CSRC_DIR / "ssd_scan.cu").read_text()
    define = {name.lower(): int(value) for name, value in re.findall(
        r"^#define SSD_WG_(\w+) (\d+)$", text, re.M)}
    return {k: define[k] for k in ("p", "n", "rows", "nwg", "bk", "stages")}


def kernel_for(p: int, n: int, q: int) -> str:
    """K9.3's kernel for head dim p, state n and chunk q (bf16): "wgmma"
    at the source's (p, n) = (64, 128) with chunks of whole 64-row query
    blocks (mamba2_2_7b's path), "mma_sync" elsewhere (its SMOKE config's
    (16, 16), chunks of 16 or 32), as ``ssd_scan_kernel_of`` in the source."""
    cfg = source_config()
    if (p, n) == (cfg["p"], cfg["n"]) and q > 0 and q % 64 == 0:
        return "wgmma"
    return "mma_sync"


def chunk_tiles(q0: int, bk: int) -> Tuple[int, int]:
    """The key tiles of ``bk`` keys that the query rows [q0, q0 + 64) of
    a chunk visit, [0, hi], and the last interior one, ihi (every key of
    tiles 0..ihi at or before every row: no mask; the tiles after it, the
    diagonal ones, are masked), as ``ssd_tiles`` in the source."""
    return (q0 + 63) // bk, (q0 + 1) // bk - 1


def warpgroup_of(r: int, nb: int, nwg: int) -> int:
    """The consumer warpgroup of 64-row query block r of a block's nb, as
    ``ssd_wg_of`` in the source: the heaviest paired with the lightest, at
    nb = 2 one each, all to one where there is one."""
    if nwg == 1:
        return 0
    if nb == 2:
        return r
    return min(r, nb - 1 - r) % 2


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


def _per_head(m: torch.Tensor, h: int, chunk: int) -> torch.Tensor:
    """The group matrix m (B,S,G,N) in f32, repeated over its heads (head
    h reads group h // (H/G)) as (B,nc,Q,H,N)."""
    bsz, s, g, n = m.shape
    return torch.repeat_interleave(m.float(), h // g, dim=2).reshape(
        bsz, s // chunk, chunk, h, n)


def chunk_states(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b_mat: torch.Tensor, chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1's plain version: (cs (B,S,H) f32, the within-chunk cumsum
    of dt·a; states (B,nc,H,P,N) f32, each chunk's own contribution
    S_c = sum_j dt_j exp(cs_Q - cs_j) x_j B_j^T to the state at its end)."""
    bsz, s, h, p = x.shape
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bf = _per_head(b_mat, h, chunk)
    da = dtc * a.float()[None, None, None, :]           # (B,nc,Q,H)
    da_cum = chunk_cumsum(da, 2)                         # within-chunk
    da_total = da_cum[:, :, -1]                          # (B,nc,H)
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cum)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", bf,
                          dtc * decay_to_end, xf)        # (B,nc,H,P,N)
    return da_cum.reshape(bsz, s, h), states


def state_pass(states: torch.Tensor, cs: torch.Tensor, chunk: int,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's plain version: the sequential scan over the chunk states
    from h0 (or 0), h <- h exp(cs_Q) + S_c. Returns (h_prev (B,nc,H,P,N),
    the state before each chunk; h_last (B,H,P,N))."""
    bsz, nc, h, p, n = states.shape
    da_total = cs.reshape(bsz, nc, chunk, h)[:, :, -1]  # (B,nc,H)
    hc = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                     device=states.device) if h0 is None else h0.float()
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hc)
        hc = hc * torch.exp(da_total[:, c])[..., None, None] + states[:, c]
    return torch.stack(h_prevs, dim=1), hc


def chunk_outputs(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor,
                  h_prev: torch.Tensor, chunk: int) -> torch.Tensor:
    """Kernel 3's plain version: y (B,S,H,P) f32, the intra-chunk term
    ((C B^T) ⊙ L)(dt ⊙ x) plus the inter-chunk term exp(cs) C·h_prev."""
    bsz, s, h, p = x.shape
    nc = s // chunk
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    bf, cf = _per_head(b_mat, h, chunk), _per_head(c_mat, h, chunk)
    da_cum = cs.reshape(bsz, nc, chunk, h)               # (B,nc,Q,H)

    # intra-chunk (diagonal-block) output
    l_mat = torch.exp(_segsum(da_cum.transpose(2, 3)))   # (B,nc,H,Q,Q)
    cb = torch.einsum("bcqhn,bckhn->bchqk", cf, bf)      # (B,nc,H,Q,Q)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", cb * l_mat, dtc, xf)

    # inter-chunk contribution to the outputs
    decay_from_start = torch.exp(da_cum)                 # (B,nc,Q,H)
    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", cf, h_prev,
                           decay_from_start)
    return (y_diag + y_inter).reshape(bsz, s, h, p)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD chunked scan in f32. x (B,S,H,P), dt (B,S,H) post-softplus,
    a (H,) negative, b_mat/c_mat (B,S,G,N) with G dividing H (head h reads
    group h // (H/G)), h0 (B,H,P,N) or None. Returns (y (B,S,H,P) f32,
    h_last (B,H,P,N) f32). The composition of the three kernels' plain
    versions: chunk states, the state pass, chunk outputs."""
    s = x.shape[1]
    if s % chunk != 0:
        raise ValueError(
            f"mamba2 ssd: sequence length {s} not divisible by chunk {chunk}")
    cs, states = chunk_states(x, dt, a, b_mat, chunk)
    h_prev, h_last = state_pass(states, cs, chunk, h0=h0)
    return chunk_outputs(x, dt, cs, b_mat, c_mat, h_prev, chunk), h_last


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked`` in f32, y cast to x's dtype."""
    y, h_last = ssd_chunked(x, dt, a, b_mat, c_mat, chunk, h0=h0)
    return y.to(x.dtype), h_last


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/ssd_scan.cu``) with its functions'
    argument and result types set, once."""
    if not getattr(lib, "_repro_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr, n_int in (("ssd_scan_forward", 10, 8),
                                   ("ssd_chunk_state_forward", 6, 7),
                                   ("ssd_state_pass_forward", 4, 6),
                                   ("ssd_chunk_scan_forward", 7, 7),
                                   ("ssd_chunk_scan_kernel_forward", 7, 8)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
            fn.restype = i32
        lib.ssd_scan_smem_bytes.argtypes = [i32] * 4
        lib.ssd_scan_smem_bytes.restype = i32
        lib.ssd_scan_smem_limit.restype = i32
        lib.ssd_chunk_scan_kernel.argtypes = [i32] * 3
        lib.ssd_chunk_scan_kernel.restype = i32
        lib.ssd_scan_error_string.argtypes = [i32]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        lib._repro_bound = True
    return lib


def _lib() -> ctypes.CDLL:
    return bind(build.load("ssd_scan"))


def _check(x, dt, a, b_mat, c_mat, chunk, h0) -> None:
    """Shapes, dtypes and device of K9's inputs (``a`` None: not taken)."""
    if x.dim() != 4 or dt.dim() != 3 or (a is not None and a.dim() != 1) \
            or b_mat.dim() != 4 or b_mat.shape != c_mat.shape:
        raise ValueError(
            f"ssd_scan: expects x (B, S, H, P), dt (B, S, H), a (H,), B and "
            f"C (B, S, G, N); got {tuple(x.shape)}, {tuple(dt.shape)}, "
            f"{None if a is None else tuple(a.shape)}, "
            f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if tuple(dt.shape) != (bsz, s, h) \
            or (a is not None and tuple(a.shape) != (h,)) \
            or tuple(b_mat.shape[:2]) != (bsz, s) or g == 0 or h % g != 0:
        raise ValueError(
            f"ssd_scan: shapes disagree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a {None if a is None else tuple(a.shape)}"
            f", B/C "
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
    f32 = [t for t in (dt, a, h0) if t is not None]
    if any(t.dtype != torch.float32 for t in f32):
        raise ValueError("ssd_scan: dt, a and h0 must be float32")
    others = [b_mat, c_mat] + f32
    if any(t.device != x.device for t in others):
        raise ValueError("ssd_scan: all inputs must lie on one device")


def _on_card(what: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch), False for a CPU one (plain)."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(
            f"{what}: the kernel runs on a CUDA device and the plain "
            f"version on the CPU; got a tensor on {x.device}")
    return True


def _supported(lib, x, p, n, chunk) -> None:
    smem = lib.ssd_scan_smem_bytes(p, n, chunk, _DTYPE_CODE[x.dtype])
    if smem < 0 or smem > lib.ssd_scan_smem_limit():
        raise ValueError(
            f"ssd_scan: the kernel does not take head dim {p}, state {n}, "
            f"chunk {chunk} in {x.dtype} (chunk a multiple of 16; bf16 (head "
            "dim, state) in (64, 128), (16, 16); f32 multiples of 16; "
            f"shared memory {smem} of at most {lib.ssd_scan_smem_limit()} "
            "bytes)")
    if x.shape[0] > 65535:
        raise ValueError(
            f"ssd_scan: at most 65535 sequences; got {x.shape[0]}")


def _rule(lib, p: int, n: int, chunk: int) -> str:
    """K9.3's kernel by ``kernel_for``, held against the source's own rule
    (so ``variant_launches`` counts the kernel that ran)."""
    chosen = kernel_for(p, n, chunk)
    if lib.ssd_chunk_scan_kernel(p, n, chunk) != _KERNEL_CODE[chosen]:
        raise RuntimeError(
            f"ssd_scan: kernel_for gives {chosen} at (head dim, state, "
            f"chunk) {(p, n, chunk)}, the source's rule code "
            f"{lib.ssd_chunk_scan_kernel(p, n, chunk)}")
    return chosen


def _aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """t, or a copy of it where its data is not 16-byte aligned (the
    kernels read f32 state in 4-element vectors)."""
    return t.clone() if t is not None and t.data_ptr() % 16 else t


def _run(lib, name: str, *args) -> None:
    with torch.cuda.device(args[-1]):
        stream = torch.cuda.current_stream(args[-1]).cuda_stream
        err = getattr(lib, name)(*args[:-1], stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: CUDA error {err} "
            f"({lib.ssd_scan_error_string(err).decode()})")


def _scratch(x: torch.Tensor, n: int, chunk: int):
    """cs (B, S, H) and states (B, nc, H, P, N), f32, uninitialised."""
    bsz, s, h, p = x.shape
    return (torch.empty((bsz, s, h), dtype=torch.float32, device=x.device),
            torch.empty((bsz, s // chunk, h, p, n), dtype=torch.float32,
                        device=x.device))


def _tiles(b: int, s: int, h: int, chunk: int) -> int:
    return b * h * (s // chunk)


def work(b: int, s: int, h: int, p: int, g: int, n: int, chunk: int,
         itemsize: int, h0: bool = False):
    """K9's work, (FLOPs by dtype, bytes): x read and y written in x's
    dtype, dt f32, B and C in x's dtype, a and h_last (and h0) f32, each
    once; per chunk tile the causal half of C Bᵀ (Q (Q + 1) / 2 products
    of 2N FLOPs), its masked product with x (of 2P), C h and the state
    update (2·Q·N·P each), on the tensor cores in x's dtype."""
    key = "bf16" if itemsize == 2 else "f32"
    q, state = chunk, b * h * p * n * 4
    return ({key: _tiles(b, s, h, q) * (q * (q + 1) * n + q * (q + 1) * p
                                        + 4 * q * n * p)},
            2 * b * s * h * p * itemsize + b * s * h * 4
            + 2 * b * s * g * n * itemsize + h * 4 + state
            + (state if h0 else 0))


def chunk_state_work(b: int, s: int, h: int, p: int, g: int, n: int,
                     chunk: int, itemsize: int):
    """K9.1's work: x, B, dt, a in; cs and the chunk states S_c out."""
    st = b * (s // chunk) * h * p * n
    return ({"bf16" if itemsize == 2 else "f32":
             _tiles(b, s, h, chunk) * 2 * chunk * n * p},
            b * s * h * p * itemsize + b * s * g * n * itemsize
            + 2 * b * s * h * 4 + h * 4 + st * 4)


def state_pass_work(b: int, nc: int, h: int, p: int, n: int):
    """K9.2's work: S_c in, h_prev out, the chunks' last cs, h_last."""
    st = b * nc * h * p * n
    return {"f32": 2 * st}, 2 * st * 4 + b * nc * h * 4 + b * h * p * n * 4


def chunk_scan_work(b: int, s: int, h: int, p: int, g: int, n: int,
                    chunk: int, itemsize: int):
    """K9.3's work: x, dt, cs, B, C, h_prev in; y out."""
    q, st = chunk, b * (s // chunk) * h * p * n
    return ({"bf16" if itemsize == 2 else "f32": _tiles(b, s, h, q) * (
        q * (q + 1) * n + q * (q + 1) * p + 2 * q * n * p)},
        2 * b * s * h * p * itemsize + 2 * b * s * h * 4
        + 2 * b * s * g * n * itemsize + st * 4)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: (y (B, S, H, P) in x's dtype, h_last (B, H, P, N) f32). In bf16
    on the card: kernels 1-3 on an f32 scratch of B·nc·H·P·N + B·S·H
    values; in f32 one kernel."""
    plain_tensors("ssd_scan", x, dt, a, b_mat, c_mat, h0)
    _check(x, dt, a, b_mat, c_mat, chunk, h0)
    if cost_hooks.active() is not None:
        return cost_hooks.run_kernel("ssd_scan", work(
            *x.shape, *b_mat.shape[2:], chunk, x.element_size(),
            h0 is not None),
            lambda: ssd_scan(x, dt, a, b_mat, c_mat, chunk, h0=h0))
    if build.shapes_only(x):
        return torch.empty_like(x.contiguous()), torch.empty(
            (x.shape[0], x.shape[2], x.shape[3], b_mat.shape[3]),
            dtype=torch.float32, device=x.device)
    if not _on_card("ssd_scan", x):
        return ssd_scan_plain(x, dt, a, b_mat, c_mat, chunk, h0=h0)
    forward_only("ssd_scan", x, dt, a, b_mat, c_mat,
                 *((h0,) if h0 is not None else ()))
    lib = _lib()
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    _supported(lib, x, p, n, chunk)
    xc, dtc, ac = x.contiguous(), dt.contiguous(), a.contiguous()
    bc, cc = b_mat.contiguous(), c_mat.contiguous()
    hc = _aligned(h0.contiguous()) if h0 is not None else None
    y = torch.empty_like(xc)
    h_last = torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0:
        return y, h_last.zero_() if hc is None else h_last.copy_(hc)
    if any(t.data_ptr() % 16 for t in (xc, bc, cc, y)):
        raise ValueError("ssd_scan: x, B and C must be 16-byte aligned")
    bf16 = x.dtype == torch.bfloat16
    chosen = _rule(lib, p, n, chunk) if bf16 else None
    cs, states = _scratch(x, n, chunk) if bf16 else (None, None)
    _run(lib, "ssd_scan_forward", xc.data_ptr(), dtc.data_ptr(),
         ac.data_ptr(), bc.data_ptr(), cc.data_ptr(),
         hc.data_ptr() if hc is not None else None, y.data_ptr(),
         h_last.data_ptr(), cs.data_ptr() if bf16 else None,
         states.data_ptr() if bf16 else None, bsz, s, h, g, p, n, chunk,
         _DTYPE_CODE[x.dtype], x.device)
    launches["ssd_scan"] += 1
    if bf16:
        for part in PARTS:
            launches[part] += 1
        variant_launches[chosen] += 1
    return y, h_last


# ---- the three bf16 kernels one at a time (their tests and timings)

def _check_part(what: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{what}: the kernel takes bfloat16 x, B and C; "
                         f"got {x.dtype} (f32 runs as one kernel)")
    if any(t.device != x.device for t in others):
        raise ValueError(f"{what}: all inputs must lie on one device")


def ssd_chunk_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_mat: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1: (cs (B,S,H) f32, states (B,nc,H,P,N) f32), as
    ``chunk_states``; bf16 on the card."""
    _check(x, dt, a, b_mat, b_mat, chunk, None)
    if cost_hooks.active() is not None:
        return cost_hooks.run_kernel("ssd_chunk_state", chunk_state_work(
            *x.shape, *b_mat.shape[2:], chunk, x.element_size()),
            lambda: ssd_chunk_state(x, dt, a, b_mat, chunk))
    if build.shapes_only(x):
        return _scratch(x, b_mat.shape[3], chunk)
    if not _on_card("ssd_chunk_state", x):
        return chunk_states(x, dt, a, b_mat, chunk)
    _check_part("ssd_chunk_state", x)
    lib = _lib()
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    _supported(lib, x, p, n, chunk)
    xc, bc = x.contiguous(), b_mat.contiguous()
    if any(t.data_ptr() % 16 for t in (xc, bc)):
        raise ValueError("ssd_chunk_state: x and B must be 16-byte aligned")
    cs, states = _scratch(x, n, chunk)
    _run(lib, "ssd_chunk_state_forward", xc.data_ptr(),
         dt.contiguous().data_ptr(), a.contiguous().data_ptr(),
         bc.data_ptr(), cs.data_ptr(), states.data_ptr(), bsz, s, h, g, p,
         n, chunk, x.device)
    launches["ssd_chunk_state"] += 1
    return cs, states


def ssd_state_pass(states: torch.Tensor, cs: torch.Tensor, chunk: int,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2: (h_prev (B,nc,H,P,N), h_last (B,H,P,N)), as
    ``state_pass``. On the card h_prev is ``states`` itself, overwritten
    in place."""
    if states.dim() != 5 or cs.dim() != 3 or chunk <= 0 \
            or tuple(cs.shape) != (states.shape[0],
                                   states.shape[1] * chunk,
                                   states.shape[2]) \
            or (h0 is not None and h0.shape != (states.shape[:1]
                                                + states.shape[2:])):
        raise ValueError(
            f"ssd_state_pass: expects states (B, nc, H, P, N), cs (B, nc x "
            f"{chunk}, H) and h0 (B, H, P, N); got {tuple(states.shape)}, "
            f"{tuple(cs.shape)}, "
            f"{None if h0 is None else tuple(h0.shape)}")
    if any(t is not None and t.dtype != torch.float32
           for t in (states, cs, h0)):
        raise ValueError("ssd_state_pass: states, cs and h0 must be float32")
    if cost_hooks.active() is not None:
        b_, nc_, h_, p_, n_ = states.shape
        return cost_hooks.run_kernel("ssd_state_pass", state_pass_work(
            b_, nc_, h_, p_, n_), lambda: ssd_state_pass(states, cs, chunk,
                                                         h0=h0),
            inputs=(states,))
    if build.shapes_only(states):
        return states, torch.empty(states.shape[:1] + states.shape[2:],
                                   dtype=torch.float32, device=states.device)
    if not _on_card("ssd_state_pass", states):
        return state_pass(states, cs, chunk, h0=h0)
    others = (cs,) + ((h0,) if h0 is not None else ())
    if any(t.device != states.device for t in others):
        raise ValueError("ssd_state_pass: all inputs must lie on one device")
    if not states.is_contiguous() or states.data_ptr() % 16:
        raise ValueError("ssd_state_pass: states must be contiguous and "
                         "16-byte aligned (it is updated in place)")
    bsz, nc, h, p, n = states.shape
    if bsz > 65535 or nc * chunk > 2 ** 31 - 1:
        raise ValueError(f"ssd_state_pass: shape {tuple(states.shape)} "
                         "too large")
    hc = _aligned(h0.contiguous()) if h0 is not None else None
    h_last = torch.empty((bsz, h, p, n), dtype=torch.float32,
                         device=states.device)
    if states.numel() == 0:
        return states, h_last.zero_() if hc is None else h_last.copy_(hc)
    _run(_lib(), "ssd_state_pass_forward", states.data_ptr(),
         cs.contiguous().data_ptr(),
         hc.data_ptr() if hc is not None else None, h_last.data_ptr(), bsz,
         nc * chunk, h, p, n, chunk, states.device)
    launches["ssd_state_pass"] += 1
    return states, h_last


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, cs: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor,
                   h_prev: torch.Tensor, chunk: int,
                   kernel: Optional[str] = None) -> torch.Tensor:
    """Kernel 3: y (B,S,H,P) in x's dtype, as ``chunk_outputs``; bf16 on
    the card, on the kernel ``kernel_for`` picks or on ``kernel`` (one of
    ``KERNELS``; "wgmma" only where the rule gives it), forced for
    timing."""
    if kernel is not None and kernel not in KERNELS:
        raise ValueError(f"ssd_chunk_scan: kernel {kernel!r} not among "
                         f"{KERNELS}")
    _check(x, dt, None, b_mat, c_mat, chunk, None)
    bsz, s, h, p = x.shape
    n = b_mat.shape[3]
    if tuple(cs.shape) != (bsz, s, h) or cs.dtype != torch.float32 \
            or tuple(h_prev.shape) != (bsz, s // chunk, h, p, n) \
            or h_prev.dtype != torch.float32:
        raise ValueError(
            f"ssd_chunk_scan: expects cs {(bsz, s, h)} and h_prev "
            f"{(bsz, s // chunk, h, p, n)} float32; got {tuple(cs.shape)} "
            f"{cs.dtype}, {tuple(h_prev.shape)} {h_prev.dtype}")
    if cost_hooks.active() is not None:
        return cost_hooks.run_kernel("ssd_chunk_scan", chunk_scan_work(
            bsz, s, h, p, b_mat.shape[2], n, chunk, x.element_size()),
            lambda: ssd_chunk_scan(x, dt, cs, b_mat, c_mat, h_prev, chunk,
                                   kernel=kernel))
    if build.shapes_only(x):
        return torch.empty_like(x.contiguous())
    if not _on_card("ssd_chunk_scan", x):
        return chunk_outputs(x, dt, cs, b_mat, c_mat, h_prev,
                             chunk).to(x.dtype)
    _check_part("ssd_chunk_scan", x, cs, h_prev)
    lib = _lib()
    _supported(lib, x, p, n, chunk)
    chosen = _rule(lib, p, n, chunk)
    if kernel == "wgmma" and chosen != "wgmma":
        raise ValueError(
            f"ssd_chunk_scan: the wgmma kernel takes (head dim, state) "
            f"{(source_config()['p'], source_config()['n'])} at chunks of "
            f"whole 64-row blocks; got {(p, n)}, chunk {chunk}")
    chosen = kernel or chosen
    xc, bc, cc = x.contiguous(), b_mat.contiguous(), c_mat.contiguous()
    hp = _aligned(h_prev.contiguous())
    y = torch.empty_like(xc)
    if y.numel() == 0:
        return y
    if any(t.data_ptr() % 16 for t in (xc, bc, cc, y)):
        raise ValueError("ssd_chunk_scan: x, B and C must be 16-byte "
                         "aligned")
    _run(lib, "ssd_chunk_scan_kernel_forward", xc.data_ptr(),
         dt.contiguous().data_ptr(), cs.contiguous().data_ptr(),
         bc.data_ptr(), cc.data_ptr(), hp.data_ptr(), y.data_ptr(), bsz, s,
         h, b_mat.shape[2], p, n, chunk, _KERNEL_CODE[chosen], x.device)
    launches["ssd_chunk_scan"] += 1
    variant_launches[chosen] += 1
    return y
