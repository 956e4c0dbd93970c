"""One band of the column-sharded profile DP, and the walk over the bands
(counterpart of :mod:`csa_tpu.dp.pallas_band`).

:func:`band_fill` fills one band of one rank: ``Rb`` rows by ``Cloc``
columns of the profile-DP recurrence (``csrc/profile_dp.cu``), with the
top boundary row (``Cloc + 1`` values, index 0 the left-halo element)
and the left boundary column (``Rb`` values) given.  It returns the
band's directions packed by anti-diagonal (``csrc/band.cu``'s layout:
``(Rb + Cloc + 1) x ceil((Cloc + 1) / 4)`` bytes, 2 bits a cell), its
bottom row (``Cloc + 1`` values, index 0 the left boundary) and its
right-edge column (``Rb`` values, the halo of
the next rank).  :func:`band_walk` walks the per-(rank, band) blocks
from (R, C) back to (0, 0) and returns the walk-order path codes.

On a CUDA tensor each wrapper launches its kernel (``csrc/band.cu``);
on a CPU tensor it runs its plain version: the row-scan closed form of
``csa_tpu/dp/seqpar.py`` (the in-row left-gap chain as a ``cummax``)
packed into the same layout, and a host walk.  Any other device raises.
:func:`unpack_dirs` turns a packed block back into ``(Rb, Cloc)`` codes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .profile import D_DIAG, D_LEFT, D_UP

THREADS_MAX = 1024


def dirs_bytes(Rb: int, Cloc: int) -> int:
    """Packed direction bytes of one band in the kernel's diagonal
    layout."""
    return (Rb + Cloc + 1) * ((Cloc + 4) // 4)


def scratch_for(Cloc: int, device) -> Optional[torch.Tensor]:
    """The global scratch one band launch needs on ``device``: None when
    its three diagonals fit in shared memory (or on the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    with torch.cuda.device(device):
        if 3 * (Cloc + 1) * 4 <= kernels.smem_optin():
            return None
    return torch.empty((3, Cloc + 1), dtype=torch.int32, device=device)


def _check(codes, colsub, cg, top, left, out):
    Rb, Cloc = codes.numel(), cg.numel()
    want = [(codes, torch.int8, (Rb,)), (colsub, torch.int32, (Cloc, 5)),
            (cg, torch.int32, (Cloc,)), (top, torch.int32, (Cloc + 1,)),
            (left, torch.int32, (Rb,)),
            (out[0], torch.uint8, (dirs_bytes(Rb, Cloc),)),
            (out[1], torch.int32, (Cloc + 1,)), (out[2], torch.int32, (Rb,))]
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != codes.device:
            raise ValueError(
                f"band_fill: expected a contiguous {dtype} {shape} tensor on "
                f"{codes.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}")


def band_fill(codes: torch.Tensor, colsub: torch.Tensor, cg: torch.Tensor,
              rowgap: int, top: torch.Tensor, left: torch.Tensor, *,
              out: Optional[Tuple[torch.Tensor, ...]] = None,
              scratch: Optional[torch.Tensor] = None):
    """Fill one band; returns ``(dirs, bottom, edge)``, written into
    ``out`` when given.  codes: (Rb,) int8; colsub: (Cloc, 5), cg:
    (Cloc,), top: (Cloc + 1,), left: (Rb,) int32 (dp/profile.py's
    ``_channels`` builds colsub, cg and rowgap).  ``scratch`` is
    :func:`scratch_for`'s tensor; passing it keeps the launch free of
    allocations."""
    if kernels.check_device(codes, "band_fill") == "cpu":
        res = band_fill_plain(codes, colsub, cg, rowgap, top, left)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return out
    Rb, Cloc = codes.numel(), cg.numel()
    dev = codes.device
    if out is None:
        out = (torch.empty(dirs_bytes(Rb, Cloc), dtype=torch.uint8,
                           device=dev),
               torch.empty(Cloc + 1, dtype=torch.int32, device=dev),
               torch.empty(Rb, dtype=torch.int32, device=dev))
    _check(codes, colsub, cg, top, left, out)
    if scratch is None:
        scratch = scratch_for(Cloc, dev)
    elif scratch.shape != (3, Cloc + 1) or scratch.dtype != torch.int32 \
            or scratch.device != dev:
        raise ValueError("band_fill: scratch must be (3, Cloc + 1) int32 "
                         "on the band's device")
    # a diagonal's cells span at most this many groups of 4 columns
    groups = min((Cloc + 4) // 4, (min(Rb, Cloc) + 8) // 4)
    threads = min(THREADS_MAX, max(32, -(-groups // 32) * 32))
    dirs, bottom, edge = out
    with torch.cuda.device(dev):
        kernels.COUNTS["band"] += 1
        kernels.call(
            "csa_band_fill", codes.data_ptr(), Rb, colsub.data_ptr(),
            cg.data_ptr(), Cloc, int(rowgap), top.data_ptr(),
            left.data_ptr(), dirs.data_ptr(), bottom.data_ptr(),
            edge.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            int(scratch is None), threads, kernels.stream_ptr(dev),
        )
    return out


def band_fill_plain(codes, colsub, cg, rowgap: int, top, left):
    """The plain PyTorch version of :func:`band_fill`, on the inputs'
    device: a row loop of the closed form, then :func:`pack_dirs`."""
    Rb, Cloc = codes.numel(), cg.numel()
    dev = codes.device
    b = codes.long()
    b = torch.where((b < 0) | (b > 4), 4, b).tolist()
    sub = colsub.long().T.contiguous()                      # (5, Cloc)
    cgl = cg.long()
    S = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                   torch.cumsum(cgl, 0)])
    prev = top.long()
    lft = left.long()
    codes_rc = torch.empty((Rb, Cloc), dtype=torch.int8, device=dev)
    edge = torch.empty(Rb, dtype=torch.int64, device=dev)
    for r in range(Rb):
        diag = prev[:-1] + sub[b[r]]
        up = prev[1:] + rowgap
        dwin = diag >= up
        m1 = torch.where(dwin, diag, up)
        cur = torch.cummax(torch.cat([lft[r:r + 1], m1 - S[1:]]), 0).values + S
        via_left = cur[:-1] + cgl
        take_left = (via_left > m1) | ((via_left == m1) & ~dwin)
        codes_rc[r] = torch.where(take_left, D_LEFT,
                                  torch.where(dwin, D_DIAG, D_UP))
        edge[r] = cur[-1]
        prev = cur
    return pack_dirs(codes_rc), prev.to(torch.int32), edge.to(torch.int32)


def _skewed(flat: torch.Tensor, Rb: int, Cloc: int) -> torch.Tensor:
    """The (Rb, Cloc) view of cells (j, c), j, c >= 1, in a flat
    (Rb + Cloc + 1) x 4Q byte-per-cell diagonal layout: cell (j, c) at
    row j + c, column c."""
    W = 4 * ((Cloc + 4) // 4)
    return flat.as_strided((Rb, Cloc), (W, W + 1), 2 * W + 1)


def pack_dirs(codes_rc: torch.Tensor) -> torch.Tensor:
    """(Rb, Cloc) direction codes -> the kernel's packed diagonal layout
    (boundary and padding cells 0)."""
    Rb, Cloc = codes_rc.shape
    Q = (Cloc + 4) // 4
    T = Rb + Cloc + 1
    flat = torch.zeros(T * 4 * Q, dtype=torch.uint8, device=codes_rc.device)
    _skewed(flat, Rb, Cloc).copy_(codes_rc)
    s = flat.view(T * Q, 4)
    return s[:, 0] | (s[:, 1] << 2) | (s[:, 2] << 4) | (s[:, 3] << 6)


def unpack_dirs(packed: torch.Tensor, Rb: int, Cloc: int) -> torch.Tensor:
    """The kernel's packed diagonal layout -> (Rb, Cloc) int8 codes."""
    p = packed.reshape(-1)
    flat = torch.stack([(p >> (2 * u)) & 3 for u in range(4)], 1).reshape(-1)
    return _skewed(flat, Rb, Cloc).to(torch.int8)


def band_walk(blocks: torch.Tensor, R: int, C: int, *, nb: int, Rb: int,
              Cloc: int) -> np.ndarray:
    """Walk-order path codes from (R, C) to (0, 0) over ``blocks``
    ((D * nb, dirs_bytes(Rb, Cloc)) uint8; block d * nb + b is rank d's
    band b)."""
    if kernels.check_device(blocks, "band_walk") == "cpu":
        return band_walk_plain(blocks, R, C, nb=nb, Rb=Rb, Cloc=Cloc)
    bs = dirs_bytes(Rb, Cloc)
    if blocks.dtype != torch.uint8 or not blocks.is_contiguous() \
            or blocks.numel() % bs or R > nb * Rb \
            or C > blocks.numel() // bs // nb * Cloc:
        raise ValueError("band_walk: blocks must be contiguous uint8 "
                         "(D * nb, dirs_bytes(Rb, Cloc)) covering (R, C)")
    dev = blocks.device
    path = torch.empty(max(1, R + C), dtype=torch.int8, device=dev)
    nsteps = torch.empty(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        kernels.COUNTS["band"] += 1
        kernels.call("csa_band_walk", blocks.data_ptr(), bs, nb, Rb, Cloc,
                     R, C, path.data_ptr(), nsteps.data_ptr(),
                     kernels.stream_ptr(dev))
    n = int(nsteps.cpu()[0])
    return path[:n].cpu().numpy()


def band_walk_plain(blocks: torch.Tensor, R: int, C: int, *, nb: int,
                    Rb: int, Cloc: int) -> np.ndarray:
    """The plain version of :func:`band_walk`: a host walk of the same
    packed blocks."""
    Q = (Cloc + 4) // 4
    blk = blocks.cpu().numpy().reshape(-1, dirs_bytes(Rb, Cloc))
    out = []
    j, c = R, C
    while j > 0 and c > 0:
        d, b = (c - 1) // Cloc, (j - 1) // Rb
        cl, jl = c - d * Cloc, j - b * Rb
        code = (int(blk[d * nb + b, (jl + cl) * Q + (cl >> 2)])
                >> (2 * (cl & 3))) & 3
        out.append(code)
        if code != D_LEFT:
            j -= 1
        if code != D_UP:
            c -= 1
    out.extend([D_UP] * j)
    out.extend([D_LEFT] * c)
    return np.asarray(out, dtype=np.int8)
