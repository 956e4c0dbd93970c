"""One band of the column-sharded profile DP, and the walk over the bands
(counterpart of :mod:`csa_tpu.dp.pallas_band`).

:func:`band_fill` fills one band of one rank: ``Rb`` rows by ``Cloc``
columns of the profile-DP recurrence, with the top boundary row
(``Cloc + 1`` values, index 0 the left-halo element) and the left boundary
column (``Rb`` values) given.  It returns the band's directions in the
profile DP's tiled layout for an ``Rb x Cloc`` gap
(:func:`csa_tpu_torch.dp.profile.dirs_address`: 2 bits a cell, "left
beats diag" and "up beats both"), its bottom row (``Cloc + 1`` values,
index 0 the left boundary) and its right-edge column (``Rb`` values, the
halo of the next rank).  :func:`band_walk` walks the per-(rank, band)
blocks from (R, C) back to (0, 0) and returns the walk-order path codes.

On a CUDA tensor each wrapper launches its kernel (``csrc/band.cu``, an
entry into the profile DP's tile engine ``csrc/tile_dp.cuh``); on a CPU
tensor it runs its plain version: the row-scan closed form of
``csa_tpu/dp/seqpar.py`` (the in-row left-gap chain as a ``cummax``)
packed into the same layout, and a host walk.  Any other device raises.
:func:`cell_bits` and :func:`unpack_dirs` turn a packed block back into
``(Rb, Cloc)`` cells.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from . import profile
from .profile import D_DIAG, D_LEFT, D_UP


def dirs_bytes(Rb: int, Cloc: int) -> int:
    """Packed direction bytes of one band: the tiled layout of an
    ``Rb x Cloc`` gap."""
    return profile.dirs_bytes(Rb, Cloc)


class Scratch:
    """What the band launches of one shape need besides their operands,
    made once: the one-gap tile table and ticket order, the
    boundary store, and the ticket counter with one ready flag a tile
    (which each launch zeroes first).  Launches that share a scratch must
    run one after another (on one stream)."""

    def __init__(self, Rb: int, Cloc: int, rowgap: int, device):
        meta, _, bnd_total, T = profile.batch_layout([Rb], [Cloc])
        meta[0, 2] = rowgap
        ntr, ntc = profile.tile_grid(Rb, Cloc)
        self.T = T
        # a tile anti-diagonal holds at most min(ntr, ntc) tiles; as many
        # workers again take the next tickets and stage them
        self.workers = min(T, 2 * min(ntr, ntc))
        self.strip, self.tile_cols = profile.STRIP, profile.TILE_COLS
        self.meta = torch.from_numpy(meta).to(device)
        self.order = torch.from_numpy(
            profile.tile_order([Rb], [Cloc])).to(device)
        self.bnd = torch.empty(bnd_total, dtype=torch.int32, device=device)
        self.ctrl = torch.empty(1 + T, dtype=torch.int32, device=device)
        self.key = (Rb, Cloc, int(rowgap), self.ctrl.device)


def scratch_for(Rb: int, Cloc: int, rowgap: int, device) -> Optional[Scratch]:
    """The scratch of band launches of this shape on ``device``; None on
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return Scratch(Rb, Cloc, rowgap, device)


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
              scratch: Optional[Scratch] = None):
    """Fill one band; returns ``(dirs, bottom, edge)``, written into
    ``out`` when given.  codes: (Rb,) int8; colsub: (Cloc, 5), cg:
    (Cloc,), top: (Cloc + 1,), left: (Rb,) int32 (dp/profile.py's
    ``_channels`` builds colsub, cg and rowgap).  ``scratch`` is
    :func:`scratch_for`'s; passing it keeps the launch free of
    allocations and uploads."""
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
        scratch = scratch_for(Rb, Cloc, rowgap, dev)
    elif scratch.key != (Rb, Cloc, int(rowgap), dev) or \
            (scratch.strip, scratch.tile_cols) != (profile.STRIP,
                                                   profile.TILE_COLS):
        raise ValueError("band_fill: the scratch was made for another band "
                         "shape, rowgap, device or tile")
    dirs, bottom, edge = out
    s = scratch
    with torch.cuda.device(dev):
        kernels.COUNTS["band"] += 1
        kernels.call(
            "csa_band_fill", codes.data_ptr(), colsub.data_ptr(),
            cg.data_ptr(), top.data_ptr(), left.data_ptr(),
            s.meta.data_ptr(), s.order.data_ptr(), s.T, s.ctrl.data_ptr(),
            s.bnd.data_ptr(), dirs.data_ptr(), bottom.data_ptr(),
            edge.data_ptr(), Rb, s.strip, s.tile_cols, s.workers,
            kernels.stream_ptr(dev),
        )
    return out


def band_fill_plain(codes, colsub, cg, rowgap: int, top, left):
    """The plain PyTorch version of :func:`band_fill`, on the inputs'
    device: a row loop of the closed form, both direction bits of every
    cell, then :func:`pack_dirs`."""
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
    cells = torch.empty((Rb, Cloc), dtype=torch.int8, device=dev)
    edge = torch.empty(Rb, dtype=torch.int64, device=dev)
    for r in range(Rb):
        diag = prev[:-1] + sub[b[r]]
        up = prev[1:] + rowgap
        m1 = torch.maximum(diag, up)
        cur = torch.cummax(torch.cat([lft[r:r + 1], m1 - S[1:]]), 0).values + S
        via_left = cur[:-1] + cgl
        left_wins = diag < via_left
        up_wins = torch.maximum(diag, via_left) < up
        cells[r] = (left_wins.to(torch.int8)
                    | (up_wins.to(torch.int8) << 1))
        edge[r] = cur[-1]
        prev = cur
    return pack_dirs(cells), prev.to(torch.int32), edge.to(torch.int32)


def _geometry(Rb: int, Cloc: int):
    """Strip, lanes, tile columns and the tile grid of an Rb x Cloc band."""
    return (profile.STRIP, profile.LANES, profile.TILE_COLS,
            *profile.tile_grid(Rb, Cloc))


def _lane_roll(words: torch.Tensor, sign: int) -> torch.Tensor:
    """Along dim 2 (Tc) of (ntr, ntc, Tc, lanes) words: entry q of lane t
    takes entry (q + sign * t) mod Tc.  sign -1 turns columns into slots
    (slot q of lane t holds column q - t), sign +1 back."""
    _, _, Tc, L = words.shape
    q = torch.arange(Tc, device=words.device)[:, None]
    t = torch.arange(L, device=words.device)[None, :]
    idx = ((q + sign * t) % Tc).expand(words.shape)
    return torch.gather(words, 2, idx)


def pack_dirs(cells: torch.Tensor) -> torch.Tensor:
    """(Rb, Cloc) cells, bit 0 "left beats diag" and bit 1 "up beats both"
    (the codes D_DIAG, D_LEFT, D_UP are such cells) -> the kernel's tiled
    layout; the bytes of a ragged tile that hold no cell are 0."""
    Rb, Cloc = cells.shape
    S, L, Tc, ntr, ntc = _geometry(Rb, Cloc)
    dev = cells.device
    full = torch.zeros((ntr * L * S, ntc * Tc), dtype=torch.int64,
                       device=dev)
    full[:Rb, :Cloc] = cells
    full = full.view(ntr, L, S, ntc, Tc)
    k = torch.arange(S, device=dev).view(1, 1, S, 1, 1)
    words = (((full & 1) << (S - 1 - k))
             | (((full >> 1) & 1) << (2 * S - 1 - k))).sum(2)
    words = _lane_roll(words.permute(0, 2, 3, 1), -1)  # (ntr, ntc, slot, t)
    shifts = 8 * torch.arange(S // 4, device=dev)
    return ((words[..., None] >> shifts) & 255).to(torch.uint8).reshape(-1)


def cell_bits(packed: torch.Tensor, Rb: int, Cloc: int) -> torch.Tensor:
    """The kernel's tiled layout -> (Rb, Cloc) int8 cells, both direction
    bits (bit 0 "left beats diag", bit 1 "up beats both")."""
    S, L, Tc, ntr, ntc = _geometry(Rb, Cloc)
    nbytes = S // 4
    dev = packed.device
    b = packed.reshape(ntr, ntc, Tc, L, nbytes).long()
    words = (b << (8 * torch.arange(nbytes, device=dev))).sum(-1)
    words = _lane_roll(words, 1).permute(0, 3, 1, 2)  # (ntr, t, ntc, x)
    k = torch.arange(S, device=dev).view(1, 1, S, 1, 1)
    w = words[:, :, None]
    cells = ((w >> (S - 1 - k)) & 1) | (((w >> (2 * S - 1 - k)) & 1) << 1)
    return cells.reshape(ntr * L * S, ntc * Tc)[:Rb, :Cloc].to(torch.int8)


def unpack_dirs(packed: torch.Tensor, Rb: int, Cloc: int) -> torch.Tensor:
    """The kernel's tiled layout -> (Rb, Cloc) int8 direction codes (UP
    where "up beats both", else LEFT where "left beats diag", else
    DIAG)."""
    return cell_bits(packed, Rb, Cloc).clamp(max=D_UP)


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
                     R, C, profile.STRIP, profile.TILE_COLS, path.data_ptr(),
                     nsteps.data_ptr(), kernels.stream_ptr(dev))
    n = int(nsteps.cpu()[0])
    return path[:n].cpu().numpy()


def band_walk_plain(blocks: torch.Tensor, R: int, C: int, *, nb: int,
                    Rb: int, Cloc: int) -> np.ndarray:
    """The plain version of :func:`band_walk`: a host walk of the same
    packed blocks, a cell's word and bit from
    :func:`csa_tpu_torch.dp.profile.dirs_address`."""
    S = profile.STRIP
    words = np.ascontiguousarray(blocks.cpu().numpy()).reshape(
        -1, dirs_bytes(Rb, Cloc)).view(f"<u{S // 4}")
    out = []
    j, c = R, C
    while j > 0 and c > 0:
        d, b = (c - 1) // Cloc, (j - 1) // Rb
        word, bit = profile.dirs_address(Rb, Cloc, j - b * Rb, c - d * Cloc)
        bits = int(words[d * nb + b, word]) >> int(bit)
        code = D_UP if (bits >> S) & 1 else D_LEFT if bits & 1 else D_DIAG
        out.append(code)
        if code != D_LEFT:
            j -= 1
        if code != D_UP:
            c -= 1
    out.extend([D_UP] * j)
    out.extend([D_LEFT] * c)
    return np.asarray(out, dtype=np.int8)
