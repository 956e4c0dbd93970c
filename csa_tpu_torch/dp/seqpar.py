"""Column-sharded profile DP for ONE giant gap (counterpart of
:mod:`csa_tpu.dp.seqpar` and of the programs of
:mod:`csa_tpu.dp.pallas_band`).

The DP of one merge (R rows x C columns) is split by columns over the D
ranks of a mesh: rank d owns columns ``d*Cloc+1 .. (d+1)*Cloc``.  Rows go
in bands of ``band_rows``; in superstep s rank d fills band s - d with
one :func:`csa_tpu_torch.dp.band.band_fill`, so after D - 1 supersteps
every rank works.  A band's top boundary is the rank's slice of the
(possibly stale) global top row for band 0, else the rank's own previous
bottom row; its left boundary is ``j * edge_rowgap`` on rank 0, else the
right-edge column that rank d - 1 wrote for the same band (JAX's
``ppermute`` halo).  On CUDA each rank runs on its own stream: the
sender records an event after its band and the receiver's stream waits
on it, then reads the sender's edge buffer in place on the same card or
after a copy from another card.  Every buffer (one halo and one bottom
row per rank and band, and one band scratch per rank, which the rank's
bands reuse one after another on its stream) is allocated before the
supersteps, on the caller's stream, and the caller's stream waits on
every rank at the end, so the caching allocator never reuses a buffer a
rank still reads.

The blocks of every (rank, band) end on rank 0's device (JAX's
all-gather; on one card nothing moves), where one walk
(:func:`csa_tpu_torch.dp.band.band_walk`) returns the O(R + C) path
codes.  With one rank, :func:`dp_path_seqpar` takes the full-matrix
profile kernel instead, as ``csa_tpu/dp/seqpar.py:266-274`` does.

On a mesh that spans processes, a giant runs over the ranks of this
process alone (:func:`..parallel.sharded.local_mesh`), and every
process fills and walks it: ``csa_tpu/dp/seqpar.py`` places no data
across processes, so no halo crosses a process, and every process ends
with the same path, which its host merge needs.
Integer max/plus with the same boundary operands gives the same
directions as the single-device fill, bit for bit.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..parallel.sharded import (Mesh, join_streams, local_mesh, on_rank,
                                rank_streams)
from . import band, profile
from .profile import D_DIAG, D_LEFT, D_UP

BAND_ROWS = 2048  # rows of a band (csa_tpu/dp/pallas_band.py:415)


def _pad_for_mesh(row_codes, scorevector, top_row, D: int, Rb: int):
    """Pad rows to a multiple of Rb and columns to a multiple of D
    (``csa_tpu/dp/seqpar.py:_pad_for_mesh`` without its lane rounding)."""
    R, C = len(row_codes), len(scorevector)
    Rp = max(Rb, -(-R // Rb) * Rb)
    Cp = max(D, -(-C // D) * D)
    codes = np.zeros(Rp, dtype=np.int8)
    codes[:R] = row_codes
    sv = np.zeros((Cp, 5), dtype=np.int64)
    sv[:C] = scorevector
    top = np.zeros(Cp + 1, dtype=np.int32)
    top[: C + 1] = np.asarray(top_row)[: C + 1]
    return codes, sv, top, Rp, Cp


def _boundaries(scorevector, i, top_row, edge_rowgap, indel, doublegap):
    if top_row is None:
        top_row = profile.default_top_row(scorevector, i, indel=indel,
                                          doublegap=doublegap)
    if edge_rowgap is None:
        edge_rowgap = indel * i
    return top_row, edge_rowgap


def fill_blocks(row_codes, scorevector, i: int, mesh: Mesh, *,
                band_rows: int, top_row, edge_rowgap: int, match: int,
                mismatch: int, indel: int, doublegap: int):
    """Fill every band of every rank.  Returns ``(blocks, nb, Rb, Cloc)``:
    blocks is (D * nb, dirs_bytes(Rb, Cloc)) uint8 on rank 0's device,
    block ``d * nb + b`` holding rank d's band b."""
    D = mesh.size
    Rb = int(band_rows)
    codes, sv, top, Rp, Cp = _pad_for_mesh(row_codes, scorevector, top_row,
                                           D, Rb)
    Cloc, nb = Cp // D, Rp // Rb
    colsub, cg, rowgap = profile._channels(
        torch.from_numpy(sv)[None], torch.tensor([int(i)]), match=match,
        mismatch=mismatch, indel=indel, doublegap=doublegap)
    colsub, cg = colsub[0].to(torch.int32), cg[0].to(torch.int32)
    rowgap = int(rowgap[0])
    # rank 0's left boundary: j * edge_rowgap at global row j
    edge0 = torch.from_numpy(
        (np.arange(1, Rp + 1, dtype=np.int64) * int(edge_rowgap))
        .astype(np.int32).reshape(nb, Rb))
    dev0 = mesh.devices[0]
    blocks = torch.empty((D * nb, band.dirs_bytes(Rb, Cloc)),
                         dtype=torch.uint8, device=dev0)
    codes_on = {}
    ranks = []
    for d, dev in enumerate(mesh.devices):
        if dev not in codes_on:
            codes_on[dev] = torch.from_numpy(codes).to(dev)
        cols = slice(d * Cloc, (d + 1) * Cloc)
        tops = torch.empty((nb + 1, Cloc + 1), dtype=torch.int32, device=dev)
        tops[0] = torch.from_numpy(top[d * Cloc: d * Cloc + Cloc + 1])
        if d == 0:
            left = edge0.to(dev)
        elif dev == mesh.devices[d - 1]:
            left = None  # read the neighbour's edge buffer in place
        else:
            left = torch.empty((nb, Rb), dtype=torch.int32, device=dev)
        ranks.append(SimpleNamespace(
            codes=codes_on[dev],
            colsub=colsub[cols].contiguous().to(dev),
            cg=cg[cols].contiguous().to(dev),
            tops=tops,
            edges=torch.empty((nb, Rb), dtype=torch.int32, device=dev),
            left=left,
            gather=dev != dev0,
            dirs=(torch.empty((nb, blocks.shape[1]), dtype=torch.uint8,
                              device=dev) if dev != dev0 else
                  blocks[d * nb:(d + 1) * nb]),
            scratch=band.scratch_for(Rb, Cloc, rowgap, dev),
        ))
    streams = rank_streams(mesh)
    done = {}
    for s in range(nb + D - 1):
        for d in range(max(0, s - nb + 1), min(D, s + 1)):
            b = s - d
            rk, stream = ranks[d], streams[d]
            with on_rank(stream):
                if d > 0 and stream is not None:
                    stream.wait_event(done[d - 1, b])
                if d > 0 and rk.left is None:
                    left = ranks[d - 1].edges[b]
                else:
                    left = rk.left[b]
                    if d > 0:
                        # a peer copy runs on the source device's current
                        # stream: make that the sender's
                        with on_rank(streams[d - 1]):
                            left.copy_(ranks[d - 1].edges[b],
                                       non_blocking=True)
                band.band_fill(rk.codes[b * Rb:(b + 1) * Rb], rk.colsub,
                               rk.cg, rowgap, rk.tops[b], left,
                               out=(rk.dirs[b], rk.tops[b + 1], rk.edges[b]),
                               scratch=rk.scratch)
                if stream is not None:
                    done[d, b] = torch.cuda.Event()
                    done[d, b].record(stream)
    for d, (rk, stream) in enumerate(zip(ranks, streams)):
        if rk.gather:
            with on_rank(stream):
                blocks[d * nb:(d + 1) * nb].copy_(rk.dirs, non_blocking=True)
    join_streams(streams)
    return blocks, nb, Rb, Cloc


def dp_path_seqpar(row_codes, scorevector, i: int, mesh: Mesh, *,
                   band_rows=None, top_row=None, edge_rowgap=None,
                   match: int = 1, mismatch: int = -1, indel: int = -1,
                   doublegap: int = 0) -> np.ndarray:
    """Column-sharded fill + walk of ONE giant merge over ``mesh`` (the
    ranks this process drives of it); returns the walk-order path codes,
    the same as every other route.
    ``band_rows`` defaults to :data:`BAND_ROWS`."""
    mesh = local_mesh(mesh, "col")
    sc = dict(match=match, mismatch=mismatch, indel=indel,
              doublegap=doublegap)
    top_row, edge_rowgap = _boundaries(scorevector, i, top_row, edge_rowgap,
                                       indel, doublegap)
    if mesh.size == 1:
        # no halo to pass: the full-matrix kernel beats banding
        return profile.profile_path(row_codes, scorevector, i, top_row,
                                    edge_rowgap, device=mesh.devices[0],
                                    **sc)
    blocks, nb, Rb, Cloc = fill_blocks(
        row_codes, scorevector, i, mesh,
        band_rows=band_rows or BAND_ROWS, top_row=top_row,
        edge_rowgap=edge_rowgap, **sc)
    return band.band_walk(blocks, len(row_codes), len(scorevector), nb=nb,
                          Rb=Rb, Cloc=Cloc)


def dp_fill_seqpar(row_codes, scorevector, i: int, mesh: Mesh, *,
                   band_rows=None, top_row=None, edge_rowgap=None,
                   match: int = 1, mismatch: int = -1, indel: int = -1,
                   doublegap: int = 0) -> np.ndarray:
    """The column-sharded fill's full (R + 1, C + 1) int8 direction
    matrix, boundaries included (``csa_tpu/dp/seqpar.py:dp_fill_seqpar``)."""
    mesh = local_mesh(mesh, "col")
    top_row, edge_rowgap = _boundaries(scorevector, i, top_row, edge_rowgap,
                                       indel, doublegap)
    R, C = len(row_codes), len(scorevector)
    blocks, nb, Rb, Cloc = fill_blocks(
        row_codes, scorevector, i, mesh,
        band_rows=band_rows or BAND_ROWS, top_row=top_row,
        edge_rowgap=edge_rowgap, match=match, mismatch=mismatch,
        indel=indel, doublegap=doublegap)
    D = mesh.size
    full = np.zeros((nb * Rb + 1, D * Cloc + 1), dtype=np.int8)
    for d in range(D):
        for b in range(nb):
            rows = slice(1 + b * Rb, 1 + (b + 1) * Rb)
            cols = slice(1 + d * Cloc, 1 + (d + 1) * Cloc)
            full[rows, cols] = band.unpack_dirs(blocks[d * nb + b], Rb,
                                                Cloc).cpu().numpy()
    dirs = full[: R + 1, : C + 1].copy()
    dirs[:, 0] = D_UP
    dirs[0, 1:] = D_LEFT
    dirs[0, 0] = D_DIAG
    return dirs
