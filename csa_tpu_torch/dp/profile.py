"""Batched progressive profile DP: fill + backtrack (counterpart of
:mod:`csa_tpu.dp.pallas_profile` and the device glue of
:mod:`csa_tpu.dp.wavefront`).

``profile_paths(items, device)`` takes the same
``(row_codes, scorevector, i, top_row, edge_rowgap)`` items as
``csa_tpu.dp.pallas_profile.profile_paths_pallas`` (the output of
``GapProgressiveState.prepare``) and returns the same walk-order path
codes (D_DIAG 0, D_LEFT 1, D_UP 2, from (R, C) back to (0, 0)), which
:func:`csa_tpu_torch.align.progressive._path_to_maps` consumes.
:func:`profile_paths_sharded` splits a batch over the ranks of a mesh
(the counterpart of ``csa_tpu.dp.wavefront.dp_paths_device_sharded``).

On a CUDA device the batch goes to the hand-written kernel
(``csrc/profile_dp.cu``): one block per gap fills the DP by
anti-diagonals, a second kernel walks the packed directions, and only the
paths come back.  The kernel takes each gap's exact R and C; there is no
shape bucketing.  On the CPU the plain version runs: the row-by-row
closed form of ``csa_tpu/dp/wavefront.py:_row_step`` (the left-gap chain
as a ``cummax``), batched over gaps, then a host walk of the direction
matrix.  Any other device raises.

Scoring is explicit: ``match``, ``mismatch``, ``indel``, ``doublegap``
(see :func:`csa_tpu_torch.config.from_jax_config`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import kernels
from ..parallel.sharded import join_streams, on_rank, rank_streams

D_DIAG, D_LEFT, D_UP = 0, 1, 2
GAP = 4
THREADS_MAX = 1024


def _pad_items(items: Sequence[tuple]):
    """Pad a list of fills to one (G, Rmax, Cmax) host batch (no bucketing)."""
    G = len(items)
    Rmax = max(1, max(len(it[0]) for it in items))
    Cmax = max(1, max(len(it[1]) for it in items))
    codes = np.zeros((G, Rmax), dtype=np.int8)
    sv = np.zeros((G, Cmax, 5), dtype=np.int32)
    top = np.zeros((G, Cmax + 1), dtype=np.int32)
    iv = np.zeros(G, dtype=np.int32)
    erg = np.zeros(G, dtype=np.int32)
    rr = np.zeros(G, dtype=np.int32)
    cc = np.zeros(G, dtype=np.int32)
    for g, (row_codes, svec, i, top_row, e) in enumerate(items):
        R, C = len(row_codes), len(svec)
        codes[g, :R] = row_codes
        sv[g, :C] = svec
        top[g, : C + 1] = np.asarray(top_row)[: C + 1]
        iv[g], erg[g], rr[g], cc[g] = i, e, R, C
    return codes, sv, top, iv, erg, rr, cc


def _channels(sv, iv, *, match, mismatch, indel, doublegap):
    """Per-column scores: colsub (G, C, 5) by row code (code 4 = no count,
    as the JAX kernels treat it), cg (G, C) left-move cost, rowgap (G,)."""
    svg = sv[..., GAP]
    rest = (indel - mismatch) * svg + mismatch * iv[:, None]
    colsub = torch.cat(
        [(match - mismatch) * sv[..., :4] + rest[..., None], rest[..., None]],
        dim=-1,
    )
    cg = doublegap * svg + indel * (iv[:, None] - svg)
    return colsub, cg, indel * iv


def default_top_row(scorevector, i: int, *, indel: int, doublegap: int):
    """Fresh dp[0][*] boundary under explicit scoring
    (csa_tpu.align.progressive.default_top_row)."""
    sv_gap = np.asarray(scorevector)[:, GAP].astype(np.int64)
    colgap = doublegap * sv_gap + indel * (i - sv_gap)
    return np.concatenate([[np.int64(0)], np.cumsum(colgap)])


def dirs_bytes(R: int, C: int) -> int:
    """Packed direction bytes of one gap in the kernel's diagonal layout."""
    return (R + C + 1) * ((C + 4) // 4)


def profile_paths(items: Sequence[tuple], device, *, match: int = 1,
                  mismatch: int = -1, indel: int = -1,
                  doublegap: int = 0) -> List[np.ndarray]:
    """Batched fill + backtrack; returns per-item walk-order path codes."""
    device = torch.device(device)
    if device.type == "cpu":
        return profile_paths_plain(items, device, match=match,
                                   mismatch=mismatch, indel=indel,
                                   doublegap=doublegap)
    if device.type != "cuda":
        raise ValueError(f"profile_paths: no kernel for device {device}")
    if not items:
        return []
    return _collect(*_launch_paths(items, device, match=match,
                                   mismatch=mismatch, indel=indel,
                                   doublegap=doublegap))


def _launch_paths(items: Sequence[tuple], device, *, match, mismatch,
                  indel, doublegap):
    """Upload a batch and launch the kernel on ``device``'s current
    stream; returns the device (paths, nsteps) without waiting."""
    codes, sv, top, iv, erg, rr, cc = _pad_items(items)
    G, Rmax = codes.shape
    Cmax = sv.shape[1]
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    codes_t, sv_t, top_t = put(codes), put(sv), put(top)
    iv_t, erg_t, rr_t, cc_t = put(iv), put(erg), put(rr), put(cc)
    colsub, cg, rowgap = _channels(sv_t, iv_t, match=match,
                                   mismatch=mismatch, indel=indel,
                                   doublegap=doublegap)
    colsub = colsub.to(torch.int32).contiguous()
    cg = cg.to(torch.int32).contiguous()
    rowgap = rowgap.to(torch.int32).contiguous()

    sizes = [dirs_bytes(int(r), int(c)) for r, c in zip(rr, cc)]
    offs = np.zeros(G, dtype=np.int64)
    offs[1:] = np.cumsum(sizes)[:-1]
    dirs = torch.empty(int(sum(sizes)), dtype=torch.uint8, device=device)
    offs_t = put(offs)
    smem = 3 * (Cmax + 1) * 4
    use_smem = smem <= kernels.smem_optin()
    scratch = (torch.empty(0, dtype=torch.int32, device=device) if use_smem
               else torch.empty((G, 3, Cmax + 1), dtype=torch.int32,
                                device=device))
    threads = min(THREADS_MAX, max(32, -(-((Cmax + 4) // 4) // 32) * 32))
    paths = torch.empty((G, Rmax + Cmax), dtype=torch.int8, device=device)
    nsteps = torch.empty(G, dtype=torch.int32, device=device)
    kernels.COUNTS["profile_dp"] += 1
    kernels.call(
        "csa_profile_paths", codes_t.data_ptr(), Rmax, colsub.data_ptr(),
        cg.data_ptr(), top_t.data_ptr(), Cmax, rowgap.data_ptr(),
        erg_t.data_ptr(), rr_t.data_ptr(), cc_t.data_ptr(),
        offs_t.data_ptr(), dirs.data_ptr(),
        scratch.data_ptr() if not use_smem else None, int(use_smem),
        threads, G, paths.data_ptr(), nsteps.data_ptr(),
        kernels.stream_ptr(device),
    )
    return paths, nsteps


def _collect(paths: torch.Tensor, nsteps: torch.Tensor) -> List[np.ndarray]:
    paths_h = paths.cpu().numpy()
    n_h = nsteps.cpu().numpy()
    return [paths_h[g, : int(n_h[g])].copy() for g in range(len(n_h))]


def rank_chunks(n_items: int, n_ranks: int) -> List[slice]:
    """Contiguous per-rank slices of a batch, as the ``P("gap")`` shard of
    ``csa_tpu.dp.wavefront._pad_batch(items, g_multiple=n_ranks)`` cuts
    it: the batch is padded to ``max(8, 2^k) >= n_items``, rounded up to
    a multiple of ``n_ranks``, and each rank takes an equal share."""
    gp = max(8, 1 << (n_items - 1).bit_length())
    per = -(-gp // n_ranks)
    return [slice(min(d * per, n_items), min((d + 1) * per, n_items))
            for d in range(n_ranks)]


def profile_paths_sharded(items: Sequence[tuple], mesh, *, match: int = 1,
                          mismatch: int = -1, indel: int = -1,
                          doublegap: int = 0) -> List[np.ndarray]:
    """:func:`profile_paths` with the batch split over the ranks of
    ``mesh`` (:func:`rank_chunks`): one launch per rank with items, on the
    rank's device and stream, so the ranks of one card overlap; results
    in item order."""
    sc = dict(match=match, mismatch=mismatch, indel=indel,
              doublegap=doublegap)
    chunks = rank_chunks(len(items), mesh.size)
    streams = rank_streams(mesh)
    launched = []
    for dev, stream, chunk in zip(mesh.devices, streams, chunks):
        part = items[chunk]
        if not part:
            continue
        if dev.type != "cuda":  # paths now (the CPU), or it raises
            launched.append(profile_paths(part, dev, **sc))
            continue
        with on_rank(stream):
            launched.append(_launch_paths(part, dev, **sc))
    join_streams(streams)  # the device results are ready from here on
    return [p for res in launched
            for p in (res if isinstance(res, list) else _collect(*res))]


def profile_paths_plain(items: Sequence[tuple], device, *, match: int = 1,
                        mismatch: int = -1, indel: int = -1,
                        doublegap: int = 0) -> List[np.ndarray]:
    """The plain PyTorch version: row-by-row closed-form fill on
    ``device`` (batched over gaps), then a host walk of the directions."""
    if not items:
        return []
    device = torch.device(device)
    codes, sv, top, iv, erg, rr, cc = _pad_items(items)
    G, Rmax = codes.shape
    Cmax = sv.shape[1]
    put = lambda a: torch.from_numpy(a).to(device=device, dtype=torch.int64)  # noqa: E731
    codes_t, sv_t, prev = put(codes).clamp(0, 4), put(sv), put(top)
    iv_t, erg_t = put(iv), put(erg)
    colsub, cg, rowgap = _channels(sv_t, iv_t, match=match,
                                   mismatch=mismatch, indel=indel,
                                   doublegap=doublegap)
    S = torch.cat([torch.zeros((G, 1), dtype=torch.int64, device=device),
                   torch.cumsum(cg, 1)], 1)
    dirs = torch.empty((G, Rmax, Cmax + 1), dtype=torch.int8, device=device)
    dirs[:, :, 0] = D_UP
    for j in range(1, Rmax + 1):
        b = codes_t[:, j - 1]
        sub = torch.gather(colsub, 2, b[:, None, None].expand(G, Cmax, 1))[..., 0]
        diag = prev[:, :-1] + sub
        up = prev[:, 1:] + rowgap[:, None]
        dwin = diag >= up
        m1 = torch.where(dwin, diag, up)
        t0 = (j * erg_t)[:, None]
        cur = torch.cummax(torch.cat([t0, m1 - S[:, 1:]], 1), 1).values + S
        left = cur[:, :-1] + cg
        take_left = (left > m1) | ((left == m1) & ~dwin)
        d = torch.where(dwin, D_DIAG, D_UP)
        dirs[:, j - 1, 1:] = torch.where(take_left, D_LEFT, d).to(torch.int8)
        prev = cur
    dirs_h = dirs.cpu().numpy()
    return [_walk(dirs_h[g], int(rr[g]), int(cc[g])) for g in range(G)]


def _walk(dirs: np.ndarray, R: int, C: int) -> np.ndarray:
    """Backtrack (dynamicprogramming.c:1032-1138 order) over a (rows, C+1)
    direction matrix whose row j-1 holds dp row j."""
    out = []
    j, c = R, C
    while j > 0 and c > 0:
        d = int(dirs[j - 1, c])
        out.append(d)
        if d != D_LEFT:
            j -= 1
        if d != D_UP:
            c -= 1
    out.extend([D_UP] * j)
    out.extend([D_LEFT] * c)
    return np.asarray(out, dtype=np.int8)


def profile_path(row_codes, scorevector, i: int, top_row=None,
                 edge_rowgap=None, *, device, match: int = 1,
                 mismatch: int = -1, indel: int = -1,
                 doublegap: int = 0) -> np.ndarray:
    """Single-gap fill + backtrack; returns the walk-order path codes."""
    if top_row is None:
        top_row = default_top_row(scorevector, i, indel=indel,
                                  doublegap=doublegap)
    if edge_rowgap is None:
        edge_rowgap = indel * i
    item = (row_codes, scorevector, i, top_row, edge_rowgap)
    return profile_paths([item], device, match=match, mismatch=mismatch,
                         indel=indel, doublegap=doublegap)[0]
