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
(``csrc/profile_dp.cu``) as ONE launch of many workers: every gap is cut
into tiles of ``TILE_ROWS x TILE_COLS`` cells, :func:`tile_order` numbers
the tiles of the whole batch so that a tile's predecessors come first,
and each worker (a warp that keeps its strip of the tile in registers)
takes tickets from a counter, waits for the ready flags of the tile above
and the tile to the left, fills its tile and sets its own flag.  A second
kernel walks the packed directions (one warp per gap, a tile at a time
through shared memory), and only the paths come back.  The kernel takes
each gap's exact R and C from per-gap offsets into concatenated arrays;
there is no padding and no shape bucketing.  On the CPU the plain version
runs: the row-by-row closed form of ``csa_tpu/dp/wavefront.py:_row_step``
(the left-gap chain as a ``cummax``), batched over gaps, then a host walk
of the direction matrix.  Any other device raises.

Scoring is explicit: ``match``, ``mismatch``, ``indel``, ``doublegap``
(see :func:`csa_tpu_torch.config.from_jax_config`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .. import kernels
from ..parallel.sharded import (Ranks, join_streams, on_rank, rank_streams,
                                unzip)

D_DIAG, D_LEFT, D_UP = 0, 1, 2
GAP = 4
# the kernel's tile: a warp of LANES lanes, STRIP rows a lane (8 or 16),
# TILE_COLS columns (a power of two, 32..1024); WORKERS_PER_SM warps an SM
LANES = 32
STRIP = 8
TILE_COLS = 256
WORKERS_PER_SM = 4


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


def tile_rows() -> int:
    return LANES * STRIP


def tile_grid(R: int, C: int):
    """(tile rows, tile columns) of an R x C gap."""
    return -(-R // tile_rows()), -(-C // TILE_COLS)


def tile_bytes() -> int:
    """Direction bytes of one tile, 2 bits a cell; an edge tile takes as
    many."""
    return tile_rows() * TILE_COLS // 4


def dirs_bytes(R: int, C: int) -> int:
    """Packed direction bytes of one gap in the kernel's tiled layout."""
    ntr, ntc = tile_grid(R, C)
    return ntr * ntc * tile_bytes()


def dirs_address(R: int, C: int, j, c):
    """(word, bit) of cell (j, c) inside a gap's direction store,
    1 <= j <= R, 1 <= c <= C (arrays broadcast): the kernel's addressing.
    The store is words of ``2 * STRIP`` bits.  Tiles lie row-major; inside
    a tile, word ``((x + t) mod TILE_COLS) * LANES + t`` holds column x of
    lane t's strip in two planes of STRIP bits, row k of the strip at bit
    ``STRIP - 1 - k`` of each: the low plane says "left beats diag", the
    high plane (``bit + STRIP``) "up beats both"."""
    j, c = np.asarray(j, dtype=np.int64), np.asarray(c, dtype=np.int64)
    ntc = tile_grid(R, C)[1]
    tr, rl = np.divmod(j - 1, tile_rows())
    tc, x = np.divmod(c - 1, TILE_COLS)
    t, k = np.divmod(rl, STRIP)
    word = ((tr * ntc + tc) * (TILE_COLS * LANES)
            + ((x + t) % TILE_COLS) * LANES + t)
    return word, STRIP - 1 - k


def tile_order(rr, cc) -> np.ndarray:
    """The ticket order of a batch's tiles: (T, 3) int32 rows (gap, tile
    row, tile column), sorted by tile anti-diagonal, then gap, then tile
    row.  The tile above and the tile to the left of a tile lie on the
    anti-diagonal before its own, so both hold lower tickets; the gaps
    are interleaved, so a large gap's long tail starts beside the small
    gaps and not after them."""
    parts = []
    for g, (R, C) in enumerate(zip(rr, cc)):
        ntr, ntc = tile_grid(int(R), int(C))
        tr, tc = np.divmod(np.arange(ntr * ntc, dtype=np.int64), max(ntc, 1))
        parts.append(np.stack([np.full_like(tr, g), tr, tc], axis=1))
    tiles = (np.concatenate(parts) if parts
             else np.zeros((0, 3), dtype=np.int64))
    key = np.lexsort((tiles[:, 1], tiles[:, 0], tiles[:, 1] + tiles[:, 2]))
    return np.ascontiguousarray(tiles[key].astype(np.int32))


def _exclusive(sizes) -> np.ndarray:
    """Offsets of consecutive segments of the given sizes."""
    off = np.zeros(len(sizes), dtype=np.int64)
    off[1:] = np.cumsum(sizes, dtype=np.int64)[:-1]
    return off


def batch_layout(rr, cc):
    """The kernel's per-gap table, (G, 10) int64: R, C, rowgap and edge
    rowgap (columns 2 and 3, filled by the caller), and the offsets of the
    gap's codes, columns, top row, direction bytes, boundary store (int32
    elements: tile rows x (C + 1), then tile columns x (R + 1)) and
    flags (one a tile) in the batch's concatenated arrays.  Returns
    (table, direction bytes, boundary elements, tiles) of the batch."""
    rr = np.asarray(rr, dtype=np.int64)
    cc = np.asarray(cc, dtype=np.int64)
    ntr = -(-rr // tile_rows())
    ntc = -(-cc // TILE_COLS)
    sizes = {4: rr, 5: cc, 6: cc + 1, 7: ntr * ntc * tile_bytes(),
             8: ntr * (cc + 1) + ntc * (rr + 1), 9: ntr * ntc}
    meta = np.zeros((len(rr), 10), dtype=np.int64)
    meta[:, 0], meta[:, 1] = rr, cc
    for col, size in sizes.items():
        meta[:, col] = _exclusive(size)
    return meta, int(sizes[7].sum()), int(sizes[8].sum()), int(sizes[9].sum())


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
    return _launch(_upload(items, device, match=match, mismatch=mismatch,
                           indel=indel, doublegap=doublegap))


def _upload(items: Sequence[tuple], device, *, match: int = 1,
            mismatch: int = -1, indel: int = -1, doublegap: int = 0) -> dict:
    """A batch on ``device`` as the kernel takes it: every gap's exact
    rows and columns, concatenated, with the per-gap table, the ticket
    order and the launch's scratch (allocated on the current stream)."""
    device = torch.device(device)
    rr = np.array([len(it[0]) for it in items], dtype=np.int64)
    cc = np.array([len(it[1]) for it in items], dtype=np.int64)
    iv = np.array([it[2] for it in items], dtype=np.int64)
    meta, dirs_total, bnd_total, T = batch_layout(rr, cc)
    meta[:, 2] = indel * iv
    meta[:, 3] = [it[4] for it in items]
    order = tile_order(rr, cc)
    codes = np.concatenate(
        [np.asarray(it[0]).astype(np.int8) for it in items])
    sv = np.concatenate(
        [np.asarray(it[1]).reshape(-1, 5).astype(np.int32) for it in items])
    top = np.concatenate(
        [np.asarray(it[3])[: C + 1].astype(np.int32)
         for it, C in zip(items, cc)])
    put = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    # the concatenated columns as one-column gaps, each with its gap's i
    colsub, cg, _ = _channels(put(sv)[:, None, :],
                              put(np.repeat(iv, cc).astype(np.int32)),
                              match=match, mismatch=mismatch, indel=indel,
                              doublegap=doublegap)
    G = len(items)
    L = int((rr + cc).max())
    empty = lambda n, dt: torch.empty(int(n), dtype=dt, device=device)  # noqa: E731
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dict(
        device=device, G=G, T=T, L=L,
        workers=max(1, min(T, sms * WORKERS_PER_SM)),
        strip=STRIP, tile_cols=TILE_COLS,
        codes=put(codes),
        colsub=colsub.to(torch.int32).reshape(-1, 5).contiguous(),
        cg=cg.to(torch.int32).reshape(-1).contiguous(), top=put(top),
        meta=put(meta), order=put(order),
        ctrl=empty(1 + T, torch.int32),
        bnd=empty(bnd_total, torch.int32),
        dirs=empty(dirs_total, torch.uint8),
        paths=torch.empty((G, L), dtype=torch.int8, device=device),
        nsteps=empty(G, torch.int32),
    )


def _launch(b: dict):
    """The fill launch and the walk launch of an uploaded batch on the
    current stream of its device; returns (paths, nsteps)."""
    _launch_fill(b)
    return _launch_walk(b)


def _launch_fill(b: dict) -> None:
    with torch.cuda.device(b["device"]):
        b["ctrl"].zero_()  # the ticket counter and every tile's flag
        kernels.COUNTS["profile_dp"] += 1
        kernels.call(
            "csa_profile_fill", b["codes"].data_ptr(), b["colsub"].data_ptr(),
            b["cg"].data_ptr(), b["top"].data_ptr(), b["meta"].data_ptr(),
            b["order"].data_ptr(), b["T"], b["ctrl"].data_ptr(),
            b["bnd"].data_ptr(), b["dirs"].data_ptr(), b["strip"],
            b["tile_cols"], b["workers"], kernels.stream_ptr(b["device"]),
        )


def _launch_walk(b: dict):
    with torch.cuda.device(b["device"]):
        kernels.call(
            "csa_profile_walk", b["dirs"].data_ptr(), b["meta"].data_ptr(),
            b["strip"], b["tile_cols"], b["G"], b["L"],
            b["paths"].data_ptr(), b["nsteps"].data_ptr(),
            kernels.stream_ptr(b["device"]),
        )
    return b["paths"], b["nsteps"]


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
    in item order.  On a mesh across processes each process fills its
    own ranks' chunks, and every process returns every path
    (:func:`_gather_paths`)."""
    sc = dict(match=match, mismatch=mismatch, indel=indel,
              doublegap=doublegap)
    chunks = rank_chunks(len(items), mesh.size)
    if mesh.world is not None:
        return _gather_paths(items, mesh, chunks, sc)
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


def _gather_paths(items, mesh, chunks, sc: dict) -> List[np.ndarray]:
    """Every rank's paths on every process, in item order (the
    counterpart of ``csa_tpu.dp.wavefront._fetch_global``): each rank
    pads its chunk's paths to the longest path of the batch, found by a
    ``pmax`` over the ranks, and to the largest chunk; one gather of the
    paths and one of their step counts bring the whole batch to every
    process's home rank."""
    ranks = Ranks(mesh)
    per = max(c.stop - c.start for c in chunks)

    def fill(r, chunk):
        part = items[chunk]
        dev = mesh.devices[r]
        if dev.type != "cuda":  # the plain version, or it raises
            got = profile_paths(part, dev, **sc) if part else []
            n = torch.tensor([len(p) for p in got], dtype=torch.int32)
            paths = torch.zeros((len(got), int(n.max()) if got else 1),
                                dtype=torch.int8)
            for g, p in enumerate(got):
                paths[g, :len(p)] = torch.from_numpy(p)
            return paths, n
        if not part:
            return (torch.zeros((0, 1), dtype=torch.int8, device=dev),
                    torch.zeros(0, dtype=torch.int32, device=dev))
        return _launch_paths(part, dev, **sc)

    paths, nsteps = unzip(ranks.each(fill, chunks), 2)
    longest = max(1, ranks.item(ranks.pmax(ranks.each(
        lambda r, n: n.max() if len(n) else n.new_zeros(()), nsteps))))

    def pad(r, p, n):
        out_p = p.new_zeros((per, longest))
        out_n = n.new_zeros(per)
        w = min(longest, p.shape[1])
        out_p[:p.shape[0], :w] = p[:, :w]
        out_n[:n.shape[0]] = n
        return out_p, out_n

    padded, steps = unzip(ranks.each(pad, paths, nsteps), 2)
    padded = ranks.gather_to_first(padded)
    steps = ranks.gather_to_first(steps)
    ranks.finish(padded, steps)
    padded = padded.cpu().numpy()
    steps = steps.cpu().numpy()
    return [padded[d * per + g - c.start, :int(steps[d * per + g - c.start])]
            .copy() for d, c in enumerate(chunks)
            for g in range(c.start, c.stop)]


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
