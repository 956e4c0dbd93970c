"""ctypes loader for the port's native host kernels (its own copy of
:mod:`csa_tpu.native`, built from ``csa_host.cpp`` beside this file).

The library builds with ``make`` at first use into
``csa_tpu_torch/_build/libcsa_host_<hash>.so``, named by a hash of the
source and the Makefile, so a stale library is never loaded and the
JAX package's directory is never written.  Without a toolchain every
caller takes its pure-numpy twin; ``chip_smoke.py`` refuses a run in
which :func:`available` is False.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for the current source and Makefile lives."""
    h = hashlib.sha256()
    for name in ("csa_host.cpp", "Makefile"):
        h.update((_HERE / name).read_bytes())
    return BUILD_DIR / f"libcsa_host_{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["make", "-s", "-B", "-C", str(_HERE), f"OUT={tmp}"],
            check=True,
            capture_output=True,
            timeout=300,
        )
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from ..utils import PROFILER

    with PROFILER.startup_phase("startup.host_library"):
        return _bind()


def _bind() -> Optional[ctypes.CDLL]:
    """Build if needed and bind the library: the first :func:`_load`."""
    global _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    lib.csa_dp_fill.restype = ctypes.c_int32
    lib.csa_dp_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.csa_pairwise_nw.restype = ctypes.c_int32
    lib.csa_pairwise_nw.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.csa_dgc.restype = ctypes.c_int32
    lib.csa_dgc.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.csa_dp_fill_path.restype = ctypes.c_int32
    lib.csa_dp_fill_path.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.csa_install_scoring.restype = None
    lib.csa_install_scoring.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.csa_anchor_attach.restype = ctypes.c_int32
    lib.csa_anchor_attach.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.csa_anchor_group.restype = ctypes.c_int32
    lib.csa_anchor_group.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.csa_rotation_analyze.restype = ctypes.c_int32
    lib.csa_rotation_analyze.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.csa_linear_index.restype = ctypes.c_int32
    lib.csa_linear_index.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.csa_set_mt_threshold.restype = None
    lib.csa_set_mt_threshold.argtypes = [ctypes.c_int64]
    _lib = lib
    # the scoring installed before the lazy load
    from .. import config

    push_scoring(config.run_config().scoring)
    return _lib


def available() -> bool:
    return _load() is not None


def push_scoring(s) -> None:
    """Install a :class:`csa_tpu_torch.config.Scoring` into the host
    kernels if the library is loaded (:func:`_bind` pushes the installed
    one when it loads)."""
    if _lib is not None:
        _lib.csa_install_scoring(int(s.match), int(s.mismatch),
                                 int(s.indel), int(s.doublegap))


def set_mt_threshold(cells: int) -> bool:
    """Set the two-thread DP-fill dispatch threshold (cells); <= 0
    restores the default.  Returns False when the library is missing."""
    lib = _load()
    if lib is None:
        return False
    lib.csa_set_mt_threshold(int(cells))
    return True


def dp_fill_dirs(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    top_row: np.ndarray,
    edge_rowgap: int,
):
    """Native profile NW fill; returns (score, dirs) or None if no lib.

    top_row / edge_rowgap carry the (possibly stale) DP boundary values;
    see csa_host.cpp.
    """
    lib = _load()
    if lib is None:
        return None
    R = len(row_codes)
    C = len(scorevector)
    codes = np.ascontiguousarray(row_codes, dtype=np.int8)
    sv = np.ascontiguousarray(scorevector, dtype=np.int32)
    top = np.ascontiguousarray(top_row, dtype=np.int32)
    dirs = np.empty((R + 1, C + 1), dtype=np.int8)
    score = lib.csa_dp_fill(
        codes.ctypes.data, R, sv.ctypes.data, C, int(i),
        top.ctypes.data, int(edge_rowgap), dirs.ctypes.data
    )
    return int(score), dirs


def dp_fill_path(
    row_codes: np.ndarray,
    scorevector: np.ndarray,
    i: int,
    top_row: np.ndarray,
    edge_rowgap: int,
):
    """Native fill + backtrack; returns (score, walk-order path codes)
    or None if no lib.  The direction matrix never crosses into Python
    (see csa_host.cpp::csa_dp_fill_path)."""
    lib = _load()
    if lib is None:
        return None
    R = len(row_codes)
    C = len(scorevector)
    codes = np.ascontiguousarray(row_codes, dtype=np.int8)
    sv = np.ascontiguousarray(scorevector, dtype=np.int32)
    top = np.ascontiguousarray(top_row, dtype=np.int32)
    path = np.empty(R + C, dtype=np.int8)
    plen = np.zeros(1, dtype=np.int32)
    score = lib.csa_dp_fill_path(
        codes.ctypes.data, R, sv.ctypes.data, C, int(i),
        top.ctypes.data, int(edge_rowgap),
        path.ctypes.data, plen.ctypes.data,
    )
    if int(plen[0]) == 0 and (R or C):
        return None  # scratch allocation failure: use the numpy twin
    return int(score), path[: int(plen[0])]


def dgc(usableseqs, strings, numseqs, scorevector, consize, maxnongaps):
    """Native DeleteGappedColumns; returns the new consize or None.

    Packs the logical [0, consize) window of the usable rows into one
    contiguous matrix, runs csa_dgc in place, and copies the results back
    into the caller's per-sequence arrays and (int64) scorevector.
    """
    lib = _load()
    if lib is None:
        return None
    packed = np.empty((numseqs, max(consize, 1)), dtype=np.int8)
    for t in range(numseqs):
        packed[t, :consize] = strings[usableseqs[t]][:consize]
    sv32 = np.ascontiguousarray(scorevector[:consize], dtype=np.int32)
    new_consize = lib.csa_dgc(
        packed.ctypes.data, numseqs, packed.shape[1],
        sv32.ctypes.data, consize, maxnongaps,
    )
    for t in range(numseqs):
        strings[usableseqs[t]][:consize] = packed[t, :consize]
    scorevector[:consize] = sv32
    return int(new_consize)


class NativeRotationBlocks:
    """Result of the native rotation block stage (csa_rotation_analyze):
    every collected block with its suffix and uniqueness flags."""

    __slots__ = (
        "start", "end", "depth", "keep_suffix", "unique", "positions",
        "num_collected",
    )


def rotation_analyze(encoded, max_blocks: int = 8192):
    """Native host rotation block stage: cyclic suffix array + capped LCP
    (cyclic Kasai) + lcp-interval block collection + suffix/uniqueness
    filters, bit-identical to the numpy engine
    (csa_tpu_torch/index/cyclic.py).  Returns a NativeRotationBlocks or
    None when the library is missing.
    """
    lib = _load()
    if lib is None:
        return None
    k = len(encoded)
    offsets = np.zeros(k + 1, dtype=np.int64)
    np.cumsum([len(e) for e in encoded], out=offsets[1:])
    codes = np.concatenate(
        [np.asarray(e, dtype=np.int8) for e in encoded]
    )
    while True:
        counts = np.zeros(4, dtype=np.int32)
        bstart = np.empty(max_blocks, dtype=np.int32)
        bend = np.empty(max_blocks, dtype=np.int32)
        bdepth = np.empty(max_blocks, dtype=np.int32)
        keep = np.empty(max_blocks, dtype=np.uint8)
        uniq = np.empty(max_blocks, dtype=np.uint8)
        positions = np.empty((max_blocks, k), dtype=np.int64)
        rc = lib.csa_rotation_analyze(
            codes.ctypes.data, offsets.ctypes.data, k, max_blocks,
            counts.ctypes.data, bstart.ctypes.data, bend.ctypes.data,
            bdepth.ctypes.data, keep.ctypes.data, uniq.ctypes.data,
            positions.ctypes.data,
        )
        if rc == 0:
            break
        max_blocks = int(rc) + 1024  # needed block count; retry bigger
    nb = int(counts[1])
    out = NativeRotationBlocks()
    out.num_collected = nb
    out.start = bstart[:nb].astype(np.int64)
    out.end = bend[:nb].astype(np.int64)
    out.depth = bdepth[:nb].astype(np.int64)
    out.keep_suffix = keep[:nb].astype(bool)
    out.unique = uniq[:nb].astype(bool)
    out.positions = positions[:nb]
    return out


def linear_index(s: np.ndarray, sigma: int):
    """Suffix array + adjacent LCPs of one int string with embedded
    unique separators (values in [0, sigma)); returns (sa, lcp) int32
    arrays or None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    ss = np.ascontiguousarray(s, dtype=np.int32)
    total = len(ss)
    sa = np.empty(total, dtype=np.int32)
    lcp = np.empty(total, dtype=np.int32)
    lib.csa_linear_index(
        ss.ctypes.data, total, int(sigma), sa.ctypes.data, lcp.ctypes.data
    )
    return sa, lcp


def anchor_attach(seq_of: np.ndarray, lcp: np.ndarray, cap: np.ndarray,
                  k: int):
    """Native mstat/attachment stats over the linear suffix index;
    returns (att, lb2) int32 arrays or None if no lib (numpy twin in
    csa_tpu_torch/align/anchors.py)."""
    lib = _load()
    if lib is None:
        return None
    m = len(lcp)
    s32 = np.ascontiguousarray(seq_of, dtype=np.int32)
    l32 = np.ascontiguousarray(lcp, dtype=np.int32)
    c32 = np.ascontiguousarray(cap, dtype=np.int32)
    att = np.empty(m, dtype=np.int32)
    lb2 = np.empty(m, dtype=np.int32)
    lib.csa_anchor_attach(
        s32.ctypes.data, l32.ctypes.data, c32.ctypes.data, int(k), m,
        att.ctypes.data, lb2.ctypes.data,
    )
    return att, lb2


def anchor_group(seq_of: np.ndarray, pos_of: np.ndarray, att: np.ndarray,
                 lb2: np.ndarray, k: int):
    """Native grouping of the sorted suffix entries into border nodes
    (numpy twin: csa_tpu_torch/align/anchors.py::_group_border_nodes).
    Returns ``(depths, offsets, positions, grouped)`` or None if no lib:
    node ``t`` has depth ``depths[t]`` and, in sequence ``s``, the
    positions ``positions[offsets[t * k + s]:offsets[t * k + s + 1]]``;
    ``grouped`` counts the entries with ``att >= 1``."""
    lib = _load()
    if lib is None:
        return None
    m = len(att)
    s32 = np.ascontiguousarray(seq_of, dtype=np.int32)
    p32 = np.ascontiguousarray(pos_of, dtype=np.int32)
    a32 = np.ascontiguousarray(att, dtype=np.int32)
    l32 = np.ascontiguousarray(lb2, dtype=np.int32)
    if not len(s32) == len(p32) == len(l32) == m:
        raise ValueError("seq_of, pos_of, att and lb2 differ in length")
    if m and (l32.min() < 0 or l32.max() >= m or s32.min() < 0
              or s32.max() >= k):
        raise ValueError("lb2 must index the entries, seq_of one of k")
    cap = m // max(k, 1) + 1  # a node holds at least k entries
    depths = np.empty(cap, dtype=np.int32)
    offsets = np.empty(cap * k + 1, dtype=np.int32)
    positions = np.empty(m, dtype=np.int32)
    counts = np.zeros(3, dtype=np.int64)
    n = lib.csa_anchor_group(
        s32.ctypes.data, p32.ctypes.data, a32.ctypes.data, l32.ctypes.data,
        int(k), m, depths.ctypes.data, offsets.ctypes.data,
        positions.ctypes.data, counts.ctypes.data,
    )
    return (depths[:n], offsets[: n * k + 1], positions[: int(counts[2])],
            int(counts[0]))


def pairwise_nw(a: np.ndarray, b: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    aa = np.ascontiguousarray(a, dtype=np.int8)
    bb = np.ascontiguousarray(b, dtype=np.int8)
    return int(lib.csa_pairwise_nw(aa.ctypes.data, len(aa), bb.ctypes.data, len(bb)))
