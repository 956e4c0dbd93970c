"""Circular conservation plot (``I`` mode).

Behavioral equivalent of the reference renderer
(``source/graphics.c:1365-1784``
``DrawCircularAlignmentPlot``): one concentric band per sequence (outer =
first), each band 5 rings deep; every ring pixel aggregates a run of
alignment columns and is colored by conservation (green -> red) and gap
frequency (blue); grey start markers, sequence labels, 8 position marks,
and the conservation / gap-frequency legends.

The reference re-reads the alignment file character by character per
pixel (the dominant wall-clock cost of its full pipeline); here the
per-column conservation and gap counts are prefix-summed once a
sequence and each ring pixel aggregates its run of columns from them.

The plot is a raster of color ids, not of colors: a ring pixel's id is
``conscolor * 256 + gapcolor``, and the background and every fixed draw
over the rings (markers, labels, position marks, legends) take
``FIXED`` plus their color's number.  The native host library paints
and counts it (``native.circular_plot_raster``; :func:`_raster_numpy`
on the ``numpy`` route or without the library), and the palette comes
from the ids the image holds: their colors, merged where two ids share
one, through the BMP writer's quantizer (:func:`bmp.quantize`).
"""

from __future__ import annotations

import functools
import math
import sys
from typing import List, Optional, TextIO

import numpy as np

from .. import native
from ..utils import PROFILER
from .bmp import quantize, write_indexed_bmp
from .canvas import Canvas, line_pixels, text_pixels

BAND = 5
GREY = (128, 128, 128)
BLACK = (0, 0, 0)
WHITE = (255, 255, 255)
# ring pixels' ids lie below FIXED; FIXED + n is fixed color number n
# (the background, WHITE, is number 0)
FIXED = 1 << 16


def _parse_alignment(path: str):
    descs: List[str] = []
    rows: List[bytes] = []
    cur: List[bytes] = []
    for raw in open(path, "rb").read().split(b"\n"):
        raw = raw.rstrip(b"\r")
        if raw.startswith(b">"):
            if cur:
                rows.append(b"".join(cur))
                cur = []
            descs.append(raw[1:].decode("ascii", "replace"))
        elif raw:
            cur.append(raw)
    if cur:
        rows.append(b"".join(cur))
    return descs, rows


def _ring_pixels_scalar(r: int):
    """Scalar quarter-arc walk: the exactness twin of :func:`_ring_pixels`
    (used directly for tiny radii, and as the oracle in tests)."""
    xs: List[int] = []
    ys: List[int] = []
    # top,right: x = 1..x45
    y = -r
    x = 1
    while x <= -y:
        dy = -math.sqrt(r * r - x * x)
        xs.append(x)
        ys.append(math.floor(dy))
        y = math.floor(dy)
        x += 1
    # right: y from -(x+1)..x  (x is one past the 45-degree point)
    y0 = -(x - 1 + 1)
    for y in range(y0, x - 1 + 1):
        dx = math.sqrt(r * r - y * y)
        xs.append(math.floor(dx))
        ys.append(y)
    x = math.floor(math.sqrt(r * r - y * y))
    # down: x from (y-1) while -x <= y
    xq = x  # after right quarter, reference x = floor(...)
    x = y - 1
    while -x <= y:
        dy = math.sqrt(r * r - x * x)
        xs.append(x)
        ys.append(math.floor(dy))
        x -= 1
    y = math.floor(math.sqrt(r * r - (x + 1) * (x + 1)))
    # left: y from -(x-1) down while -y <= -x
    x = x + 1  # last x of previous loop body
    yv = -(x - 1)
    while -yv <= -x:
        dx = -math.sqrt(r * r - yv * yv)
        xs.append(math.ceil(dx))
        ys.append(yv)
        yv -= 1
    x2 = math.ceil(-math.sqrt(r * r - (yv + 1) * (yv + 1)))
    # top,left: x from (y+1)..-1
    for x in range(yv + 1, 0):
        dy = -math.sqrt(r * r - x * x)
        xs.append(x)
        ys.append(math.floor(dy))
    return np.asarray(xs, dtype=np.int64), np.asarray(ys, dtype=np.int64)


@functools.lru_cache(maxsize=512)
def _ring_pixels(r: int):
    """Enumerate the circle of radius r exactly like the reference's four
    quarter-arc walks (graphics.c:1443-1702), returning (xs, ys) offsets
    in traversal order (starting at the top, clockwise).

    Vectorized form of :func:`_ring_pixels_scalar`: only the first
    quarter's stop column depends on the walk itself (x advances while
    x <= -y_prev, and -y_prev = ceil(sqrt(r^2 - (x-1)^2)) is
    non-increasing, so the condition holds on a prefix); every other
    quarter is a closed range once that stop column s is known.  Same
    float64 sqrt/floor/ceil arithmetic, bit-identical pixel lists
    (tests/test_artifacts.py::test_ring_pixels_vectorized_exact).
    """
    if r < 16:
        return _ring_pixels_scalar(r)
    rr = float(r) * float(r)
    t = np.arange(1.0, float(r) + 1.0)
    bound = -np.floor(-np.sqrt(rr - (t - 1.0) ** 2))  # = -y_{x-1}
    cond = t <= bound
    n1 = int(np.argmin(cond)) if not cond.all() else len(cond)
    s = n1 + 1  # the x value that first fails the quarter-1 condition
    xs1 = np.arange(1.0, s)
    ys1 = np.floor(-np.sqrt(rr - xs1 * xs1))
    ys2 = np.arange(float(-s), float(s))
    xs2 = np.floor(np.sqrt(rr - ys2 * ys2))
    xs3 = np.arange(float(s - 2), float(-s), -1.0)
    ys3 = np.floor(np.sqrt(rr - xs3 * xs3))
    ys4 = np.arange(float(s), float(-s), -1.0)
    xs4 = np.ceil(-np.sqrt(rr - ys4 * ys4))
    xs5 = np.arange(float(1 - s), 0.0)
    ys5 = np.floor(-np.sqrt(rr - xs5 * xs5))
    xs = np.concatenate([xs1, xs2, xs3, xs4, xs5]).astype(np.int64)
    ys = np.concatenate([ys1, ys2, ys3, ys4, ys5]).astype(np.int64)
    return xs, ys


@functools.lru_cache(maxsize=16)
def _ring_table(center: int, numseqs: int):
    """Every ring's points in painting order (depth ``k`` outer,
    sequence ``i`` inner, radius ``center + (numseqs - i) * 3 BAND - k``):
    (xs, ys) int32 offsets from the image's center, concatenated, and the
    int64 offsets of the rings in them (one past the last at the end)."""
    parts = [_ring_pixels(center + (numseqs - i) * 3 * BAND - k)
             for k in range(BAND) for i in range(numseqs)]
    offsets = np.zeros(len(parts) + 1, dtype=np.int64)
    np.cumsum([len(xs) for xs, _ in parts], out=offsets[1:])
    xs = np.concatenate([xs for xs, _ in parts]).astype(np.int32)
    ys = np.concatenate([ys for _, ys in parts]).astype(np.int32)
    for a in (xs, ys, offsets):
        a.setflags(write=False)
    return xs, ys, offsets


class _Overlay:
    """The draws over the rings, in order: the flat index of each of
    their pixels inside the ``size`` x ``size`` image and its id,
    ``FIXED`` plus its color's number."""

    def __init__(self, size: int):
        self.size = size
        self.numbers = {WHITE: 0}
        self._flat: List[np.ndarray] = []
        self._ids: List[np.ndarray] = []

    def _number(self, color) -> int:
        return self.numbers.setdefault(color, len(self.numbers))

    def _points(self, xs, ys, ids) -> None:
        xs = np.asarray(xs, dtype=np.int64)
        ys = np.asarray(ys, dtype=np.int64)
        ok = (xs >= 0) & (xs < self.size) & (ys >= 0) & (ys < self.size)
        self._flat.append(ys[ok] * self.size + xs[ok])
        self._ids.append(np.broadcast_to(ids, ok.shape)[ok])

    def vline(self, x: int, y0: int, y1: int, color) -> None:
        self.columns(x, y0, y1, [color])

    def hline(self, x0: int, x1: int, y: int, color) -> None:
        xs = np.arange(min(x0, x1), max(x0, x1) + 1)
        self._points(xs, np.full_like(xs, y), FIXED + self._number(color))

    def columns(self, x: int, y0: int, y1: int, colors) -> None:
        """Vertical lines from ``y0`` to ``y1`` at ``x``, ``x + 1``, ...,
        one a color of ``colors``."""
        ids = FIXED + np.array([self._number(c) for c in colors])
        ys = np.arange(min(y0, y1), max(y0, y1) + 1)
        self._points(np.repeat(x + np.arange(len(ids)), len(ys)),
                     np.tile(ys, len(ids)), np.repeat(ids, len(ys)))

    def line(self, x0: int, y0: int, x1: int, y1: int, color) -> None:
        xs, ys, _ = line_pixels(x0, y0, x1, y1)
        self._points(xs, ys, FIXED + self._number(color))

    def text(self, x: int, y: int, s: str, color) -> None:
        self._points(*text_pixels(x, y, s), FIXED + self._number(color))

    def pixels(self):
        """(flat int64, ids int32) of every draw, in drawing order."""
        return (np.concatenate(self._flat),
                np.concatenate(self._ids).astype(np.int32))


def _raster_numpy(rows, ring_x, ring_y, ring_offsets, center, size,
                  overlay_px, overlay_ids, background, ncounts):
    """The numpy twin of ``native.circular_plot_raster`` (the same
    arguments and result): the per-column tallies, each sequence's
    prefix sums, each ring's run of columns a point, then its points and
    their lower neighbours painted by fancy index, later writes
    winning."""
    numseqs, seqsize = rows.shape
    mat = np.where((rows >= 97) & (rows <= 122), rows - 32, rows)
    counts = np.zeros((5, seqsize), dtype=np.int64)  # -,A,C,G,T
    for ci, ch in enumerate(b"-ACGT"):
        counts[ci] = (mat == ch).sum(axis=0)
    conserv = np.zeros((numseqs, seqsize), dtype=np.int64)
    for ci, ch in enumerate(b"ACGT"):
        sel = mat == ch
        conserv[sel] = np.broadcast_to(counts[ci + 1], mat.shape)[sel]
    isgap = (mat == ord("-")).astype(np.int64)
    zero = np.zeros((numseqs, 1), dtype=np.int64)
    csum = np.concatenate([zero, np.cumsum(conserv, axis=1)], axis=1)
    gsum = np.concatenate([zero, np.cumsum(isgap, axis=1)], axis=1)

    ids = np.full((size, size), background, dtype=np.int32)
    for j in range(len(ring_offsets) - 1):
        i = j % numseqs
        a, b = ring_offsets[j], ring_offsets[j + 1]
        npoints = int(b - a)
        ppp = seqsize / npoints
        ends = np.floor(np.arange(1, npoints + 1) * ppp).astype(np.int64)
        ends = np.minimum(ends, seqsize)
        starts = np.concatenate([[0], ends[:-1]])
        n = np.maximum(ends - starts, 1)
        cons = csum[i][ends] - csum[i][starts]
        gaps = gsum[i][ends] - gsum[i][starts]
        conscolor = np.floor(cons * 255 / (numseqs * n)).astype(np.int64)
        gapcolor = np.floor(gaps * 255 / n).astype(np.int64)
        cid = conscolor * 256 + gapcolor
        px = center + ring_x[a:b].astype(np.int64)
        py = center + ring_y[a:b].astype(np.int64)
        ok = (px >= 0) & (px < size) & (py >= 0) & (py < size)
        ids[py[ok], px[ok]] = cid[ok]
        # the reference draws ceil and floor pixels of each arc point;
        # paint the neighbor ring position too to avoid holes
        ids[np.minimum(py[ok] + 1, size - 1), px[ok]] = cid[ok]
    flat = ids.reshape(-1)
    flat[overlay_px] = overlay_ids
    return ids, np.bincount(flat, minlength=ncounts)


def _ring_rgb(ids: np.ndarray) -> np.ndarray:
    """(N, 3) int64 colors of ring ids ``conscolor * 256 + gapcolor``:
    conservation from green to red, gap frequency in blue."""
    conscolor = ids >> 8
    gapcolor = ids & 0xFF
    notcons = (255 - (conscolor + gapcolor)) & 0xFF
    add = np.where(
        (conscolor >= notcons) & (conscolor >= gapcolor),
        255 - conscolor,
        np.where(notcons >= gapcolor, 255 - notcons, 255 - gapcolor),
    )
    return np.stack([np.clip(conscolor + add, 0, 255),
                     np.clip(notcons + add, 0, 255),
                     np.clip(gapcolor, 0, 255)], axis=1)


def _palette(counts: np.ndarray, fixed: np.ndarray):
    """(palette, lut, colors) of an id image from ``counts``, its pixels
    of each id: the palette of its distinct colors (:func:`quantize`),
    each id's index into it (uint8; 0 for an id the image lacks), and
    how many distinct colors it holds.  ``fixed[n]`` is fixed color
    ``n``'s RGB."""
    used = np.flatnonzero(counts)
    ring = used < FIXED
    rgb = np.concatenate([_ring_rgb(used[ring]),
                          fixed[used[~ring] - FIXED]]).astype(np.int64)
    keys = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    # ids that share a color merge; their pixels add up (int64, as a
    # bincount over the RGB image's pixels counted them)
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    first = np.ones(len(keys), dtype=bool)
    first[1:] = keys[1:] != keys[:-1]
    starts = np.flatnonzero(first)
    palette, key_lut = quantize(keys[starts],
                                np.add.reduceat(counts[used[order]], starts))
    lut = np.zeros(len(counts), dtype=np.uint8)
    lut[used[order]] = key_lut[np.cumsum(first) - 1]
    return palette, lut, len(starts)


def draw_circular_alignment_plot(
    alignment_path: str,
    image_path: str,
    *,
    log: Optional[TextIO] = None,
    backend: str = "device",
) -> Optional[str]:
    """Draw the plot of an aligned FASTA into ``image_path``.  The
    ``numpy`` route (``backend``) paints with :func:`_raster_numpy`;
    every other route with the native host library when it loads."""
    log = log if log is not None else sys.stdout
    print("> Drawing circular alignment plot... ", end="", file=log)
    descs, rows = _parse_alignment(alignment_path)
    numseqs = len(rows)
    if numseqs < 2:
        print("\n> ERROR: Not enough sequences in file", file=log)
        return None
    if len({len(r) for r in rows}) != 1:
        print("\n> ERROR: Consensus sizes don't match", file=log)
        return None
    seqsize = len(rows[0])

    bandgap = 2 * BAND
    center = bandgap * numseqs
    if center < 50:
        center = 100
    diameter = 2 * (center + numseqs * (BAND + bandgap) + BAND) + 1
    digits = len(str(seqsize))
    diameter += 2 * (6 * digits + 6)
    xc = (diameter + 1) // 2
    yc = (diameter + 1) // 2

    ring_x, ring_y, ring_offsets = _ring_table(center, numseqs)
    if (np.diff(ring_offsets) > seqsize).any():
        print(
            "\n> ERROR: Sequence length is too short to draw "
            "correct circular plot.",
            file=log,
        )
        return None
    radii = [center + (numseqs - i) * (BAND + bandgap) for i in range(numseqs)]
    cv = _Overlay(diameter)

    # start markers + labels
    for i in range(numseqs):
        r = radii[i]
        cv.vline(xc, yc - r, yc - r + BAND, GREY)
        label = descs[i][:64]
        tw = Canvas.text_width(label)
        cv.text(xc - tw // 2, yc - (r - BAND - 1), label, BLACK)

    # position marks: 8 ticks with numbers
    line = 5
    interval = seqsize / 8.0
    r0 = radii[0]
    cv.vline(xc, yc - r0 - line, yc - r0, BLACK)
    cv.text(xc + 2, yc - r0 - line - 8, "0", BLACK)
    cv.text(xc + 2, yc - r0 - line - 16, str(seqsize), BLACK)
    cv.vline(xc, yc + r0 + 1, yc + r0 + line + 1, BLACK)
    cv.text(xc, yc + r0 + line + 3, str(math.floor(4 * interval)), BLACK)
    cv.hline(xc - r0 - line, xc - r0, yc, BLACK)
    t = str(math.floor(6 * interval))
    cv.text(xc - r0 - line - Canvas.text_width(t) - 2, yc - 3, t, BLACK)
    cv.hline(xc + r0 + 1, xc + r0 + line + 1, yc, BLACK)
    cv.text(xc + r0 + line + 3, yc - 3, str(math.floor(2 * interval)), BLACK)
    d45 = int(r0 / math.sqrt(2))
    for mark, sx, sy in ((1, 1, -1), (3, 1, 1), (5, -1, 1), (7, -1, -1)):
        cv.line(
            xc + sx * d45, yc + sy * d45,
            xc + sx * (d45 + line), yc + sy * (d45 + line), BLACK,
        )
        t = str(math.floor(mark * interval))
        tx = xc + sx * (d45 + line + 2)
        if sx < 0:
            tx -= Canvas.text_width(t)
        ty = yc + sy * (d45 + line + 2) - 3
        cv.text(tx, ty, t, BLACK)

    # legends (bottom-right): conservation gradient + gap gradient
    n = 12 * 6
    x = diameter - 1 - 6
    y = diameter - 1 - 6 * 7
    cv.text(x - Canvas.text_width("Conservation"), y, "Conservation", BLACK)
    y += 7
    step = 255.0 / (n / 2 - 1)
    cv.columns(x - n, y, y + 6,
               [(255, int(i * step + 0.5), 0) for i in range(n // 2)]
               + [(int((n - 1 - i) * step + 0.5), 255, 0)
                  for i in range(n // 2, n)])
    cv.text(x - Canvas.text_width("+          -"), y, "+          -", BLACK)
    y += 14
    cv.text(x - Canvas.text_width("GapFrequency"), y, "GapFrequency", BLACK)
    y += 7
    gaps = [min(int((i // 2) * step + 0.5), 255) for i in range(n)]
    cv.columns(x - n, y, y + 6, [(v, v, 255) for v in gaps])
    cv.text(x - Canvas.text_width("+          -"), y, "+          -", BLACK)

    overlay_px, overlay_ids = cv.pixels()
    mat = np.frombuffer(b"".join(rows), dtype=np.uint8).reshape(
        numseqs, seqsize)
    args = (mat, ring_x, ring_y, ring_offsets, xc, diameter, overlay_px,
            overlay_ids, FIXED, FIXED + len(cv.numbers))
    raster = native.circular_plot_raster(*args) if backend != "numpy" \
        else None
    PROFILER.add("report.plot_native", int(raster is not None))
    ids, counts = raster if raster is not None else _raster_numpy(*args)
    palette, lut, colors = _palette(
        counts, np.array(list(cv.numbers), dtype=np.int64))
    PROFILER.add("report.plot_colors", colors)
    write_indexed_bmp(image_path, palette, lut.take(ids))
    print("OK", file=log)
    return image_path
