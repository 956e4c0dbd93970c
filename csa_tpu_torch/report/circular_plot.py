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
per-column conservation and gap vectors are precomputed once and each
ring is aggregated with vectorized segment sums.
"""

from __future__ import annotations

import functools
import math
import sys
from typing import List, Optional, TextIO

import numpy as np

from .canvas import Canvas

BAND = 5
GREY = (128, 128, 128)
BLACK = (0, 0, 0)


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


def draw_circular_alignment_plot(
    alignment_path: str,
    image_path: str,
    *,
    log: Optional[TextIO] = None,
) -> Optional[str]:
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
    mat = np.stack([np.frombuffer(r, dtype=np.uint8) for r in rows])
    mat = np.where((mat >= 97) & (mat <= 122), mat - 32, mat)  # uppercase

    # per-column char counts and per-(seq,col) conservation / gap flags
    counts = np.zeros((5, seqsize), dtype=np.int64)  # -,A,C,G,T
    for ci, ch in enumerate(b"-ACGT"):
        counts[ci] = (mat == ch).sum(axis=0)
    conserv = np.zeros((numseqs, seqsize), dtype=np.int64)
    for ci, ch in enumerate(b"ACGT"):
        sel = mat == ch
        conserv[sel] = np.broadcast_to(counts[ci + 1], mat.shape)[sel]
    isgap = (mat == ord("-")).astype(np.int64)

    bandgap = 2 * BAND
    center = bandgap * numseqs
    if center < 50:
        center = 100
    diameter = 2 * (center + numseqs * (BAND + bandgap) + BAND) + 1
    digits = len(str(seqsize))
    diameter += 2 * (6 * digits + 6)
    cv = Canvas(diameter, diameter)
    xc = (diameter + 1) // 2
    yc = (diameter + 1) // 2

    csum = np.concatenate(
        [np.zeros((numseqs, 1), dtype=np.int64), np.cumsum(conserv, axis=1)],
        axis=1,
    )
    gsum = np.concatenate(
        [np.zeros((numseqs, 1), dtype=np.int64), np.cumsum(isgap, axis=1)],
        axis=1,
    )

    radii = [center + (numseqs - i) * (BAND + bandgap) for i in range(numseqs)]
    for k in range(BAND):
        for i in range(numseqs):
            r = radii[i] - k
            xs, ys = _ring_pixels(r)
            npoints = len(xs)
            if npoints > seqsize:
                print(
                    "\n> ERROR: Sequence length is too short to draw "
                    "correct circular plot.",
                    file=log,
                )
                return None
            ppp = seqsize / npoints
            ends = np.floor(np.arange(1, npoints + 1) * ppp).astype(np.int64)
            ends = np.minimum(ends, seqsize)
            starts = np.concatenate([[0], ends[:-1]])
            n = np.maximum(ends - starts, 1)
            cons = csum[i][ends] - csum[i][starts]
            gaps = gsum[i][ends] - gsum[i][starts]
            conscolor = np.floor(cons * 255 / (numseqs * n)).astype(np.int64)
            gapcolor = np.floor(gaps * 255 / n).astype(np.int64)
            notcons = (255 - (conscolor + gapcolor)) & 0xFF
            add = np.where(
                (conscolor >= notcons) & (conscolor >= gapcolor),
                255 - conscolor,
                np.where(notcons >= gapcolor, 255 - notcons, 255 - gapcolor),
            )
            red = np.clip(conscolor + add, 0, 255)
            green = np.clip(notcons + add, 0, 255)
            blue = np.clip(gapcolor, 0, 255)
            px = xc + xs
            py = yc + ys
            ok = (px >= 0) & (px < diameter) & (py >= 0) & (py < diameter)
            cv.img[py[ok], px[ok], 0] = red[ok]
            cv.img[py[ok], px[ok], 1] = green[ok]
            cv.img[py[ok], px[ok], 2] = blue[ok]
            # the reference draws ceil and floor pixels of each arc point;
            # paint the neighbor ring position too to avoid holes
            cv.img[np.clip(py[ok] + 1, 0, diameter - 1), px[ok], 0] = red[ok]
            cv.img[np.clip(py[ok] + 1, 0, diameter - 1), px[ok], 1] = green[ok]
            cv.img[np.clip(py[ok] + 1, 0, diameter - 1), px[ok], 2] = blue[ok]

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
    for i in range(n // 2):
        col = (255, int(i * step + 0.5), 0)
        cv.vline(x - n + i, y, y + 6, col)
    for i in range(n // 2, n):
        col = (int((n - 1 - i) * step + 0.5), 255, 0)
        cv.vline(x - n + i, y, y + 6, col)
    cv.text(x - Canvas.text_width("+          -"), y, "+          -", BLACK)
    y += 14
    cv.text(x - Canvas.text_width("GapFrequency"), y, "GapFrequency", BLACK)
    y += 7
    for i in range(n):
        v = int((i // 2) * step + 0.5)
        cv.vline(x - n + i, y, y + 6, (min(v, 255), min(v, 255), 255))
    cv.text(x - Canvas.text_width("+          -"), y, "+          -", BLACK)

    cv.save_bmp(image_path)
    print("OK", file=log)
    return image_path
