"""Minimal 2D raster canvas + built-in bitmap font.

Own-design equivalent of the drawing layer in reference source/graphics.c
(lines/rects/text on a palette bitmap).  Uses a numpy RGB buffer and a
compact 3x5 pixel font covering the characters the reports need.  Lines
and text are computed as whole pixel arrays (:func:`line_pixels`,
:func:`text_pixels`), which the block map's and the circular plot's
indexed rasters share.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

Color = Tuple[int, int, int]

# 3x5 font: each glyph is 5 rows x 3 cols encoded as 15 bits, row-major,
# MSB = top-left.  Covers A-Z, 0-9 and the punctuation used in reports.
_F = {
    "A": "010101111101101", "B": "110101110101110", "C": "011100100100011",
    "D": "110101101101110", "E": "111100110100111", "F": "111100110100100",
    "G": "011100101101011", "H": "101101111101101", "I": "111010010010111",
    "J": "001001001101010", "K": "101110100110101", "L": "100100100100111",
    "M": "101111111101101", "N": "101111111111101", "O": "010101101101010",
    "P": "110101110100100", "Q": "010101101011001", "R": "110101110110101",
    "S": "011100010001110", "T": "111010010010010", "U": "101101101101011",
    "V": "101101101010010", "W": "101101111111101", "X": "101010010010101",
    "Y": "101101010010010", "Z": "111001010100111",
    "0": "010101101101010", "1": "010110010010111", "2": "110001010100111",
    "3": "110001010001110", "4": "101101111001001", "5": "111100110001110",
    "6": "011100110101010", "7": "111001010010010", "8": "010101010101010",
    "9": "010101011001110",
    ".": "000000000000010", ",": "000000000010100", "-": "000000111000000",
    "_": "000000000000111", ":": "000010000010000", "/": "001001010100100",
    "(": "001010010010001", ")": "100010010010100", " ": "000000000000000",
    "=": "000111000111000", ">": "100010001010100", "<": "001010100010001",
    "@": "010101101100011", "%": "101001010100101", "+": "000010111010000",
    "*": "000101010101000", "'": "010010000000000", "#": "101111101111101",
}


# every glyph of _F as a (5, 3) mask, in _F's order; a character _F
# lacks draws as the space
_GLYPH = {ch: i for i, ch in enumerate(_F)}
_MASKS = np.array(
    [[b == "1" for b in bits] for bits in _F.values()], dtype=bool
).reshape(-1, 5, 3)


def line_pixels(x0: Sequence[int], y0: Sequence[int], x1: Sequence[int],
                y1: Sequence[int]):
    """Every pixel of the all-octant Bresenham lines from (x0[i], y0[i])
    to (x1[i], y1[i]), both ends included, unclipped: (xs, ys, line),
    each line's pixels in drawing order and the lines in turn.

    The serial form (error ``err = dx - |dy|``; step x when ``2 err >=
    -|dy|``, y when ``2 err <= dx``) moves one pixel along the major axis
    a step, so a line has ``major + 1`` pixels, and after ``i`` steps it
    has moved ``(2 i minor + major) // (2 major)`` along the minor axis.
    """
    x0, y0, x1, y1 = (np.asarray(v, dtype=np.int64).reshape(-1)
                      for v in (x0, y0, x1, y1))
    dx, dy = x1 - x0, y1 - y0
    sx, sy = np.sign(dx), np.sign(dy)
    steep = np.abs(dy) > np.abs(dx)
    major = np.where(steep, np.abs(dy), np.abs(dx))
    # a line's start, its step a pixel and its step along the minor axis
    # (each as x, y), its minor and its major length
    per = np.stack([x0, y0, np.where(steep, 0, sx), np.where(steep, sy, 0),
                    np.where(steep, sx, 0), np.where(steep, 0, sy),
                    np.abs(dx) + np.abs(dy) - major, major])
    n = major + 1
    line = np.repeat(np.arange(len(n)), n)
    i = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    x, y, ux, uy, vx, vy, minor, big = per[:, line]
    off = (2 * i * minor + big) // np.maximum(2 * big, 1)
    return x + ux * i + vx * off, y + uy * i + vy * off, line


def text_pixels(x: int, y: int, s: str):
    """The pixels of ``s`` (upper-cased) in the 3x5 font from (x, y),
    4 pixels a character, unclipped: (xs, ys)."""
    ids = np.array([_GLYPH.get(ch, _GLYPH[" "]) for ch in s.upper()],
                   dtype=np.intp)
    k, r, c = np.nonzero(_MASKS[ids])
    return x + 4 * k + c, y + r


class Canvas:
    def __init__(self, width: int, height: int, background: Color = (255, 255, 255)):
        self.width = width
        self.height = height
        self.img = np.zeros((height, width, 3), dtype=np.uint8)
        self.img[:, :] = background

    def _box(self, x0: int, y0: int, x1: int, y1: int, color: Color) -> None:
        """Fill the box with corners (x0, y0) and (x1, y1), in any order,
        clipped to the image."""
        xa, xb = max(0, min(x0, x1)), min(self.width - 1, max(x0, x1))
        ya, yb = max(0, min(y0, y1)), min(self.height - 1, max(y0, y1))
        if xa <= xb and ya <= yb:
            self.img[ya : yb + 1, xa : xb + 1] = color

    def hline(self, x0: int, x1: int, y: int, color: Color) -> None:
        self._box(x0, y, x1, y, color)

    def vline(self, x: int, y0: int, y1: int, color: Color) -> None:
        self._box(x, y0, x, y1, color)

    def _points(self, xs: np.ndarray, ys: np.ndarray, color: Color) -> None:
        ok = (xs >= 0) & (xs < self.width) & (ys >= 0) & (ys < self.height)
        # one color for every pixel: repeated pixels need no order
        self.img[ys[ok], xs[ok]] = color

    def line(self, x0: int, y0: int, x1: int, y1: int, color: Color) -> None:
        """Bresenham line."""
        xs, ys, _ = line_pixels(x0, y0, x1, y1)
        self._points(xs, ys, color)

    def text(self, x: int, y: int, s: str, color: Color) -> None:
        self._points(*text_pixels(x, y, s), color)

    @staticmethod
    def text_width(s: str) -> int:
        return 4 * len(s)
