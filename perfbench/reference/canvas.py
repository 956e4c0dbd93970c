"""Minimal 2D raster canvas + built-in bitmap font.

Own-design equivalent of the drawing layer in reference source/graphics.c
(lines/rects/text on a palette bitmap).  Uses a numpy RGB buffer and a
compact 3x5 pixel font covering the characters the reports need.
"""

from __future__ import annotations

from typing import Tuple

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


class Canvas:
    def __init__(self, width: int, height: int, background: Color = (255, 255, 255)):
        self.width = width
        self.height = height
        self.img = np.zeros((height, width, 3), dtype=np.uint8)
        self.img[:, :] = background
        # every color the draw calls used (a palette hint for save_bmp;
        # direct .img writers must call invalidate_colors())
        self.colors = {tuple(int(v) for v in background)}

    def _use(self, color: Color) -> None:
        self.colors.add((int(color[0]), int(color[1]), int(color[2])))

    def invalidate_colors(self) -> None:
        """Call after writing .img directly: disables the palette hint."""
        self.colors = None

    def point(self, x: int, y: int, color: Color) -> None:
        if 0 <= x < self.width and 0 <= y < self.height:
            if self.colors is not None:
                self._use(color)
            self.img[y, x] = color

    def hline(self, x0: int, x1: int, y: int, color: Color) -> None:
        if not (0 <= y < self.height):
            return
        x0, x1 = max(0, min(x0, x1)), min(self.width - 1, max(x0, x1))
        if x0 > x1:
            return  # fully clipped: keep the palette hint unpolluted
        if self.colors is not None:
            self._use(color)
        self.img[y, x0 : x1 + 1] = color

    def vline(self, x: int, y0: int, y1: int, color: Color) -> None:
        if not (0 <= x < self.width):
            return
        y0, y1 = max(0, min(y0, y1)), min(self.height - 1, max(y0, y1))
        if y0 > y1:
            return
        if self.colors is not None:
            self._use(color)
        self.img[y0 : y1 + 1, x] = color

    def rect(self, x0: int, y0: int, x1: int, y1: int, color: Color,
             fill: bool = True) -> None:
        x0, x1 = min(x0, x1), max(x0, x1)
        y0, y1 = min(y0, y1), max(y0, y1)
        if fill:
            xa, xb = max(0, x0), min(self.width - 1, x1)
            ya, yb = max(0, y0), min(self.height - 1, y1)
            if xa <= xb and ya <= yb:
                if self.colors is not None:
                    self._use(color)
                self.img[ya : yb + 1, xa : xb + 1] = color
        else:
            self.hline(x0, x1, y0, color)
            self.hline(x0, x1, y1, color)
            self.vline(x0, y0, y1, color)
            self.vline(x1, y0, y1, color)

    def line(self, x0: int, y0: int, x1: int, y1: int, color: Color) -> None:
        """Bresenham line."""
        dx = abs(x1 - x0)
        dy = -abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx + dy
        x, y = x0, y0
        while True:
            self.point(x, y, color)
            if x == x1 and y == y1:
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x += sx
            if e2 <= dx:
                err += dx
                y += sy

    def circle(self, cx: int, cy: int, r: int, color: Color) -> None:
        x, y, d = r, 0, 1 - r
        while x >= y:
            for px, py in ((x, y), (y, x), (-x, y), (-y, x),
                           (x, -y), (y, -x), (-x, -y), (-y, -x)):
                self.point(cx + px, cy + py, color)
            y += 1
            if d < 0:
                d += 2 * y + 1
            else:
                x -= 1
                d += 2 * (y - x) + 1

    def text(self, x: int, y: int, s: str, color: Color, scale: int = 1) -> None:
        cx = x
        for ch in s.upper():
            bits = _F.get(ch)
            if bits is None:
                bits = _F[" "]
            for r in range(5):
                for c in range(3):
                    if bits[r * 3 + c] == "1":
                        if scale == 1:
                            self.point(cx + c, y + r, color)
                        else:
                            self.rect(
                                cx + c * scale, y + r * scale,
                                cx + c * scale + scale - 1,
                                y + r * scale + scale - 1, color,
                            )
            cx += 4 * scale

    @staticmethod
    def text_width(s: str, scale: int = 1) -> int:
        return 4 * scale * len(s)

    def save_bmp(self, path: str) -> None:
        from .bmp import write_bmp

        write_bmp(path, self.img, color_hint=self.colors)
