"""Block-map image: one horizontal track per sequence, chain blocks drawn at
their rotated coordinates with connector lines between adjacent tracks.

Own-design equivalent of the reference block image
(``source/graphics.c:1254-1363`` drawBlockRotated /
connectBlocks / initializeBlocks): same information content — per-sequence
block positions after rotation, distinct color per chain, sequence labels,
and an image-map side file for the web UI.

The painter records its draws (boxes, lines, text) in order and rasterizes
them at :meth:`BlockMapPainter.save`, in whole arrays, into an image of
palette indices: each pixel takes the last draw that covers it.  The
palette is every color a draw left pixels of when it drew (colors that a
later draw covered included), sorted by (r, g, b).  A map of more than 256
such colors is written as RGB through :func:`bmp.write_bmp`'s
quantization.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

import numpy as np

from ..utils import PROFILER
from .bmp import write_bmp, write_indexed_bmp
from .canvas import line_pixels, text_pixels

LEFT_MARGIN = 90
RIGHT_MARGIN = 20
TOP_MARGIN = 20
TRACK_HEIGHT = 22
BLOCK_HEIGHT = 10
PLOT_WIDTH = 1000
BOTTOM_MARGIN = 30
BACKGROUND = (255, 255, 255)


class BlockMapPainter:
    def __init__(
        self,
        sizes: Sequence[int],
        rotations: Sequence[int],
        imagemap_path: Optional[str] = None,
    ):
        self.sizes = [int(s) for s in sizes]
        self.rotations = [int(r) for r in rotations]
        self.k = len(sizes)
        self.max_n = max(self.sizes)
        self.height = TOP_MARGIN + self.k * TRACK_HEIGHT + BOTTOM_MARGIN
        self.width = LEFT_MARGIN + PLOT_WIDTH + RIGHT_MARGIN
        self.color_index = 0
        self.current_color = (0, 0, 0)
        self.pending: List[tuple] = []  # (seq, x0, x1) of current chain
        self.imagemap_path = imagemap_path
        self._imagemap_lines: List[str] = []
        # draw d paints color number self._draw_color[d]; draw 0 is the
        # background
        self._numbers = {BACKGROUND: 0}  # color -> its number
        self._draw_color = [0]
        self._boxes: List[tuple] = []  # (draw, x0, y0, x1, y1), unclipped
        self._lines: List[tuple] = []  # (draw, x0, y0, x1, y1)
        self._texts: List[tuple] = []  # (draw, xs, ys)
        # track baselines
        grey = self._number((200, 200, 200))
        for i in range(self.k):
            y = self._track_y(i) + BLOCK_HEIGHT // 2
            self._box(LEFT_MARGIN, y, LEFT_MARGIN + self._scale(self.sizes[i]),
                      y, grey)

    def _track_y(self, seq: int) -> int:
        return TOP_MARGIN + seq * TRACK_HEIGHT

    def _scale(self, pos: int) -> int:
        return int(pos * (PLOT_WIDTH - 1) / max(1, self.max_n))

    def _number(self, color) -> int:
        color = (int(color[0]), int(color[1]), int(color[2]))
        return self._numbers.setdefault(color, len(self._numbers))

    def _draw(self, number: int) -> int:
        """A new draw of color ``number``: its draw number."""
        self._draw_color.append(number)
        return len(self._draw_color) - 1

    # the draws, each in a color's number: a filled box (corners in any
    # order), a line, a text; each is clipped to the image at save

    def _box(self, x0: int, y0: int, x1: int, y1: int, number: int) -> None:
        self._boxes.append((self._draw(number), x0, y0, x1, y1))

    def _line(self, x0: int, y0: int, x1: int, y1: int, number: int) -> None:
        self._lines.append((self._draw(number), x0, y0, x1, y1))

    def _text(self, x: int, y: int, s: str, number: int) -> None:
        self._texts.append((self._draw(number),) + text_pixels(x, y, s))

    def next_color(self):
        """Distinct, stable color per chain (golden-angle hue walk)."""
        h = (self.color_index * 0.61803398875) % 1.0
        r, g, b = colorsys.hsv_to_rgb(h, 0.85, 0.85)
        self.color_index += 1
        self.current_color = (int(r * 255), int(g * 255), int(b * 255))
        return self.current_color

    def draw_block_rotated(self, pos: int, size: int, seq: int) -> int:
        """Draw a chain block on sequence ``seq``'s track; returns the
        rotated position (what the reference's drawBlockRotated returns and
        the positions file records)."""
        n = self.sizes[seq]
        rotated = (pos - self.rotations[seq]) % n
        x0 = LEFT_MARGIN + self._scale(rotated)
        x1 = LEFT_MARGIN + self._scale(min(rotated + size, n))
        y = self._track_y(seq)
        self.pending.append((seq, x0, x1))
        self._imagemap_lines.append(
            f"{seq} {x0} {y} {x1} {y + BLOCK_HEIGHT} {size} {rotated}"
        )
        return rotated

    def connect_blocks(self) -> None:
        """Color the pending blocks and connect them across tracks."""
        color = self.current_color
        number = self._number(color)
        by_seq = {}
        for seq, x0, x1 in self.pending:
            y = self._track_y(seq)
            x1 = max(x0, x1)
            self._box(x0, y, x1, y + BLOCK_HEIGHT, number)
            by_seq[seq] = (x0 + x1) // 2
        light = self._number(tuple(min(255, c + 90) for c in color))
        for seq in range(self.k - 1):
            if seq in by_seq and (seq + 1) in by_seq:
                self._line(by_seq[seq], self._track_y(seq) + BLOCK_HEIGHT,
                           by_seq[seq + 1], self._track_y(seq + 1), light)
        self.pending = []

    def draw_labels(self, names: Sequence[str]) -> None:
        for i, name in enumerate(names):
            self._text(4, self._track_y(i) + 2, name[:20],
                       self._number((0, 0, 0)))

    def draw_bottom_label(self, text: str) -> None:
        y = self.height - BOTTOM_MARGIN + 8
        self._text(LEFT_MARGIN, y, text, self._number((60, 60, 60)))

    def _pixel_draws(self):
        """(flat, draws): the pixels of the line and text draws that fall
        inside the image, as flat indices, and the draw of each."""
        w, h = self.width, self.height
        lines = np.array(self._lines, dtype=np.int64).reshape(-1, 5)
        xs, ys, which = line_pixels(*lines[:, 1:].T)
        xs = np.concatenate([xs] + [t[1] for t in self._texts])
        ys = np.concatenate([ys] + [t[2] for t in self._texts])
        draws = np.concatenate([lines[which, 0]] + [
            np.full(len(t[1]), t[0]) for t in self._texts])
        ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        return ys[ok] * w + xs[ok], draws[ok]

    def _raster(self):
        """(palette, indices): the colors that some draw left pixels of
        when it drew, sorted by (r, g, b), and each pixel's index into
        them, that of the last draw covering it (uint8 while the colors
        fit in 256)."""
        w, h = self.width, self.height
        boxes = np.array(self._boxes, dtype=np.int64).reshape(-1, 5)
        xa = np.maximum(0, np.minimum(boxes[:, 1], boxes[:, 3]))
        xb = np.minimum(w - 1, np.maximum(boxes[:, 1], boxes[:, 3]))
        ya = np.maximum(0, np.minimum(boxes[:, 2], boxes[:, 4]))
        yb = np.minimum(h - 1, np.maximum(boxes[:, 2], boxes[:, 4]))
        inside = (xa <= xb) & (ya <= yb)
        flat, draws = self._pixel_draws()

        drawn = np.zeros(len(self._draw_color), dtype=bool)
        drawn[0] = True
        drawn[boxes[inside, 0]] = True
        drawn[draws] = True
        draw_color = np.array(self._draw_color, dtype=np.intp)
        used = np.zeros(len(self._numbers), dtype=bool)
        used[draw_color[drawn]] = True
        # not np.unique: its first call in a process may import numpy.ma
        used = np.flatnonzero(used)
        rgb = np.array(list(self._numbers), dtype=np.uint8)[used]
        wide = rgb.astype(np.int64)
        by_key = np.argsort((wide[:, 0] << 16) | (wide[:, 1] << 8)
                            | wide[:, 2])
        rank = np.zeros(len(self._numbers), dtype=np.int64)
        rank[used[by_key]] = np.arange(len(used))
        value = rank[draw_color]  # each draw's palette index

        indices = np.full((h, w), value[0],
                          dtype=np.uint8 if len(used) <= 256 else np.int32)
        view = indices.reshape(-1)
        box_draws = boxes[inside, 0]
        boxes = list(zip(*(v[inside].tolist()
                           for v in (boxes[:, 0], xa, ya, xb, yb))))
        color = value.tolist()

        def paint(some):
            for d, x0, y0, x1, y1 in some:
                indices[y0 : y1 + 1, x0 : x1 + 1] = color[d]

        # the line and text pixels drawn after box g - 1 and before box g
        # are group g; of a group, each pixel takes its last draw
        key = np.searchsorted(box_draws, draws) * (w * h) + flat
        order = np.lexsort((draws, key))
        key, draws = key[order], draws[order]
        last = np.append(key[1:] != key[:-1], True)
        group, flat = np.divmod(key[last], w * h)
        pixel = value[draws[last]]
        first = np.ones(len(group), dtype=bool)
        first[1:] = group[1:] != group[:-1]
        starts = np.flatnonzero(first)
        ends = np.append(starts[1:], len(group))
        painted = 0
        for g, a, b in zip(group[starts].tolist(), starts.tolist(),
                           ends.tolist()):
            paint(boxes[painted:g])
            painted = g
            view[flat[a:b]] = pixel[a:b]  # no pixel twice
        paint(boxes[painted:])
        return rgb[by_key], indices

    def save(self, path: str) -> None:
        palette, indices = self._raster()
        PROFILER.add("report.blockmap_colors", len(palette))
        PROFILER.add("report.blockmap_rgb_fallbacks", int(len(palette) > 256))
        if len(palette) > 256:
            write_bmp(path, palette[indices])
        else:
            write_indexed_bmp(path, palette, indices)
        if self.imagemap_path:
            with open(self.imagemap_path, "w") as f:
                f.write(f"{self.width} {self.height}\n")
                f.write("\n".join(self._imagemap_lines))
                f.write("\n")
