"""Block-map image: one horizontal track per sequence, chain blocks drawn at
their rotated coordinates with connector lines between adjacent tracks.

Own-design equivalent of the reference block image
(``source/graphics.c:1254-1363`` drawBlockRotated /
connectBlocks / initializeBlocks): same information content — per-sequence
block positions after rotation, distinct color per chain, sequence labels,
and an image-map side file for the web UI.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence

from .canvas import Canvas

LEFT_MARGIN = 90
RIGHT_MARGIN = 20
TOP_MARGIN = 20
TRACK_HEIGHT = 22
BLOCK_HEIGHT = 10
PLOT_WIDTH = 1000
BOTTOM_MARGIN = 30


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
        height = TOP_MARGIN + self.k * TRACK_HEIGHT + BOTTOM_MARGIN
        width = LEFT_MARGIN + PLOT_WIDTH + RIGHT_MARGIN
        self.canvas = Canvas(width, height)
        self.color_index = 0
        self.current_color = (0, 0, 0)
        self.pending: List[tuple] = []  # (seq, x0, x1) of current chain
        self.imagemap_path = imagemap_path
        self._imagemap_lines: List[str] = []
        # track baselines
        for i in range(self.k):
            y = self._track_y(i) + BLOCK_HEIGHT // 2
            self.canvas.hline(
                LEFT_MARGIN, LEFT_MARGIN + self._scale(self.sizes[i]), y,
                (200, 200, 200),
            )

    def _track_y(self, seq: int) -> int:
        return TOP_MARGIN + seq * TRACK_HEIGHT

    def _scale(self, pos: int) -> int:
        return int(pos * (PLOT_WIDTH - 1) / max(1, self.max_n))

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
        by_seq = {}
        for seq, x0, x1 in self.pending:
            y = self._track_y(seq)
            self.canvas.rect(x0, y, max(x0, x1), y + BLOCK_HEIGHT, color)
            by_seq[seq] = (x0 + max(x0, x1)) // 2
        for seq in range(self.k - 1):
            if seq in by_seq and (seq + 1) in by_seq:
                self.canvas.line(
                    by_seq[seq], self._track_y(seq) + BLOCK_HEIGHT,
                    by_seq[seq + 1], self._track_y(seq + 1),
                    tuple(min(255, c + 90) for c in color),
                )
        self.pending = []

    def draw_labels(self, names: Sequence[str]) -> None:
        for i, name in enumerate(names):
            self.canvas.text(
                4, self._track_y(i) + 2, name[:20], (0, 0, 0)
            )

    def draw_bottom_label(self, text: str) -> None:
        y = self.canvas.height - BOTTOM_MARGIN + 8
        self.canvas.text(LEFT_MARGIN, y, text, (60, 60, 60))

    def save(self, path: str) -> None:
        self.canvas.save_bmp(path)
        if self.imagemap_path:
            with open(self.imagemap_path, "w") as f:
                f.write(f"{self.canvas.width} {self.canvas.height}\n")
                f.write("\n".join(self._imagemap_lines))
                f.write("\n")
