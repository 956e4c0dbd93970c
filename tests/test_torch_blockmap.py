"""The block map's whole-array raster against per-pixel drawing.

The oracle is the per-pixel drawing the port's canvas had before lines and
text became pixel arrays (and that the JAX package's canvas still has): the
serial Bresenham and the 3x5 font, one clipped ``point`` a pixel.  The
painter is held to the JAX package's painter, which draws every pixel on an
RGB canvas and builds its palette at save.
"""

import random

import numpy as np
import pytest

from csa_tpu.report import blockmap as jblockmap
from csa_tpu_torch.report import blockmap
from csa_tpu_torch.report.canvas import _F, Canvas, line_pixels, text_pixels
from csa_tpu_torch.utils import PROFILER


def oracle_line(x0, y0, x1, y1):
    """The serial Bresenham's pixels, in drawing order."""
    dx = abs(x1 - x0)
    dy = -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    x, y = x0, y0
    pts = []
    while True:
        pts.append((x, y))
        if x == x1 and y == y1:
            return pts
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x += sx
        if e2 <= dx:
            err += dx
            y += sy


def oracle_text(x, y, s):
    """The font's pixels of ``s``, a character and a bit at a time."""
    pts = []
    cx = x
    for ch in s.upper():
        bits = _F.get(ch)
        if bits is None:
            bits = _F[" "]
        for r in range(5):
            for c in range(3):
                if bits[r * 3 + c] == "1":
                    pts.append((cx + c, y + r))
        cx += 4
    return pts


class OracleCanvas:
    """Per-pixel drawing: each pixel a clipped point."""

    def __init__(self, width, height):
        self.width, self.height = width, height
        self.img = np.full((height, width, 3), 255, dtype=np.uint8)

    def points(self, pts, color):
        for x, y in pts:
            if 0 <= x < self.width and 0 <= y < self.height:
                self.img[y, x] = color


def _pixels(xs, ys, which, n):
    """The (x, y) pixels of each of ``n`` lines."""
    out = [[] for _ in range(n)]
    for x, y, i in zip(xs.tolist(), ys.tolist(), which.tolist()):
        out[i].append((x, y))
    return out


def test_line_pixels_every_pair_in_a_box():
    """Every pair of ends in a 12 x 12 box, each line's pixels in order."""
    ends = [(x, y) for x in range(12) for y in range(12)]
    pairs = [(a, b) for a in ends for b in ends]
    xs, ys, which = line_pixels(*np.array(
        [(a[0], a[1], b[0], b[1]) for a, b in pairs]).T)
    got = _pixels(xs, ys, which, len(pairs))
    for (a, b), line in zip(pairs, got):
        assert line == oracle_line(*a, *b), (a, b)


def _random_lines(kind, rng, n=500):
    lines = []
    while len(lines) < n:
        if kind == "clipped":  # ends on both sides of a 64 x 48 image
            x0, x1 = rng.randint(-90, 150), rng.randint(-90, 150)
            y0, y1 = rng.randint(-70, 120), rng.randint(-70, 120)
        else:
            x0, y0 = rng.randint(0, 400), rng.randint(0, 300)
            major, minor = rng.randint(1, 400), rng.randint(0, 400)
            minor = min(minor, major - 1) if rng.random() < 0.9 else major
            dx, dy = (minor, major) if kind == "steep" else (major, minor)
            if kind == "reversed":  # ends swapped on either axis
                dx, dy = rng.choice([(-dx, dy), (dx, -dy), (-dx, -dy),
                                     (-dy, -dx)])
            else:
                dx, dy = dx * rng.choice([1, -1]), dy * rng.choice([1, -1])
            x1, y1 = x0 + dx, y0 + dy
        lines.append((x0, y0, x1, y1))
    return lines


@pytest.mark.parametrize("kind", ["steep", "shallow", "reversed", "clipped"])
def test_line_pixels_random_lines(kind):
    """500 seeded lines of a kind (2,000 in all): the same pixels in the
    same order, and, drawn in turn in seven colours, the same image as
    per-pixel drawing, clipping and overdraw included."""
    rng = random.Random(f"lines-{kind}")
    lines = _random_lines(kind, rng)
    xs, ys, which = line_pixels(*np.array(lines).T)
    for line, got in zip(lines, _pixels(xs, ys, which, len(lines))):
        assert got == oracle_line(*line), line
    w, h = (64, 48) if kind == "clipped" else (300, 200)
    canvas, oracle = Canvas(w, h), OracleCanvas(w, h)
    colors = [(0, 0, 0), (255, 0, 0), (0, 200, 0), (0, 0, 190),
              (90, 90, 90), (250, 250, 0), (12, 34, 56)]
    for i, line in enumerate(lines):
        canvas.line(*line, colors[i % 7])
        oracle.points(oracle_line(*line), colors[i % 7])
    np.testing.assert_array_equal(canvas.img, oracle.img)


def test_text_pixels_every_glyph():
    """Each character of the font, one it lacks (drawn as a space) and
    lower case (drawn upper), alone and in a string."""
    chars = list(_F) + ["~", "a", "q"]
    for i, ch in enumerate(chars):
        xs, ys = text_pixels(3 + i, 7, ch)
        assert list(zip(xs.tolist(), ys.tolist())) == oracle_text(
            3 + i, 7, ch), ch
    s = "".join(chars)
    xs, ys = text_pixels(-5, 2, s)
    assert list(zip(xs.tolist(), ys.tolist())) == oracle_text(-5, 2, s)
    assert len(text_pixels(0, 0, "")[0]) == 0


def test_text_clipped_at_every_edge():
    canvas, oracle = Canvas(40, 12), OracleCanvas(40, 12)
    for x, y, s in ((-6, -2, "BLOCKS"), (30, 9, "1234"), (-3, 8, "A.B"),
                    (20, -4, "ZZ"), (41, 0, "X"), (0, 12, "Y")):
        canvas.text(x, y, s, (60, 60, 60))
        oracle.points(oracle_text(x, y, s), (60, 60, 60))
    np.testing.assert_array_equal(canvas.img, oracle.img)


def _paint(mod, out, seed, k, chains):
    """Draw the same seeded block map with ``mod``'s painter, as the
    blocks report does (blocks, then the color, then the connectors), and
    return its image and image-map bytes."""
    rng = random.Random(seed)
    sizes = [rng.randint(500, 20000) for _ in range(k)]
    rotations = [rng.randrange(n) for n in sizes]
    painter = mod.BlockMapPainter(sizes, rotations, str(out / "map.txt"))
    for _ in range(chains):
        size = rng.randint(1, max(sizes) // 3)
        for seq in range(k):
            for _ in range(rng.choice([0, 1, 1, 1, 1, 1, 1, 2])):
                painter.draw_block_rotated(rng.randrange(sizes[seq]), size,
                                           seq)
        painter.next_color()
        painter.connect_blocks()
    painter.draw_labels([f"Seq_{i}.{rng.randrange(10**6)}~x" * (i % 3 + 1)
                         for i in range(k)])
    painter.draw_bottom_label("chains with size >=10 " * rng.randint(1, 20))
    painter.save(str(out / "map.bmp"))
    return (out / "map.bmp").read_bytes(), (out / "map.txt").read_bytes()


def _paint_both(tmp_path, seed, k, chains):
    got = {}
    for tag, mod in (("jax", jblockmap), ("port", blockmap)):
        (tmp_path / tag).mkdir()
        enabled = PROFILER.enabled
        PROFILER.reset()
        PROFILER.enabled = True
        try:
            got[tag] = _paint(mod, tmp_path / tag, seed, k, chains)
        finally:
            PROFILER.enabled = enabled
        counters = dict(PROFILER.counters)
        PROFILER.reset()
    return got, counters


@pytest.mark.parametrize("seed", range(6))
def test_painter_matches_per_pixel_painter(seed, tmp_path):
    """Overlapping blocks, tracks with no block or two, connectors over
    blocks, labels past the image's edge: the same bytes as the painter
    that draws per pixel, through the indexed path."""
    got, counters = _paint_both(tmp_path, seed, k=2 + 3 * seed,
                                chains=5 + 9 * seed)
    assert got["port"] == got["jax"]
    assert counters["report.blockmap_rgb_fallbacks"] == 0
    assert 3 <= counters["report.blockmap_colors"] <= 256


def test_painter_over_256_colors(tmp_path):
    """300 chains give more than 256 colors: the RGB path, and the same
    quantized bytes as the painter that draws per pixel."""
    got, counters = _paint_both(tmp_path, 300, k=4, chains=300)
    assert got["port"] == got["jax"]
    assert counters["report.blockmap_rgb_fallbacks"] == 1
    assert counters["report.blockmap_colors"] > 256


@pytest.mark.parametrize("palette", [8, 400])
@pytest.mark.parametrize("seed", range(3))
def test_raster_interleaved_draws(seed, palette, tmp_path):
    """Boxes, lines and text drawn in turn in random colors, overlapping
    each other and partly outside the image, with 8 colors and past 256;
    among them draws in colors of their own: wholly outside the image
    (their color is not in the palette) and wholly covered by a later box
    (it is).  The same bytes as per-pixel drawing."""
    rng = random.Random(f"raster-{seed}-{palette}")
    colors = [(rng.randrange(256), rng.randrange(256), rng.randrange(256))
              for _ in range(palette)]
    port = blockmap.BlockMapPainter([1000, 700, 400], [0, 0, 0])
    jax = jblockmap.BlockMapPainter([1000, 700, 400], [0, 0, 0])
    w, h = port.width, port.height

    def xy():
        return rng.randint(-60, w + 60), rng.randint(-40, h + 40)

    draws = []
    for _ in range(600):
        kind = rng.choice(["box", "line", "line", "text"])
        if kind == "text":
            draws.append(("text", *xy(), "".join(
                rng.choice("AZ09.-~ q") for _ in range(rng.randint(0, 12)))))
            continue
        (x0, y0), (x1, y1) = xy(), xy()
        if kind == "box":
            x1, y1 = x0 + (x1 - x0) // 8, y0 + (y1 - y0) // 4
        draws.append((kind, x0, y0, x1, y1))
    draws = [(d, rng.choice(colors)) for d in draws]
    own = [("box", -10, 5, -1, 20), ("box", 3, h, 20, h + 4),
           ("box", -1, 0, -1, 0), ("box", w, 7, w, 9),
           ("line", -5, -5, -20, 30), ("line", w, h, w + 40, h + 1),
           ("text", w + 2, 10, "ABC"), ("text", 40, -5, "Q"),
           ("text", 40, 9, " ~ "), ("box", 500, 30, 510, 34)]
    at = sorted(rng.sample(range(len(draws)), len(own)))
    for i, d in reversed(list(zip(at, own))):
        draws.insert(i, (d, (1, 2, 3 + i % 250)))
    draws.append((("box", 495, 28, 512, 36), colors[0]))  # covers the last
    for (kind, *args), color in draws:
        if kind == "box":
            port._box(*args, port._number(color))
            jax.canvas.rect(*args, color)
        elif kind == "line":
            port._line(*args, port._number(color))
            jax.canvas.line(*args, color)
        else:
            port._text(*args, port._number(color))
            jax.canvas.text(*args, color)
    port.save(str(tmp_path / "port.bmp"))
    jax.save(str(tmp_path / "jax.bmp"))
    assert (tmp_path / "port.bmp").read_bytes() == \
        (tmp_path / "jax.bmp").read_bytes()
