"""The circular plot's palette-indexed raster: the native host library's
raster, its numpy twin and the JAX package's RGB canvas write the same
bytes; the shared quantizer against the RGB writer's palette as it was
before it was factored out; the plot's two counters.

All on the CPU: the native library builds with the host's compiler, and
the twin runs where it is missing or on the ``numpy`` route.
"""

import contextlib
import io
import pathlib

import numpy as np
import pytest

from csa_tpu.report import bmp as jbmp
from csa_tpu.report import circular_plot as jplot
from csa_tpu_torch import native
from csa_tpu_torch.report import bmp, circular_plot
from csa_tpu_torch.utils import PROFILER

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
ALIGNED = ([f"{s}-Rotated-Aligned" for s in ("Primates", "Mammals", "Set3")]
           + sorted(f"tiny/{p.stem}"
                    for p in (FIX / "tiny").glob("*-Aligned.fasta")))


def _draw(fn, src, out, **kw):
    """(log, image bytes or None, the RGB image the JAX package's writer
    got or None, the counters) of one plot."""
    seen = {}
    write_bmp = jbmp.write_bmp

    def spy(path, img, *a, **k):
        seen["img"] = np.array(img)
        return write_bmp(path, img, *a, **k)

    log = io.StringIO()
    enabled = PROFILER.enabled
    PROFILER.reset()
    PROFILER.enabled = True
    jbmp.write_bmp = spy
    try:
        fn(str(src), str(out), log=log, **kw)
    finally:
        jbmp.write_bmp = write_bmp
        PROFILER.enabled = enabled
    counters = dict(PROFILER.counters)
    PROFILER.reset()
    data = out.read_bytes() if out.exists() else None
    return log.getvalue(), data, seen.get("img"), counters


def _routes(src, tmp_path):
    """The JAX package's plot, then the port's on the native and the
    numpy route."""
    return [
        _draw(jplot.draw_circular_alignment_plot, src, tmp_path / "jax.bmp"),
        _draw(circular_plot.draw_circular_alignment_plot, src,
              tmp_path / "native.bmp", backend="native"),
        _draw(circular_plot.draw_circular_alignment_plot, src,
              tmp_path / "numpy.bmp", backend="numpy"),
    ]


def _colors(img):
    wide = img.astype(np.int64)
    return len(np.unique((wide[..., 0] << 16) | (wide[..., 1] << 8)
                         | wide[..., 2]))


@pytest.mark.parametrize("name", ALIGNED)
def test_plot_bytes_on_every_route(name, tmp_path):
    """Every aligned fixture: the same log and image on both routes as
    the JAX package's (the tiny sets are too short for a plot: the same
    error, no image)."""
    (jlog, jdata, jimg, _), (nlog, ndata, _, nc), (plog, pdata, _, pc) = \
        _routes(FIX / f"{name}.fasta", tmp_path)
    assert nlog == plog == jlog
    assert ndata == pdata == jdata
    if jdata is None:
        assert "too short" in jlog
        assert nc == pc == {}
    else:
        assert nc["report.plot_native"] == 1 and pc["report.plot_native"] == 0
        assert nc["report.plot_colors"] == pc["report.plot_colors"] == \
            _colors(jimg)


def _write_alignment(path, rows, names=None):
    names = names or [f"seq{i} synthetic" for i in range(len(rows))]
    with open(path, "w") as f:
        for name, row in zip(names, rows):
            f.write(f">{name}\n")
            for a in range(0, len(row), 60):
                f.write(row[a : a + 60] + "\n")


def _random_rows(rng, k, n, letters, p_gap=0.0):
    alphabet = np.array(list(letters))
    rows = rng.choice(alphabet, size=(k, n))
    rows[rng.random((k, n)) < p_gap] = "-"
    return ["".join(r) for r in rows]


def _synthetic(kind, rng):
    """(rows, names) of a synthetic alignment of kind ``kind``."""
    if kind == "identical":  # one ring color: the identity palette
        row = "".join(rng.choice(list("ACGT"), size=2500))
        return [row] * 3, None
    if kind == "lower_iupac":  # lower case and IUPAC codes among ACGT
        base = _random_rows(rng, 1, 3000, "ACGT")[0]
        rows = []
        for _ in range(5):
            r = np.array(list(base))
            flip = rng.random(len(r)) < 0.3
            r[flip] = np.char.lower(r[flip])
            r[rng.random(len(r)) < 0.1] = rng.choice(list("NRYKMSWnry"))
            r[rng.random(len(r)) < 0.05] = "-"
            rows.append("".join(r))
        return rows, None
    if kind == "gap_columns":  # blocks of all-gap columns
        rows = [np.array(list(r)) for r in
                _random_rows(rng, 4, 3200, "ACGT", p_gap=0.2)]
        for r in rows:
            r[400:900] = "-"
            r[2000:2003] = "-"
        return ["".join(r) for r in rows], None
    if kind == "all_gaps":
        return ["-" * 2400] * 2, None
    if kind == "long_labels":  # labels past 64 characters, unknown glyphs
        rows = _random_rows(rng, 6, 4000, "ACGTacgt-")
        return rows, [f"seq{i} " + "x?~" * 30 for i in range(6)]
    if kind == "too_short":
        return _random_rows(rng, 3, 600, "ACGT-"), None
    raise ValueError(kind)


KINDS = ["identical", "lower_iupac", "gap_columns", "all_gaps",
         "long_labels", "too_short"]


@pytest.mark.parametrize("kind", KINDS)
def test_plot_bytes_on_synthetic_alignments(kind, tmp_path):
    rows, names = _synthetic(kind, np.random.default_rng(KINDS.index(kind)))
    src = tmp_path / "aln.fasta"
    _write_alignment(src, rows, names)
    (jlog, jdata, jimg, _), (nlog, ndata, _, nc), (plog, pdata, _, pc) = \
        _routes(src, tmp_path)
    assert nlog == plog == jlog
    assert ndata == pdata == jdata
    if kind == "too_short":
        assert jdata is None and "too short" in jlog
        return
    assert nc["report.plot_colors"] == pc["report.plot_colors"] == \
        _colors(jimg)
    if kind == "identical":
        assert nc["report.plot_colors"] <= 256  # the identity palette


def test_plot_counters_on_a_fixture(tmp_path):
    """Primates: more than 256 colors (the quantized palette), the
    native raster on the default route."""
    _, data, img, counters = _draw(
        circular_plot.draw_circular_alignment_plot,
        FIX / "Primates-Rotated-Aligned.fasta", tmp_path / "p.bmp")
    assert data is not None and img is None
    assert counters["report.plot_native"] == 1
    assert counters["report.plot_colors"] > 256


def test_plot_without_the_library_takes_the_twin(tmp_path, monkeypatch):
    src = FIX / "Mammals-Rotated-Aligned.fasta"
    _, want, _, _ = _draw(circular_plot.draw_circular_alignment_plot, src,
                          tmp_path / "a.bmp")
    monkeypatch.setattr(native, "_load", lambda: None)
    _, got, _, counters = _draw(circular_plot.draw_circular_alignment_plot,
                                src, tmp_path / "b.bmp")
    assert got == want
    assert counters["report.plot_native"] == 0


def _edge_case(seed, size):
    """A raster whose rings cross every edge of a ``size`` image, the
    last row included, with an overlay over them."""
    rng = np.random.default_rng(seed)
    numseqs, seqsize = 3, 5000
    rows = np.frombuffer("".join(_random_rows(
        rng, numseqs, seqsize, "ACGTacgtN-", p_gap=0.1)).encode(),
        dtype=np.uint8).reshape(numseqs, seqsize)
    xs, ys, offsets = circular_plot._ring_table(100, numseqs)
    flat = rng.integers(0, size * size, 500)
    ids = circular_plot.FIXED + rng.integers(0, 4, 500)
    return (rows, xs, ys, offsets, size // 2 + 7, size, flat, ids,
            circular_plot.FIXED, circular_plot.FIXED + 4)


@pytest.mark.parametrize("seed,size", [(0, 301), (1, 240), (2, 200)])
def test_raster_native_against_twin_past_the_edges(seed, size):
    args = _edge_case(seed, size)
    got = native.circular_plot_raster(*args)
    assert got is not None
    want = circular_plot._raster_numpy(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].sum() == size * size
    # rings reached the last row, where a point's neighbour is clipped
    assert (got[0][-1] < circular_plot.FIXED).any()


@pytest.mark.parametrize("seed", range(3))
def test_raster_native_against_twin_on_walks_down_the_last_rows(seed):
    """Rings of any shape: short walks down columns to the last row and
    past it, so a point's clipped neighbour repaints a pixel another
    point's neighbour painted before it, and points outside the image."""
    rng = np.random.default_rng(seed)
    size, numseqs = 64, 2
    rows = np.frombuffer("".join(_random_rows(
        rng, numseqs, 700, "ACGT-", p_gap=0.3)).encode(),
        dtype=np.uint8).reshape(numseqs, 700)
    walks = [(x, y) for x in rng.integers(-2, size + 2, 300)
             for y in range(size - 4, size + 2)]
    pts = np.array(walks + [tuple(p) for p in
                            rng.integers(-3, size + 3, (500, 2))])
    cuts = np.sort(rng.choice(np.arange(1, len(pts)), 2 * numseqs - 1,
                              replace=False))
    offsets = np.concatenate([[0], cuts, [len(pts)]])
    args = (rows, pts[:, 0], pts[:, 1], offsets, 0, size,
            np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32),
            circular_plot.FIXED, circular_plot.FIXED + 1)
    got = native.circular_plot_raster(*args)
    want = circular_plot._raster_numpy(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_raster_refuses_ids_it_cannot_count():
    args = list(_edge_case(0, 120))
    args[-1] = circular_plot.FIXED + 2  # overlay ids reach FIXED + 3
    with pytest.raises(ValueError):
        native.circular_plot_raster(*args)
    args = list(_edge_case(0, 120))
    args[6] = args[6] + 120 * 120  # overlay pixels past the image
    with pytest.raises(ValueError):
        native.circular_plot_raster(*args)


def _build_palette_before(img):
    """The RGB writer's palette as it was before the quantizer was
    factored out of it: the oracle."""
    h, w, _ = img.shape
    keys = (
        (img[:, :, 0].astype(np.uint32) << 16)
        | (img[:, :, 1].astype(np.uint32) << 8)
        | img[:, :, 2].astype(np.uint32)
    ).reshape(-1)
    uniq = np.unique(keys)
    inverse = np.searchsorted(uniq, keys)
    if len(uniq) <= 256:
        pal = np.stack(
            [(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1
        ).astype(np.uint8)
        return pal, inverse.reshape(h, w).astype(np.uint8)
    counts = np.bincount(inverse)
    top = np.argsort(-counts)[:256]
    pal_keys = uniq[top]
    pal = np.stack(
        [(pal_keys >> 16) & 0xFF, (pal_keys >> 8) & 0xFF, pal_keys & 0xFF],
        axis=1,
    ).astype(np.int32)
    ucol = np.stack(
        [(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1
    ).astype(np.int64)
    pal64 = pal.astype(np.int64)
    up = ucol @ pal64.T
    pp = (pal64 ** 2).sum(axis=1)
    best = np.argmin(pp[None, :] - 2 * up, axis=1).astype(np.uint8)
    return pal.astype(np.uint8), best[inverse].reshape(h, w)


@pytest.mark.parametrize("colors,seed", [(1, 0), (200, 1), (256, 2),
                                         (258, 3), (1500, 4), (7000, 5)])
def test_quantizer_against_the_palette_before(colors, seed):
    """Random images of a few colors to thousands, skewed and with many
    equal counts (so the argsort's ties matter), and colors that lie
    as near one another as the ring gradients do."""
    rng = np.random.default_rng(seed)
    near = rng.choice(6 * 256 * 6, colors // 2, replace=False)
    near = ((250 + near // 1536) << 16) | ((near // 6 % 256) << 8) | near % 6
    far = rng.choice(1 << 24, colors - len(near), replace=False)
    far = far[((far >> 16) < 250) | ((far & 0xFF) > 5)]
    keys = np.concatenate([near, far])
    pick = np.minimum(rng.geometric(0.004, 160 * 230) - 1, len(keys) - 1)
    pick[: len(keys)] = np.arange(len(keys))  # every color drawn
    pick = pick.reshape(160, 230)
    img = np.stack([(keys >> 16) & 0xFF, (keys >> 8) & 0xFF, keys & 0xFF],
                   axis=1)[pick].astype(np.uint8)
    assert _colors(img) == len(keys)
    want = _build_palette_before(img)
    got = bmp._build_palette(img)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_quantizer_of_distinct_colors_and_counts():
    """``quantize`` over keys and counts alone gives the palette and
    indices of the image those counts describe."""
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 1 << 24, 3000))
    counts = rng.integers(1, 40, len(keys))
    img = np.repeat(keys, counts)
    rgb = np.stack([(img >> 16) & 0xFF, (img >> 8) & 0xFF, img & 0xFF],
                   axis=1).astype(np.uint8).reshape(1, -1, 3)
    want_pal, want_idx = _build_palette_before(rgb)
    pal, lut = bmp.quantize(keys, counts)
    np.testing.assert_array_equal(pal, want_pal)
    np.testing.assert_array_equal(np.repeat(lut, counts), want_idx[0])


def test_plot_route_follows_the_cli(tmp_path, monkeypatch):
    """Mode I: the plot on the numpy route with ``--backend numpy``, on
    the native library otherwise."""
    from csa_tpu_torch import cli

    src = tmp_path / "Mammals-Aligned.fasta"
    src.write_bytes((FIX / "Mammals-Rotated-Aligned.fasta").read_bytes())
    routes = []
    draw = circular_plot.draw_circular_alignment_plot

    def spy(*a, backend="device", **k):
        routes.append(backend)
        return draw(*a, backend=backend, **k)

    monkeypatch.setattr(circular_plot, "draw_circular_alignment_plot", spy)
    with contextlib.redirect_stdout(io.StringIO()):
        for backend in ("numpy", "native", "device"):
            assert cli.main(["I", str(src), "--backend", backend]) == 0
    assert routes == ["numpy", "native", "device"]
