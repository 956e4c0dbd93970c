"""8-bit palette BMP writer (equivalent of reference source/bitmap.c).

Own implementation from the BMP file format: BITMAPFILEHEADER +
BITMAPINFOHEADER + RGBQUAD palette + bottom-up, 4-byte-aligned 8-bit indexed
pixel rows, with optional RLE8 compression.  The palette is built from the
colors actually used (quantizing to at most 256 by nearest match,
:func:`quantize`), instead of the reference's fixed color-cube palettes.
"""

from __future__ import annotations

import struct

import numpy as np

BI_RGB = 0
BI_RLE8 = 1
# colors a block of the quantizer's nearest-match search: one (256, 256)
# float32 product stays in cache (10,000 colors took 3-5 ms in blocks and
# 50-137 ms as one product on an 8-core x86 host)
QUANTIZE_ROWS = 256


def _rgb(keys: np.ndarray) -> np.ndarray:
    """(N, 3) channels of 24-bit 0xRRGGBB keys."""
    return np.stack([(keys >> 16) & 0xFF, (keys >> 8) & 0xFF, keys & 0xFF],
                    axis=1)


def quantize(keys: np.ndarray, counts: np.ndarray):
    """Palette of an image's distinct colors: ``keys`` its 24-bit
    0xRRGGBB colors, sorted ascending, ``counts`` the pixels of each.
    Returns (palette (P <= 256, 3) uint8, lut (U,) uint8), ``lut[u]``
    key ``u``'s palette index.  Up to 256 colors the palette is the keys
    themselves; past that it keeps the 256 most frequent
    (``argsort(-counts)``, so ties fall as numpy's default sort leaves
    them: the same int64 counts give the same palette) and maps every
    key to its nearest palette color, the first of equals."""
    keys = np.asarray(keys, dtype=np.int64)
    if len(keys) <= 256:
        return _rgb(keys).astype(np.uint8), np.arange(len(keys),
                                                      dtype=np.uint8)
    top = np.argsort(-np.asarray(counts, dtype=np.int64))[:256]
    pal = _rgb(keys[top])
    # argmin(|p|^2 - 2 u.p) is the squared distance's argmin (|u|^2 is
    # constant a row), first-min ties included; every value, partial
    # sums included, is an integer below 2^24 (|p|^2 <= 3 * 255^2,
    # 2 u.p <= 6 * 255^2), so float32 holds it exactly in any order of
    # summation and BLAS does the dots, QUANTIZE_ROWS colors at a time
    ucol = _rgb(keys).astype(np.float32)
    pal2 = 2 * pal.T.astype(np.float32)
    pp = (pal.astype(np.float32) ** 2).sum(axis=1)
    best = np.empty(len(keys), dtype=np.uint8)
    for a in range(0, len(keys), QUANTIZE_ROWS):
        d = ucol[a : a + QUANTIZE_ROWS] @ pal2
        np.subtract(pp, d, out=d)
        best[a : a + QUANTIZE_ROWS] = d.argmin(axis=1)
    return pal.astype(np.uint8), best


def _build_palette(img: np.ndarray):
    """Map an (H, W, 3) uint8 image to (palette (P,3), indices (H,W))."""
    h, w, _ = img.shape
    keys = (
        (img[:, :, 0].astype(np.uint32) << 16)
        | (img[:, :, 1].astype(np.uint32) << 8)
        | img[:, :, 2].astype(np.uint32)
    ).reshape(-1)
    uniq = np.unique(keys)
    # uniq is sorted and complete, so the inverse map is a binary search
    # (much cheaper than np.unique's return_inverse argsort)
    inverse = np.searchsorted(uniq, keys)
    palette, lut = quantize(uniq, np.bincount(inverse))
    return palette, lut[inverse].reshape(h, w)


def _rle8_encode(indices: np.ndarray) -> bytes:
    """RLE8 encode bottom-up rows per the BMP spec (encoded runs only).

    Fully vectorized: run boundaries are value changes or row starts;
    over-long runs split left-to-right into 255-pixel chunks (same
    output bytes as the serial two-pointer scan this replaces).
    """
    h, w = indices.shape
    if h * w == 0:
        # degenerate image: just the end-of-bitmap marker (the serial
        # encoder emitted the same bare terminator for this case)
        return bytes((0, 1))
    flat = indices[::-1].reshape(-1)
    n = h * w
    change = np.empty(n, dtype=bool)
    change[0] = True
    np.not_equal(flat[1:], flat[:-1], out=change[1:])
    change[::w] = True  # runs never cross row boundaries
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    nch = (lens + 254) // 255
    tot = int(nch.sum())
    vals = np.repeat(flat[starts], nch)
    chunk_lens = np.full(tot, 255, dtype=np.uint8)
    last = np.cumsum(nch) - 1
    chunk_lens[last] = (lens - (nch - 1) * 255).astype(np.uint8)
    # starts // w indexes bottom-up rows directly; each row ends in an
    # end-of-line pair (00 00), so chunk j is pair j + (its row)
    pos = 2 * (np.arange(tot) + np.repeat(starts // w, nch))
    out = np.zeros(2 * (tot + h) + 2, dtype=np.uint8)
    out[pos] = chunk_lens
    out[pos + 1] = vals
    out[-1] = 1  # end of bitmap: 00 01
    return out.tobytes()


def write_bmp(path: str, img: np.ndarray, rle: bool = True) -> None:
    """Write an (H, W, 3) uint8 RGB array as an 8-bit palette BMP."""
    palette, indices = _build_palette(np.asarray(img, dtype=np.uint8))
    write_indexed_bmp(path, palette, indices, rle=rle)


def write_indexed_bmp(path: str, palette: np.ndarray, indices: np.ndarray,
                      rle: bool = True) -> None:
    """Write (H, W) uint8 indices into a (P <= 256, 3) RGB palette as an
    8-bit palette BMP: RLE8 where that is shorter than the raw rows."""
    h, w = indices.shape
    pal256 = np.zeros((256, 4), dtype=np.uint8)
    pal256[: len(palette), 0] = palette[:, 2]  # blue
    pal256[: len(palette), 1] = palette[:, 1]  # green
    pal256[: len(palette), 2] = palette[:, 0]  # red

    if rle:
        data = _rle8_encode(indices)
        compression = BI_RLE8
        if len(data) >= h * ((w + 3) & ~3):  # RLE not worth it
            data = _raw_rows(indices)
            compression = BI_RGB
    else:
        data = _raw_rows(indices)
        compression = BI_RGB

    headers_size = 14 + 40 + 256 * 4
    file_size = headers_size + len(data)
    with open(path, "wb") as f:
        f.write(struct.pack("<2sIHHI", b"BM", file_size, 0, 0, headers_size))
        f.write(
            struct.pack(
                "<IiiHHIIiiII",
                40, w, h, 1, 8, compression, len(data),
                2835, 2835, 256, 0,
            )
        )
        f.write(pal256.tobytes())
        f.write(data)


def _raw_rows(indices: np.ndarray) -> bytes:
    h, w = indices.shape
    stride = (w + 3) & ~3
    rows = np.zeros((h, stride), dtype=np.uint8)
    rows[:, :w] = indices
    return rows[::-1].tobytes()


def read_bmp_info(path: str) -> dict:
    """Small BMP inspector (equivalent of bitmap.c showBitmapInfo)."""
    with open(path, "rb") as f:
        head = f.read(14 + 40)
    magic, size, _, _, offset = struct.unpack("<2sIHHI", head[:14])
    (hsz, w, h, planes, bpp, comp, imgsz, xppm, yppm, ncol, nimp) = (
        struct.unpack("<IiiHHIIiiII", head[14:54])
    )
    return {
        "magic": magic.decode(),
        "file_size": size,
        "data_offset": offset,
        "width": w,
        "height": h,
        "bpp": bpp,
        "compression": comp,
        "colors": ncol,
    }
