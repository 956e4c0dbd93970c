"""8-bit palette BMP writer (equivalent of reference source/bitmap.c).

Own implementation from the BMP file format: BITMAPFILEHEADER +
BITMAPINFOHEADER + RGBQUAD palette + bottom-up, 4-byte-aligned 8-bit indexed
pixel rows, with optional RLE8 compression.  The palette is built from the
colors actually used (quantizing to at most 256 by nearest match), instead of
the reference's fixed color-cube palettes.
"""

from __future__ import annotations

import struct

import numpy as np

BI_RGB = 0
BI_RLE8 = 1


def _build_palette(img: np.ndarray, color_hint=None):
    """Map an (H, W, 3) uint8 image to (palette (P,3), indices (H,W)).

    color_hint: optional iterable of (r, g, b) colors known to cover the
    image (the Canvas tracks every color its draw calls used).  When the
    hint holds and has <= 256 entries, the palette maps via a sorted-key
    binary search instead of a full np.unique over H*W pixels; a wrong
    or oversized hint silently falls back to the exact path.
    """
    h, w, _ = img.shape
    keys = (
        (img[:, :, 0].astype(np.uint32) << 16)
        | (img[:, :, 1].astype(np.uint32) << 8)
        | img[:, :, 2].astype(np.uint32)
    ).reshape(-1)
    if color_hint is not None and 0 < len(color_hint) <= 256:
        hint = np.asarray(sorted(color_hint), dtype=np.uint32)
        hkeys = (hint[:, 0] << 16) | (hint[:, 1] << 8) | hint[:, 2]
        idx = np.searchsorted(hkeys, keys)
        idx[idx >= len(hkeys)] = 0
        if (hkeys[idx] == keys).all():
            pal = np.stack(
                [(hkeys >> 16) & 0xFF, (hkeys >> 8) & 0xFF, hkeys & 0xFF],
                axis=1,
            ).astype(np.uint8)
            return pal, idx.reshape(h, w).astype(np.uint8)
    uniq = np.unique(keys)
    # uniq is sorted and complete, so the inverse map is a binary search
    # (much cheaper than np.unique's return_inverse argsort)
    inverse = np.searchsorted(uniq, keys)
    if len(uniq) <= 256:
        pal = np.stack(
            [(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1
        ).astype(np.uint8)
        return pal, inverse.reshape(h, w).astype(np.uint8)
    # too many colors: keep the 256 most frequent, snap the rest
    counts = np.bincount(inverse)
    top = np.argsort(-counts)[:256]
    pal_keys = uniq[top]
    pal = np.stack(
        [(pal_keys >> 16) & 0xFF, (pal_keys >> 8) & 0xFF, pal_keys & 0xFF],
        axis=1,
    ).astype(np.int32)
    # nearest palette color for every pixel, vectorized over unique
    # colors via the expanded form argmin(|p|^2 - 2 u.p) — |u|^2 is
    # constant per row so the argmin (incl. first-min tie behavior) is
    # identical to the squared distance, without materializing the
    # (U, 256, 3) difference tensor
    ucol = np.stack(
        [(uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF], axis=1
    ).astype(np.int64)
    pal64 = pal.astype(np.int64)
    up = ucol @ pal64.T  # (U, 256) exact integer dot products
    pp = (pal64 ** 2).sum(axis=1)
    best = np.argmin(pp[None, :] - 2 * up, axis=1).astype(np.uint8)
    return pal.astype(np.uint8), best[inverse].reshape(h, w)


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
    # rows: starts // w indexes bottom-up rows directly
    chunk_row = np.repeat(starts // w, nch)
    per_row = np.bincount(chunk_row, minlength=h)
    row_bytes = per_row * 2 + 2  # chunks + end-of-line marker
    row_base = np.concatenate([[0], np.cumsum(row_bytes)[:-1]])
    chunk_base = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    within = np.arange(tot) - np.repeat(chunk_base, per_row)
    pos = row_base[chunk_row] + within * 2
    out = np.zeros(int(row_bytes.sum()) + 2, dtype=np.uint8)
    out[pos] = chunk_lens
    out[pos + 1] = vals
    # end-of-line 00 00 pairs are already zero; final end-of-bitmap:
    out[-2] = 0
    out[-1] = 1
    return out.tobytes()


def write_bmp(path: str, img: np.ndarray, rle: bool = True,
              color_hint=None) -> None:
    """Write an (H, W, 3) uint8 RGB array as an 8-bit palette BMP."""
    img = np.asarray(img, dtype=np.uint8)
    h, w, _ = img.shape
    palette, indices = _build_palette(img, color_hint=color_hint)
    pal256 = np.zeros((256, 4), dtype=np.uint8)
    pal256[: len(palette), 0] = palette[:, 2]  # blue
    pal256[: len(palette), 1] = palette[:, 1]  # green
    pal256[: len(palette), 2] = palette[:, 0]  # red

    if rle:
        data = _rle8_encode(indices)
        compression = BI_RLE8
        raw = _raw_rows(indices)
        if len(data) >= len(raw):  # RLE not worth it
            data = raw
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
