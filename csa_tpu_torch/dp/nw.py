"""Batched global Needleman-Wunsch scores (counterpart of
:mod:`csa_tpu.dp.pallas_nw`).

``pairwise_nw_scores(a_batch, b_batch, device)`` returns, for each of the
B pairs, the global NW score of ``a_batch[p]`` (length la) against
``b_batch[p]`` (length lb) with +1 for a match and -1 for a mismatch or a
gap (``dynamicprogramming.c`` Score() semantics).  The scoring is fixed,
not the run's.  Codes are compared for equality only, so pad codes that
differ between the two sides never match anything.  The result is a
``(B,)`` int32 tensor on ``device``.

On a CUDA device the whole batch is one launch of the hand-written
kernel (``csrc/nw.cu``: each pair's rows cut into bands of one warp, the
bands on a ticket queue, each band handing its bottom row to the next in
chunks of 256 columns); on the CPU the plain version runs; any
other device raises.  There is no fallback between the two.
``nw_scores_host`` scores the same pairs with the native host library,
one pair at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, native

__all__ = ["pairwise_nw_scores", "pairwise_nw_scores_plain",
           "nw_scores_host", "plan"]

STRIP = 16  # rows a lane: csrc/nw.cu's kStrip, fixed when it compiles
LANES = 32  # lanes a warp: a band is at most LANES * STRIP rows


def plan(la: int, strip: int = STRIP):
    """(rows a lane S, rows a band h, bands nb) of the kernel's launch:
    la rows cut into the fewest bands of at most ``LANES * S`` rows, of
    nearly equal height, each a multiple of S but the last, which takes
    what is left: ``(nb - 1) * h < la <= nb * h``.  The kernel's S is
    ``STRIP``; another ``strip`` only shapes the tests' numpy twin."""
    units = -(-la // strip)  # S-row strips the rows need
    per = -(-units // -(-units // LANES))  # strips a band
    return strip, per * strip, -(-units // per)


def _as_codes(x, device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
    if t.dim() != 2:
        raise ValueError(f"NW batches are (B, L) code arrays, got "
                         f"{tuple(t.shape)}")
    return t.to(device=device, dtype=torch.int32).contiguous()


def pairwise_nw_scores_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: an anti-diagonal loop, vectorised over
    the batch and the rows, in int32.  Entry ``i`` of diagonal ``d``
    holds cell ``(i, d - i)``; row 0 is ``-j`` and column 0 is ``-i``."""
    B, la = a.shape
    lb = b.shape[1]
    if la == 0 or lb == 0:
        return torch.full((B,), -(la + lb), dtype=torch.int32,
                          device=a.device)
    br = b.flip(1)  # diagonal d reads b[d - i - 1] = br[lb - d + i]
    diags = [torch.zeros((B, la + 1), dtype=torch.int32, device=a.device)
             for _ in range(3)]
    for d in range(1, la + lb + 1):
        cur, p1, p2 = diags[d % 3], diags[(d - 1) % 3], diags[(d - 2) % 3]
        lo, hi = max(1, d - lb), min(la, d - 1)
        if lo <= hi:
            sub = torch.where(
                a[:, lo - 1:hi] == br[:, lb - d + lo:lb - d + hi + 1], 1, -1
            ).to(torch.int32)
            cur[:, lo:hi + 1] = torch.maximum(
                p2[:, lo - 1:hi] + sub,
                torch.maximum(p1[:, lo - 1:hi], p1[:, lo:hi + 1]) - 1,
            )
        if d <= lb:
            cur[:, 0] = -d
        if d <= la:
            cur[:, d] = -d
    return diags[(la + lb) % 3][:, la].clone()


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, la = a.shape
    lb = b.shape[1]
    out = torch.empty(B, dtype=torch.int32, device=a.device)
    _, h, nb = plan(la)
    # one carry row a (pair, band boundary), and the ticket followed by
    # one published column count a boundary
    carry = (torch.empty((B, nb - 1, lb), dtype=torch.int32, device=a.device)
             if nb > 1 else None)
    counters = torch.zeros(1 + B * (nb - 1), dtype=torch.int32,
                           device=a.device)
    kernels.COUNTS["nw"] += 1
    kernels.call(
        "csa_nw_scores", a.data_ptr(), b.data_ptr(), la, lb, B, h, nb,
        out.data_ptr(), 0 if carry is None else carry.data_ptr(),
        counters.data_ptr(), kernels.stream_ptr(a.device),
    )
    return out


def pairwise_nw_scores(a_batch, b_batch, device) -> torch.Tensor:
    """Global NW score (+1 match / -1 mismatch / -1 gap) per batch pair.

    a_batch: (B, la), b_batch: (B, lb) integer codes (numpy arrays or
    tensors).  Returns a (B,) int32 tensor on ``device``."""
    a = _as_codes(a_batch, device)
    b = _as_codes(b_batch, device)
    if a.shape[0] != b.shape[0]:
        raise ValueError(f"batch sizes differ: {a.shape[0]} vs {b.shape[0]}")
    if kernels.check_device(a, "pairwise_nw_scores") == "cpu":
        return pairwise_nw_scores_plain(a, b)
    B, la = a.shape
    lb = b.shape[1]
    if B == 0 or la == 0 or lb == 0:
        return torch.full((B,), -(la + lb), dtype=torch.int32, device=a.device)
    if 2 * (la + lb) > 2**31 - 1:
        raise ValueError(f"NW lengths too large for int32 scores: "
                         f"{la} x {lb}")
    return _launch(a, b)


def nw_scores_host(a_batch, b_batch) -> np.ndarray:
    """Host reference scores via the native pairwise kernel."""
    if not native.available():
        raise RuntimeError("the native host library is not built (no g++ "
                           "or make): nw_scores_host needs it")
    return np.asarray([native.pairwise_nw(np.asarray(a), np.asarray(b))
                       for a, b in zip(a_batch, b_batch)], dtype=np.int32)
