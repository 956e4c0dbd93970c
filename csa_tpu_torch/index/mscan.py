"""Multi-channel inclusive prefix-max scans (counterpart of
:mod:`csa_tpu.index.mscan`).

``multi_cummax(chans)`` is the exact per-channel integer prefix max of an
``(M, N)`` tensor along axis 1, with the same options as the JAX package:
``reverse`` (suffix scans) and ``min_over_channels`` (the ``(N,)``
elementwise minimum over the scanned channels, the collect cascade's
all-sequences coverage).  ``multi_cummin`` is the same with a running
min (and ``max_over_channels``).

A tensor on the CPU takes the plain version (``torch.cummax`` /
``torch.cummin``); a tensor on a CUDA device launches the hand-written
kernel (``csrc/mscan.cu``: one pass, tiles of ``TILE`` elements chained
by decoupled look-back, max or min a template of the kernel); any other
device raises.  There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import kernels

TILE = 4096  # elements per block of csrc/mscan.cu (256 threads x 16 items)


def multi_cummax_plain(chans: torch.Tensor, *, reverse: bool = False,
                       min_over_channels: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``torch.cummax`` per channel."""
    return _scan_plain(chans, reverse, min_over_channels, is_min=False)


def multi_cummin_plain(chans: torch.Tensor, *, reverse: bool = False,
                       max_over_channels: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``torch.cummin`` per channel."""
    return _scan_plain(chans, reverse, max_over_channels, is_min=True)


def _scan_plain(chans, reverse, reduce, is_min):
    x = chans.to(torch.int32)
    if reverse:
        x = x.flip(1)
    out = (torch.cummin if is_min else torch.cummax)(x, 1).values
    if reverse:
        out = out.flip(1)
    if reduce:
        out = out.amax(0) if is_min else out.amin(0)
    return out


def scratch_words(M: int, N: int) -> int:
    """int64 words of the kernel's scratch: the ticket, then one
    look-back descriptor a (channel, tile)."""
    return 1 + M * max(1, -(-N // TILE))


def _launch(x: torch.Tensor, reverse: bool, reduce: bool,
            is_min: bool) -> torch.Tensor:
    M, N = x.shape
    out = torch.empty((N,) if reduce else (M, N), dtype=torch.int32,
                      device=x.device)
    # zeroed by the C entry on the launch's stream
    scratch = torch.empty(scratch_words(M, N), dtype=torch.int64,
                          device=x.device)
    kernels.COUNTS["mscan"] += 1
    kernels.call(
        "csa_mscan", x.data_ptr(), out.data_ptr(), scratch.data_ptr(), M, N,
        int(reverse), int(reduce), int(is_min), kernels.stream_ptr(x.device),
    )
    return out


def _scan(chans, reverse, reduce, is_min, what):
    if chans.dim() != 2:
        raise ValueError(f"{what} wants (M, N), got {tuple(chans.shape)}")
    if kernels.check_device(chans, what) == "cpu":
        return _scan_plain(chans, reverse, reduce, is_min)
    M, N = chans.shape
    if M == 0:
        raise ValueError(f"{what} needs at least one channel")
    if scratch_words(M, N) > 2**31:
        raise ValueError(f"{what}: {M} x {N} needs more than 2**31 - 1 "
                         "tiles")
    x = chans.to(torch.int32).contiguous()
    return _launch(x, reverse, reduce, is_min)


def multi_cummax(chans: torch.Tensor, *, reverse: bool = False,
                 min_over_channels: bool = False) -> torch.Tensor:
    """Per-channel inclusive prefix max of ``chans`` (M, N) along axis 1,
    as int32.  ``reverse`` scans right to left; ``min_over_channels``
    returns the (N,) minimum over the M scanned channels."""
    return _scan(chans, reverse, min_over_channels, False, "multi_cummax")


def multi_cummin(chans: torch.Tensor, *, reverse: bool = False,
                 max_over_channels: bool = False) -> torch.Tensor:
    """Per-channel inclusive prefix MIN of ``chans`` (M, N) along axis 1,
    as int32; ``max_over_channels`` returns the (N,) maximum over the M
    scanned channels."""
    return _scan(chans, reverse, max_over_channels, True, "multi_cummin")
