"""Multi-channel inclusive prefix-max scans (counterpart of
:mod:`csa_tpu.index.mscan`).

``multi_cummax(chans)`` is the exact per-channel integer prefix max of an
``(M, N)`` tensor along axis 1, with the same options as the JAX package:
``reverse`` (suffix scans) and ``min_over_channels`` (the ``(N,)``
elementwise minimum over the scanned channels, the collect cascade's
all-sequences coverage).  ``multi_cummin`` negates around it.

A tensor on the CPU takes the plain version (``torch.cummax``); a tensor
on a CUDA device launches the hand-written kernel (``csrc/mscan.cu``);
any other device raises.  There is no fallback between the two.
"""

from __future__ import annotations

import torch

from .. import kernels

TILE = 2048  # elements per block of csrc/mscan.cu (256 threads x 8 items)


def multi_cummax_plain(chans: torch.Tensor, *, reverse: bool = False,
                       min_over_channels: bool = False) -> torch.Tensor:
    """The plain PyTorch version: ``torch.cummax`` per channel."""
    x = chans.to(torch.int32)
    if reverse:
        x = x.flip(1)
    out = torch.cummax(x, 1).values
    if reverse:
        out = out.flip(1)
    if min_over_channels:
        out = out.amin(0)
    return out


def _launch(x: torch.Tensor, reverse: bool, reduce_min: bool) -> torch.Tensor:
    M, N = x.shape
    out = torch.empty((N,) if reduce_min else (M, N), dtype=torch.int32,
                      device=x.device)
    tmax = torch.empty((M, max(1, -(-N // TILE))), dtype=torch.int32,
                       device=x.device)
    kernels.COUNTS["mscan"] += 1
    kernels.call(
        "csa_mscan", x.data_ptr(), out.data_ptr(), tmax.data_ptr(), M, N,
        int(reverse), int(reduce_min), kernels.stream_ptr(x.device),
    )
    return out


def multi_cummax(chans: torch.Tensor, *, reverse: bool = False,
                 min_over_channels: bool = False) -> torch.Tensor:
    """Per-channel inclusive prefix max of ``chans`` (M, N) along axis 1,
    as int32.  ``reverse`` scans right to left; ``min_over_channels``
    returns the (N,) minimum over the M scanned channels."""
    if chans.dim() != 2:
        raise ValueError(f"multi_cummax wants (M, N), got {tuple(chans.shape)}")
    if kernels.check_device(chans, "multi_cummax") == "cpu":
        return multi_cummax_plain(chans, reverse=reverse,
                                  min_over_channels=min_over_channels)
    M, N = chans.shape
    if M == 0:
        raise ValueError("multi_cummax needs at least one channel")
    if M > 65535:
        raise ValueError(f"multi_cummax takes at most 65535 channels, got {M}")
    x = chans.to(torch.int32).contiguous()
    return _launch(x, reverse, min_over_channels)


def multi_cummin(chans: torch.Tensor, *, reverse: bool = False,
                 max_over_channels: bool = False) -> torch.Tensor:
    """Per-channel inclusive prefix MIN (negation of multi_cummax)."""
    return -multi_cummax(-chans.to(torch.int32), reverse=reverse,
                         min_over_channels=max_over_channels)
