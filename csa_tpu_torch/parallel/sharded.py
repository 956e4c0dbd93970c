"""Rank meshes (counterpart of ``_factor_mesh`` and ``make_mesh`` in
:mod:`csa_tpu.parallel.sharded`).

A :class:`Mesh` is a tuple of torch devices, one per rank, with a shape
and axis names.  A device may appear more than once: ranks that share a
card each get their own CUDA stream (:func:`rank_streams`), so their
kernels overlap on the card's SMs, and the CPU tests run meshes of 2-8
ranks on the one CPU device.  Ranks on different cards pass data by
peer copies; one process drives every rank.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]   # one per rank, row-major
    shape: Tuple[int, ...]
    axis: Tuple[str, ...]                # one name per dimension of shape

    @property
    def size(self) -> int:
        return len(self.devices)


def _factor_mesh(n: int) -> Tuple[int, int]:
    """Split n ranks into a (seq, pos) grid, favoring the seq axis."""
    best = (n, 1)
    a = 1
    while a * a <= n:
        if n % a == 0:
            best = (n // a, a)
        a += 1
    return best


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current device>``, so that ranks compare equal
    exactly when they share a card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_ranks: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (seq, pos) mesh of ``n_ranks`` ranks laid out round-robin over
    ``devices`` (default: every visible CUDA device; pass
    ``[torch.device("cpu")]`` for a CPU mesh).  ``shape`` defaults to
    :func:`_factor_mesh` of ``n_ranks``; ``n_ranks`` defaults to the
    product of ``shape``, else to the number of devices."""
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices (no CUDA device is visible; "
                         "pass devices=[torch.device('cpu')] for a CPU mesh)")
    if n_ranks is None:
        n_ranks = math.prod(shape) if shape is not None else len(devices)
    if shape is None:
        shape = _factor_mesh(n_ranks)
    if math.prod(shape) != n_ranks or n_ranks < 1:
        raise ValueError(f"make_mesh: shape {shape} does not hold "
                         f"{n_ranks} ranks")
    ranks = tuple(devices[r % len(devices)] for r in range(n_ranks))
    return Mesh(ranks, tuple(shape), ("seq", "pos"))


def relabel(mesh: Mesh, axis: str) -> Mesh:
    """The same ranks as a 1-D mesh named ``axis`` (JAX's
    ``Mesh(mesh.devices.reshape(-1), (axis,))``)."""
    return Mesh(mesh.devices, (mesh.size,), (axis,))


def rank_streams(mesh: Mesh) -> List[Optional[torch.cuda.Stream]]:
    """One new CUDA stream per rank on a CUDA device, None for a CPU rank.
    Each stream first waits on its device's current stream, so it sees
    every buffer the caller made before."""
    out = []
    for dev in mesh.devices:
        if dev.type != "cuda":
            out.append(None)
            continue
        s = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        out.append(s)
    return out


def on_rank(stream: Optional[torch.cuda.Stream]):
    """Context that makes ``stream`` (and its device) current; a no-op for
    a CPU rank."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def join_streams(streams) -> None:
    """Make each device's current stream wait on every rank stream, so no
    buffer the ranks use is freed or reused before they are done."""
    for s in streams:
        if s is not None:
            torch.cuda.current_stream(s.device).wait_stream(s)
