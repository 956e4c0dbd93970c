"""Rank meshes (counterpart of ``_factor_mesh`` and ``make_mesh`` in
:mod:`csa_tpu.parallel.sharded`).

A :class:`Mesh` is a tuple of torch devices, one per rank, with a shape
and axis names.  A device may appear more than once: ranks that share a
card each get their own CUDA stream (:func:`rank_streams`), so their
kernels overlap on the card's SMs, and the CPU tests run meshes of 2-8
ranks on the one CPU device.  Ranks on different cards pass data by
peer copies; one process drives every rank.

:class:`Ranks` holds a mesh's streams and the exchanges between its
ranks, the single-process counterparts of the collectives that JAX's
``shard_map`` programs use (``ppermute``, tiled ``all_gather``,
``psum`` and ``pmax``).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from ..utils import PROFILER


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Ranks:
    """The ranks of a mesh as one process drives them: a stream a CUDA
    rank (:func:`rank_streams`) and the exchanges between ranks.

    Work of rank r runs inside :meth:`on` ``(r)`` (or :meth:`each`), on
    r's stream.  A tensor that rank s made is read on rank r's stream
    only after r's stream waits on an event that s's stream recorded,
    and ``record_stream`` keeps the caching allocator from handing its
    memory out again before r is done with it.  Ranks on one card read
    each other's tensors in place and share one gathered tensor, made on
    the stream of the card's first rank; only ranks on different cards
    copy, by a peer copy on the sender's stream.  :meth:`finish` makes
    the caller's streams wait on every rank.

    With ``--profile`` two counters add up what the exchanges move:
    ``rank_exchange_bytes``, the bytes that would pass between the ranks
    if each sat on a card of its own (the volume of JAX's collectives),
    and ``rank_peer_copy_bytes``, the bytes that did pass between cards.
    """

    def __init__(self, mesh: Mesh):
        self.devices = mesh.devices
        self.streams = rank_streams(mesh)
        self.lead = {}          # device -> its first rank
        for r, dev in enumerate(self.devices):
            self.lead.setdefault(dev, r)

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, r: int):
        return on_rank(self.streams[r])

    def each(self, fn, *per_rank) -> list:
        """``[fn(r, a[r], b[r], ...) for every rank r]``, each on its
        rank's stream."""
        out = []
        for r in range(self.size):
            with self.on(r):
                out.append(fn(r, *(a[r] for a in per_rank)))
        return out

    def item(self, t: torch.Tensor, r: int = 0) -> int:
        """A host int of a one-element tensor of rank r (read on r's
        stream, which made it)."""
        with self.on(r):
            return int(t)

    def _recv(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``t``, made on rank src's stream, as rank dst may read it."""
        ss, ds = self.streams[src], self.streams[dst]
        ddev = self.devices[dst]
        if src == dst or ds is None:     # a CPU mesh has one device
            return t
        if self.devices[src] == ddev:
            ev = torch.cuda.Event()
            ev.record(ss)
            ds.wait_event(ev)
            t.record_stream(ds)
            return t
        # a peer copy runs on the source device's current stream, and the
        # destination device's current stream waits for it
        with on_rank(ss):
            y = t.to(ddev, non_blocking=True)
        ds.wait_stream(torch.cuda.current_stream(ddev))
        y.record_stream(ds)
        PROFILER.add("rank_peer_copy_bytes", _nbytes(t))
        return y

    def ppermute(self, xs, pairs) -> list:
        """Rank dst receives ``xs[src]`` for each ``(src, dst)`` in
        ``pairs``; None where a rank receives nothing."""
        out = [None] * self.size
        for src, dst in pairs:
            out[dst] = self._recv(xs[src], src, dst)
            PROFILER.add("rank_exchange_bytes", _nbytes(xs[src]))
        return out

    def _share(self, per_device: dict) -> list:
        """One tensor a device -> one a rank, the ranks of a card sharing
        theirs."""
        return [self._recv(per_device[dev], self.lead[dev], r)
                for r, dev in enumerate(self.devices)]

    def all_gather(self, xs) -> list:
        """Tiled all-gather: every rank gets ``torch.cat(xs)``, built once
        a card."""
        full = {}
        for dev, lead in self.lead.items():
            parts = [self._recv(x, s, lead) for s, x in enumerate(xs)]
            with self.on(lead):
                full[dev] = torch.cat(parts) if len(parts) > 1 else parts[0]
        PROFILER.add("rank_exchange_bytes",
                     (self.size - 1) * sum(_nbytes(x) for x in xs))
        return self._share(full)

    def psum(self, xs) -> list:
        """Sum over the ranks of one scalar a rank, on every rank."""
        return self.each(lambda r, g: g.sum(),
                         self.all_gather([x.reshape(1) for x in xs]))

    def pmax(self, xs) -> list:
        """Max over the ranks of one scalar a rank, on every rank."""
        return self.each(lambda r, g: g.max(),
                         self.all_gather([x.reshape(1) for x in xs]))

    def per_device(self, fn, *per_rank) -> list:
        """``fn(lead, a[lead], ...)`` once a card, on the stream of its
        first rank, shared by the card's ranks: for work on gathered
        tensors, which the ranks of a card hold in common."""
        done = {}
        for dev, lead in self.lead.items():
            with self.on(lead):
                done[dev] = fn(lead, *(a[lead] for a in per_rank))
        if all(isinstance(v, tuple) for v in done.values()):
            parts = [self._share({d: v[i] for d, v in done.items()})
                     for i in range(len(next(iter(done.values()))))]
            return list(zip(*parts))
        return self._share(done)

    def scatter(self, t: torch.Tensor) -> list:
        """Rank r's shard of ``t`` (on rank 0's device, made before these
        ranks' streams or on the caller's stream): a view on rank 0's
        card, a copy on another."""
        S = t.shape[0] // self.size
        out = []
        for r, (dev, s) in enumerate(zip(self.devices, self.streams)):
            part = t[r * S:(r + 1) * S]
            if dev != t.device:
                with self.on(0):
                    part = part.to(dev, non_blocking=True)
                if s is not None:
                    s.wait_stream(torch.cuda.current_stream(dev))
                PROFILER.add("rank_peer_copy_bytes", _nbytes(part))
            if s is not None:
                part.record_stream(s)
            out.append(part)
        PROFILER.add("rank_exchange_bytes",
                     _nbytes(t) * (self.size - 1) // self.size)
        return out

    def replicate(self, t: torch.Tensor) -> list:
        """``t`` (made on the caller's stream) on every rank: one copy a
        card."""
        on_dev = {dev: t if dev == t.device else t.to(dev)
                  for dev in self.lead}
        out = []
        for dev, s in zip(self.devices, self.streams):
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
                on_dev[dev].record_stream(s)
            out.append(on_dev[dev])
        PROFILER.add("rank_exchange_bytes", _nbytes(t) * (self.size - 1))
        return out

    def gather_to_first(self, xs) -> torch.Tensor:
        """``torch.cat(xs)`` on rank 0's device and stream."""
        parts = [self._recv(x, s, 0) for s, x in enumerate(xs)]
        with self.on(0):
            out = torch.cat(parts) if len(parts) > 1 else parts[0]
        PROFILER.add("rank_exchange_bytes",
                     sum(_nbytes(x) for x in xs[1:]))
        return out

    def finish(self, *outs: torch.Tensor) -> None:
        """Make the caller's streams wait on every rank, and let them read
        ``outs`` (made on rank streams) safely from here on."""
        join_streams(self.streams)
        for t in outs:
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))
