"""Rank meshes (counterpart of ``_factor_mesh`` and ``make_mesh`` in
:mod:`csa_tpu.parallel.sharded`).

A :class:`Mesh` is a tuple of torch devices, one per rank, with a shape
and axis names.  A device may appear more than once: ranks that share a
card each get their own CUDA stream (:func:`rank_streams`), so their
kernels overlap on the card's SMs, and the CPU tests run meshes of 2-8
ranks on the one CPU device.  Ranks on different cards of one process
pass data by peer copies.

A mesh may span several processes (:mod:`.distributed`): process p owns
a contiguous block of ranks, as ``jax.devices()`` orders the devices of
a multi-process run, and a rank that another process owns has ``None``
for its device.  Every process runs the same program over the same
mesh, each driving its own ranks.

:class:`Ranks` holds a mesh's streams and the exchanges between its
ranks, the counterparts of the collectives that JAX's ``shard_map``
programs use (``ppermute``, tiled ``all_gather``, ``psum`` and
``pmax``).  Inside a process they are stream waits and peer copies; an
exchange that crosses processes is a ``torch.distributed`` call that
every process issues in the same order.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils import PROFILER
from . import distributed


@dataclass(frozen=True)
class Mesh:
    # one per rank, row-major; None for a rank that another process owns
    devices: Tuple[Optional[torch.device], ...]
    shape: Tuple[int, ...]
    axis: Tuple[str, ...]                # one name per dimension of shape
    # the processes the ranks span; None: this process owns every rank
    world: Optional[distributed.World] = None

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def local(self) -> Tuple[int, ...]:
        """The ranks this process drives."""
        return tuple(r for r, d in enumerate(self.devices) if d is not None)

    @property
    def home(self) -> torch.device:
        """The device of this process's first rank."""
        return self.devices[self.local[0]]

    def owner(self, r: int) -> int:
        """The process that drives rank r."""
        return 0 if self.world is None else r * self.world.size // self.size


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
    """A (seq, pos) mesh of ``n_ranks`` ranks over every process of the
    world that :func:`.distributed.initialize` formed (this process
    alone without one).  Each process lays its block of ranks
    round-robin over ``devices`` (default: its visible CUDA devices;
    pass ``[torch.device("cpu")]`` for a CPU mesh).  ``shape`` defaults
    to :func:`_factor_mesh` of ``n_ranks``; ``n_ranks`` defaults to the
    product of ``shape``, else to one rank a device of every process."""
    world = distributed.current()
    procs = 1 if world is None else world.size
    if devices is None:
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if not devices:
        raise ValueError("make_mesh: no devices (no CUDA device is visible; "
                         "pass devices=[torch.device('cpu')] for a CPU mesh)")
    if n_ranks is None:
        n_ranks = (math.prod(shape) if shape is not None
                   else len(devices) * procs)
    if shape is None:
        shape = _factor_mesh(n_ranks)
    if math.prod(shape) != n_ranks or n_ranks < 1:
        raise ValueError(f"make_mesh: shape {shape} does not hold "
                         f"{n_ranks} ranks")
    if n_ranks % procs:
        raise ValueError(f"make_mesh: {n_ranks} ranks do not split evenly "
                         f"over {procs} processes")
    per = n_ranks // procs
    first = 0 if world is None else world.rank * per
    ranks = tuple(devices[(r - first) % len(devices)]
                  if first <= r < first + per else None
                  for r in range(n_ranks))
    return Mesh(ranks, tuple(shape), ("seq", "pos"), world)


def relabel(mesh: Mesh, axis: str) -> Mesh:
    """The same ranks as a 1-D mesh named ``axis`` (JAX's
    ``Mesh(mesh.devices.reshape(-1), (axis,))``)."""
    return dataclasses.replace(mesh, shape=(mesh.size,), axis=(axis,))


def local_mesh(mesh: Mesh, axis: str) -> Mesh:
    """This process's ranks as a 1-D mesh of their own named ``axis``
    (the whole mesh, relabelled, when one process drives every rank)."""
    devices = tuple(mesh.devices[r] for r in mesh.local)
    return Mesh(devices, (len(devices),), (axis,))


def rank_streams(mesh: Mesh) -> List[Optional[torch.cuda.Stream]]:
    """One new CUDA stream per rank on a CUDA device, None for a CPU rank
    and for a rank of another process.  Each stream first waits on its
    device's current stream, so it sees every buffer the caller made
    before."""
    out = []
    for dev in mesh.devices:
        if dev is None or dev.type != "cuda":
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


def unzip(outs: list, n: int) -> Tuple[list, ...]:
    """Per-rank n-tuples to n per-rank lists; a rank of another process
    (None) stays None in each."""
    return tuple([None if o is None else o[i] for o in outs]
                 for i in range(n))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Ranks:
    """The ranks that this process drives of a mesh: a stream a CUDA rank
    (:func:`rank_streams`) and the exchanges between ranks.  A per-rank
    list holds an entry for every rank of the mesh, ``None`` for a rank
    of another process.

    Work of rank r runs inside :meth:`on` ``(r)`` (or :meth:`each`), on
    r's stream.  A tensor that rank s made is read on rank r's stream
    only after r's stream waits on an event that s's stream recorded,
    and ``record_stream`` keeps the caching allocator from handing its
    memory out again before r is done with it.  Ranks on one card read
    each other's tensors in place and share one gathered tensor, made on
    the stream of the card's first rank; only ranks on different cards
    copy, by a peer copy on the sender's stream.  :meth:`finish` makes
    the caller's streams wait on every rank.

    Across processes (a mesh with a ``world``) the exchanges are
    ``torch.distributed`` calls on the world's group, issued in the same
    order on every process: ``batch_isend_irecv`` for :meth:`ppermute`,
    one ``all_gather`` of each process's local concatenation for
    :meth:`all_gather` (and so :meth:`psum` and :meth:`pmax`) and
    :meth:`gather_to_first`, a ``broadcast`` from the owner for
    :meth:`item`.  They run through the home rank, this process's first:
    under NCCL on the home rank's stream, which waits on the inputs and
    on which the outputs are read; under gloo through host memory.
    Every process ends a gather with the whole result on its home rank,
    so the stages that follow one run on every process alike.

    With ``--profile`` three counters add up what the exchanges move:
    ``rank_exchange_bytes``, the bytes that would pass between the ranks
    if each sat on a card of its own (the volume of JAX's collectives,
    the same on every process), ``rank_peer_copy_bytes``, the bytes that
    did pass between cards of this process, and ``rank_process_bytes``,
    the bytes that this process sent to others.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.devices = mesh.devices
        self.world = mesh.world
        self.local = mesh.local
        self.home = self.local[0]
        # calls between processes pass through host memory under gloo
        self.host_wire = self.world is not None and \
            self.world.backend == "gloo"
        self.streams = rank_streams(mesh)
        self.lead = {}          # device -> its first rank
        for r in self.local:
            self.lead.setdefault(self.devices[r], r)

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, r: int):
        return on_rank(self.streams[r])

    def each(self, fn, *per_rank) -> list:
        """``[fn(r, a[r], b[r], ...) for every rank r]`` of this process,
        each on its rank's stream; None for the others."""
        out = [None] * self.size
        for r in self.local:
            with self.on(r):
                out[r] = fn(r, *(a[r] for a in per_rank))
        return out

    def _block_bytes(self, xs) -> int:
        """Bytes of every rank's block together (blocks of one shape on
        every process of a mesh across processes)."""
        if self.world is None:
            return sum(_nbytes(x) for x in xs)
        return self.size * _nbytes(xs[self.home])

    # -- between processes --------------------------------------------

    def _wire(self, t: torch.Tensor, r: int) -> torch.Tensor:
        """Rank r's ``t`` as a call between processes takes it: a host
        copy under gloo (read on r's stream, which made it), else ``t``
        on the home rank's card, readable on its stream."""
        if self.host_wire:
            with self.on(r):
                return t.cpu()
        return self._recv(t, r, self.home)

    def _wire_empty(self, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer of ``like``'s shape and type on the wire."""
        if self.host_wire:
            return torch.empty(like.shape, dtype=like.dtype)
        with self.on(self.home):
            return torch.empty(like.shape, dtype=like.dtype,
                               device=self.devices[self.home])

    def _call(self):
        """Where a call between processes is issued: on the home rank's
        stream under NCCL."""
        return (contextlib.nullcontext() if self.host_wire
                else self.on(self.home))

    def _unwire(self, t: torch.Tensor) -> torch.Tensor:
        """What a call between processes wrote, as the home rank reads
        it."""
        dev = self.devices[self.home]
        if t.device == dev:
            return t
        with self.on(self.home):
            return t.to(dev)

    def _gather(self, xs) -> torch.Tensor:
        """``torch.cat(xs)`` over the ranks of every process, on the home
        rank's card and stream: one ``all_gather`` of each process's
        concatenation of its ranks' blocks (one shape on every rank)."""
        mine = [self._wire(xs[r], r) for r in self.local]
        if any(m.shape != mine[0].shape for m in mine):
            raise ValueError("all_gather across processes: the ranks' "
                             "blocks differ in shape")
        with self._call():
            part = (torch.cat(mine) if len(mine) > 1 else mine[0]).contiguous()
            parts = [torch.empty_like(part) for _ in range(self.world.size)]
            dist.all_gather(parts, part, group=self.world.group)
            full = torch.cat(parts)
        PROFILER.add("rank_process_bytes",
                     (self.world.size - 1) * _nbytes(part))
        return self._unwire(full)

    # -- exchanges ----------------------------------------------------

    def item(self, xs, r: int = 0) -> int:
        """A host int of rank r's one-element tensor ``xs[r]`` (read on
        r's stream, which made it), the same on every process: across
        processes, a broadcast from r's owner."""
        v = 0
        if self.devices[r] is not None:
            with self.on(r):
                v = int(xs[r])
        if self.world is None:
            return v
        with self._call():
            t = torch.tensor([v], dtype=torch.int64)
            if not self.host_wire:
                t = t.to(self.devices[self.home])
            dist.broadcast(t, src=self.mesh.owner(r), group=self.world.group)
            return int(t)

    def _recv(self, t: torch.Tensor, src: int, dst: int) -> torch.Tensor:
        """``t``, made on rank src's stream, as rank dst may read it (both
        of this process)."""
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
        ``pairs``; None where a rank receives nothing.  Between processes
        the receiver's buffer takes its own block's shape, as JAX's
        ``ppermute`` requires."""
        out = [None] * self.size
        ops, recvs = [], []
        for i, (src, dst) in enumerate(pairs):
            here_s = self.devices[src] is not None
            here_d = self.devices[dst] is not None
            nbytes = _nbytes(xs[src] if here_s else xs[dst] if here_d
                             else xs[self.home])
            PROFILER.add("rank_exchange_bytes", nbytes)
            if here_s and here_d:
                out[dst] = self._recv(xs[src], src, dst)
            elif here_s:
                ops.append(dist.P2POp(dist.isend, self._wire(xs[src], src),
                                      self.mesh.owner(dst), self.world.group,
                                      tag=i))
                PROFILER.add("rank_process_bytes", nbytes)
            elif here_d:
                buf = self._wire_empty(xs[dst])
                ops.append(dist.P2POp(dist.irecv, buf, self.mesh.owner(src),
                                      self.world.group, tag=i))
                recvs.append((dst, buf))
        if ops:
            with self._call():
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
        for dst, buf in recvs:
            out[dst] = self._recv(self._unwire(buf), self.home, dst)
        return out

    def _share(self, per_device: dict) -> list:
        """One tensor a device -> one a rank, the ranks of a card sharing
        theirs."""
        out = [None] * self.size
        for r in self.local:
            dev = self.devices[r]
            out[r] = self._recv(per_device[dev], self.lead[dev], r)
        return out

    def all_gather(self, xs) -> list:
        """Tiled all-gather: every rank gets ``torch.cat(xs)``, built once
        a card."""
        PROFILER.add("rank_exchange_bytes",
                     (self.size - 1) * self._block_bytes(xs))
        full = {}
        if self.world is not None:
            whole = self._gather(xs)
            for dev, lead in self.lead.items():
                full[dev] = self._recv(whole, self.home, lead)
            return self._share(full)
        for dev, lead in self.lead.items():
            parts = [self._recv(x, s, lead) for s, x in enumerate(xs)]
            with self.on(lead):
                full[dev] = torch.cat(parts) if len(parts) > 1 else parts[0]
        return self._share(full)

    def psum(self, xs) -> list:
        """Sum over the ranks of one scalar a rank, on every rank."""
        return self.each(lambda r, g: g.sum(), self.all_gather(
            self.each(lambda r, x: x.reshape(1), xs)))

    def pmax(self, xs) -> list:
        """Max over the ranks of one scalar a rank, on every rank."""
        return self.each(lambda r, g: g.max(), self.all_gather(
            self.each(lambda r, x: x.reshape(1), xs)))

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
            return [None if self.devices[r] is None
                    else tuple(p[r] for p in parts)
                    for r in range(self.size)]
        return self._share(done)

    def scatter(self, t: torch.Tensor) -> list:
        """Rank r's shard of ``t`` (on the home rank's device, made before
        these ranks' streams or on the caller's stream; every process
        holds the whole of it): a view on the home card, a copy on
        another."""
        S = t.shape[0] // self.size
        out = [None] * self.size
        for r in self.local:
            dev, s = self.devices[r], self.streams[r]
            part = t[r * S:(r + 1) * S]
            if dev != t.device:
                with self.on(self.home):
                    part = part.to(dev, non_blocking=True)
                if s is not None:
                    s.wait_stream(torch.cuda.current_stream(dev))
                PROFILER.add("rank_peer_copy_bytes", _nbytes(part))
            if s is not None:
                part.record_stream(s)
            out[r] = part
        PROFILER.add("rank_exchange_bytes",
                     _nbytes(t) * (self.size - 1) // self.size)
        return out

    def replicate(self, t: torch.Tensor) -> list:
        """``t`` (made on the caller's stream) on every rank: one copy a
        card."""
        on_dev = {dev: t if dev == t.device else t.to(dev)
                  for dev in self.lead}
        out = [None] * self.size
        for r in self.local:
            dev, s = self.devices[r], self.streams[r]
            if s is not None:
                s.wait_stream(torch.cuda.current_stream(dev))
                on_dev[dev].record_stream(s)
            out[r] = on_dev[dev]
        PROFILER.add("rank_exchange_bytes", _nbytes(t) * (self.size - 1))
        return out

    def gather_to_first(self, xs) -> torch.Tensor:
        """``torch.cat(xs)`` on the home rank's device and stream: rank 0
        when one process drives every rank, else every process's first
        rank (JAX replicates the result to every process)."""
        PROFILER.add("rank_exchange_bytes",
                     self._block_bytes(xs) - _nbytes(xs[self.home]))
        if self.world is not None:
            return self._gather(xs)
        parts = [self._recv(x, s, 0) for s, x in enumerate(xs)]
        with self.on(0):
            out = torch.cat(parts) if len(parts) > 1 else parts[0]
        return out

    def finish(self, *outs: torch.Tensor) -> None:
        """Make the caller's streams wait on every rank, and let them read
        ``outs`` (made on rank streams) safely from here on."""
        join_streams(self.streams)
        for t in outs:
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))
