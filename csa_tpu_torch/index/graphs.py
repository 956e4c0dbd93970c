"""One CUDA graph per static program: the port's counterpart of a jitted
JAX program run as one dispatch.

:func:`run` takes a program (a function of tensors whose shapes and
control flow depend only on its static key) and its inputs.  A CPU
device runs the program eagerly: that is its plain version.  On a CUDA
device the first call for a key copies the inputs into static buffers,
runs the program once on a side stream under
``torch.cuda.set_sync_debug_mode("error")`` (any host read raises,
and the caching allocator and the sorts' scratch are warmed, as JAX's
first call traces and compiles), then captures it into a
``torch.cuda.CUDAGraph`` with its own memory pool.  Every call then
copies its inputs into the static buffers, replays the graph and makes
one device-to-host copy of the output.  A capture or a replay that fails
raises; nothing falls back to an eager run.

Kernel launches made while capturing did not run: :data:`kernels.COUNTS`
gets them back out, and each replay adds them again.  The profiler's
counters ``graph_captures`` and ``graph_replays`` count both in a job.
The cache holds at most :data:`MAX_GRAPHS` graphs, the least recently
used going first; an entry's ``pool_bytes`` is the memory its capture
reserved and ``capture_s`` the wall of its warm-up and capture.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, Hashable, Sequence

import numpy as np
import torch

from .. import kernels
from ..utils import PROFILER

# One block-stage graph's pool, measured by chip_smoke.py's phase `fused`
# on an NVIDIA H100 80GB HBM3 (PERF.md section 5): 140 MiB at Primates
# (16 x 17,408), 226 MiB at Set3 (19 x 20,480) and 2,034 MiB at the
# largest size measured (8 x 500,736); a linear-sort graph 62, 62 and
# 836 MiB.  So a full cache of graphs up to that size holds at most
# about 16 GiB.
MAX_GRAPHS = 8

STATS = {"captures": 0, "replays": 0}


class Captured:
    """A captured program: its graph, static input and output buffers,
    the kernel launches one replay makes, and the memory it holds."""

    __slots__ = ("graph", "inputs", "output", "launches", "pool_bytes",
                 "capture_s")


_CACHE: "OrderedDict[Hashable, Captured]" = OrderedDict()


def clear() -> None:
    """Drop every captured graph (their pools go back to the allocator)."""
    _CACHE.clear()


def entries():
    """(key, pool bytes, capture seconds, launches a replay) of each
    cached graph."""
    return [(key, c.pool_bytes, c.capture_s, dict(c.launches))
            for key, c in _CACHE.items()]


def _capture(device, program: Callable, inputs: Sequence[torch.Tensor]):
    t0 = time.perf_counter()
    cap = Captured()
    cap.inputs = tuple(x.to(device, copy=True) for x in inputs)
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.stream(side):
            program(*cap.inputs)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    cur.wait_stream(side)
    torch.cuda.synchronize(device)
    # the capture empties the allocator's cache first: do it here, so
    # that the growth of the reserved memory is the graph's own pool
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    before = dict(kernels.COUNTS)
    cap.graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(cap.graph):
            cap.output = program(*cap.inputs)
    finally:
        cap.launches = {n: kernels.COUNTS[n] - before[n] for n in before}
        kernels.COUNTS.update(before)
    cap.pool_bytes = torch.cuda.memory_reserved(device) - reserved
    cap.capture_s = time.perf_counter() - t0
    STATS["captures"] += 1
    PROFILER.add("graph_captures", 1)
    return cap


def run(key: Hashable, program: Callable,
        inputs: Sequence[torch.Tensor], device) -> np.ndarray:
    """``program(*inputs)`` on ``device`` as a host array: eagerly on the
    CPU, as a replay of the graph cached under ``(device, key)`` on a
    CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return program(*(x.to(device) for x in inputs)).numpy()
    if device.type != "cuda":
        raise ValueError(f"graphs.run: no route for device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    full = (device, key)
    cap = _CACHE.get(full)
    if cap is None:
        cap = _capture(device, program, inputs)
        _CACHE[full] = cap
        while len(_CACHE) > MAX_GRAPHS:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(full)
        for buf, x in zip(cap.inputs, inputs):
            buf.copy_(x)
    cap.graph.replay()
    for n, d in cap.launches.items():
        kernels.COUNTS[n] += d
    STATS["replays"] += 1
    PROFILER.add("graph_replays", 1)
    return cap.output.cpu().numpy()
