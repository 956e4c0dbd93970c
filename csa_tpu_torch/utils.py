"""Phase timing and tracing for the port.

:class:`PhaseTimer` and ``PROFILER`` are the port's own copy of
:mod:`csa_tpu.utils.profiling`: a process-global timer of named
wall-clock phases and scalar counters (DP cells, device dispatches).
Disabled (the default) it costs one attribute check per use;
``--profile`` on the CLI enables it and prints the report.

``sync`` makes a timed phase end when its device work ends (PyTorch
returns before the card is done); it costs nothing with profiling off.
``torch_trace`` wraps a region in ``torch.profiler`` and writes a Chrome
trace, the counterpart of ``csa_tpu.utils.profiling.jax_trace``.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional, TextIO

import torch

__all__ = ["PROFILER", "PhaseTimer", "sync", "torch_trace"]


class PhaseTimer:
    """Phase times are summed across threads (concurrent phases of the
    same name accumulate their overlapping wall-clock)."""

    def __init__(self):
        self.enabled = False
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self.phases.clear()
            self.counts.clear()
            self.counters.clear()

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.phases[name] = self.phases.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1

    def add(self, counter: str, value: float):
        if self.enabled:
            with self._lock:
                self.counters[counter] = self.counters.get(counter, 0.0) + value

    def report(self, out: TextIO):
        if not self.phases and not self.counters:
            return
        total = sum(self.phases.values())
        print("> [profile] phase breakdown:", file=out)
        for name, secs in sorted(
            self.phases.items(), key=lambda kv: -kv[1]
        ):
            n = self.counts.get(name, 1)
            per = f" ({n}x)" if n > 1 else ""
            print(f">   {name:<28} {secs:8.3f}s{per}", file=out)
        print(f">   {'TOTAL (instrumented)':<28} {total:8.3f}s", file=out)
        dp_cells = self.counters.get("dp_cells", 0.0)
        dp_secs = self.phases.get("align.dp_fill", 0.0)
        if dp_cells and dp_secs:
            print(
                f"> [profile] DP cell-updates: {dp_cells:.3g} cells, "
                f"{dp_cells / dp_secs / 1e9:.3f} Gcells/s",
                file=out,
            )
        for name in sorted(self.counters):
            if name != "dp_cells":
                print(
                    f"> [profile] {name}: {self.counters[name]:.6g}",
                    file=out,
                )


PROFILER = PhaseTimer()


def sync(device) -> None:
    """Wait for ``device`` when phases are being timed."""
    if PROFILER.enabled and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def torch_trace(trace_dir: Optional[str]):
    """Optional ``torch.profiler`` trace (CPU + CUDA activities) around a
    region, exported as ``<trace_dir>/trace.json``."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
