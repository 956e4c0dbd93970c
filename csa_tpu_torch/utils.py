"""Phase timing and tracing for the port.

:class:`PhaseTimer` and ``PROFILER`` are the port's span recorder, grown
from its copy of :mod:`csa_tpu.utils.profiling`: named wall-clock phases
and scalar counters (DP cells, device dispatches, device reads).
Disabled (the default) a phase costs one attribute check; ``--profile``
on the CLI enables it and prints the report.

Enabled, each phase is a :class:`Span` kept in memory: its name, start
and end on ``time.perf_counter_ns()``, its parent (the innermost span
still open on the same thread) and its job (one call of
``csa_tpu_torch.cli.main``, whose root span is ``cli.main``).  The
per-name sums ``phases`` and ``counts`` are kept as before.  While a
``torch.profiler`` runs, each phase also opens
``torch.autograd.profiler.record_function(name)``, so the host spans
sit in the device trace on its own clock.

``sync`` makes a timed phase end when its device work ends (PyTorch
returns before the card is done); it costs nothing with profiling off.
``torch_trace`` wraps a region in ``torch.profiler`` and writes a Chrome
trace, the counterpart of ``csa_tpu.utils.profiling.jax_trace``, with
the spans that no ``record_function`` range carries (process start-up,
``cli.main``) added on the trace's clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional, TextIO

import torch
from torch.autograd.profiler import record_function

__all__ = ["PROFILER", "PhaseTimer", "Span", "sync", "torch_trace"]

# the range torch_trace opens at the profiler's start to put the spans
# recorded outside the profiler on the trace's clock
CLOCK_ANCHOR = "csa_tpu_torch.clock_anchor"


def _profiler_running() -> bool:
    return torch._C._autograd._profiler_enabled()


class Span:
    """One phase: ``start`` and ``end`` in ``perf_counter_ns`` (``end``
    None while open), ``parent`` the index of the enclosing span in
    :attr:`PhaseTimer.spans` (-1 for a root), ``job`` the job it ran in,
    and ``ranged`` whether a ``record_function`` range of its name
    carries it in a ``torch.profiler`` trace."""

    __slots__ = ("name", "start", "end", "parent", "job", "ranged", "index")

    def __init__(self, name, start, parent, job, ranged, index):
        self.name, self.start, self.end = name, start, None
        self.parent, self.job, self.ranged = parent, job, ranged
        self.index = index

    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


class PhaseTimer:
    """Phase times are summed across threads (concurrent phases of the
    same name accumulate their overlapping wall-clock); each thread
    keeps its own stack of open spans.

    ``startup`` is set by the CLI's own entry
    (:func:`csa_tpu_torch.cli.console_main`) and cleared when its first
    job ends: only then does :meth:`startup_phase` record."""

    def __init__(self):
        self.enabled = False
        self.startup = False
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.counters: Dict[str, float] = {}
        self.spans: List[Span] = []
        self.jobs = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def reset(self):
        with self._lock:
            self.phases.clear()
            self.counts.clear()
            self.counters.clear()
            self.spans.clear()

    def _open(self, name: str, start: int, ranged: bool) -> Span:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        with self._lock:
            parent = -1
            if stack:
                top = stack[-1]
                # an enclosing span recorded before a reset has no index
                if top.index < len(self.spans) and \
                        self.spans[top.index] is top:
                    parent = top.index
            span = Span(name, start, parent, self.jobs, ranged,
                        len(self.spans))
            self.spans.append(span)
        stack.append(span)
        return span

    def _close(self, span: Span) -> None:
        span.end = time.perf_counter_ns()
        self._local.stack.pop()
        with self._lock:
            self.phases[span.name] = (self.phases.get(span.name, 0.0)
                                      + span.seconds())
            self.counts[span.name] = self.counts.get(span.name, 0) + 1

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        ranged = _profiler_running()
        with record_function(name) if ranged else nullcontext():
            span = self._open(name, time.perf_counter_ns(), ranged)
            try:
                yield
            finally:
                self._close(span)

    @contextmanager
    def job(self, name: str, start: int):
        """A job's root span from ``start``, a ``perf_counter_ns`` stamp
        taken before :attr:`enabled` was known: the spans opened inside
        belong to a new job.  No ``record_function`` range carries it
        (its start is past); :func:`torch_trace` writes it."""
        if not self.enabled:
            yield
            return
        self.jobs += 1
        span = self._open(name, start, False)
        try:
            yield
        finally:
            self._close(span)

    def record(self, name: str, start: int, end: int) -> None:
        """A root span of the current job that ended before the job's
        root opened (the process's start-up)."""
        if not self.enabled:
            return
        with self._lock:
            span = Span(name, start, -1, self.jobs, False, len(self.spans))
            span.end = end
            self.spans.append(span)
            self.phases[name] = self.phases.get(name, 0.0) + span.seconds()
            self.counts[name] = self.counts.get(name, 0) + 1

    def startup_phase(self, name: str):
        """:meth:`phase` during the CLI process's first job, else
        nothing."""
        return self.phase(name) if self.startup else nullcontext()

    def add(self, counter: str, value: float):
        if self.enabled:
            with self._lock:
                self.counters[counter] = self.counters.get(counter, 0.0) + value

    def self_seconds(self) -> Dict[str, float]:
        """Seconds of each phase that none of its child spans covers."""
        with self._lock:
            spans = list(self.spans)
            phases = dict(self.phases)
        covered: Dict[str, float] = defaultdict(float)
        for s in spans:
            if s.end is not None and s.parent >= 0 \
                    and spans[s.parent].end is not None:
                covered[spans[s.parent].name] += s.seconds()
        return {name: secs - covered[name] for name, secs in phases.items()}

    def root_seconds(self) -> float:
        """Seconds of the closed root spans: nested phases counted
        once."""
        with self._lock:
            return sum(s.seconds() for s in self.spans
                       if s.parent < 0 and s.end is not None)

    def report(self, out: TextIO):
        if not self.phases and not self.counters:
            return
        own = self.self_seconds()
        print("> [profile] phase breakdown (total, self without child "
              "phases):", file=out)
        for name, secs in sorted(
            self.phases.items(), key=lambda kv: -kv[1]
        ):
            n = self.counts.get(name, 1)
            per = f" ({n}x)" if n > 1 else ""
            print(f">   {name:<28} {secs:8.3f}s  self {own[name]:8.3f}s"
                  f"{per}", file=out)
        print(f">   {'TOTAL (root phases)':<28} {self.root_seconds():8.3f}s",
              file=out)
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

    def chrome_events(self, offset_us: float) -> List[dict]:
        """The closed spans that no ``record_function`` range carries, as
        Chrome trace events on a clock ``offset_us`` from
        ``perf_counter_ns`` (in us), marked ``cat: "csa_span"``."""
        with self._lock:
            spans = list(self.spans)
        pid, tid = os.getpid(), threading.get_native_id()
        return [{"ph": "X", "cat": "csa_span", "name": s.name,
                 "pid": pid, "tid": tid, "ts": s.start / 1e3 + offset_us,
                 "dur": (s.end - s.start) / 1e3,
                 "args": {"job": s.job, "parent": (spans[s.parent].name
                                                   if s.parent >= 0
                                                   else None)}}
                for s in spans if not s.ranged and s.end is not None]


PROFILER = PhaseTimer()


def sync(device) -> None:
    """Wait for ``device`` when phases are being timed."""
    if PROFILER.enabled and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextmanager
def torch_trace(trace_dir: Optional[str]):
    """Optional ``torch.profiler`` trace (CPU + CUDA activities) around a
    region, exported as ``<trace_dir>/trace.json``, with ``PROFILER``'s
    spans that no ``record_function`` range carries.  They are put on
    the trace's clock by the range :data:`CLOCK_ANCHOR`, opened at the
    profiler's start: its end and a ``perf_counter_ns`` read right after
    it are one instant (the first range's start is late by the
    profiler's first-call set-up)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        with record_function(CLOCK_ANCHOR):
            pass
        anchor_ns = time.perf_counter_ns()
        yield
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    anchor = next((e for e in trace["traceEvents"]
                   if e.get("name") == CLOCK_ANCHOR and e.get("ph") == "X"),
                  None)
    if anchor is None:
        raise RuntimeError(f"{path}: the profiler kept no {CLOCK_ANCHOR} "
                           "range, so the spans have no clock")
    offset_us = float(anchor["ts"]) + float(anchor["dur"]) - anchor_ns / 1e3
    trace["traceEvents"] += PROFILER.chrome_events(offset_us)
    with open(path, "w") as f:
        json.dump(trace, f)
