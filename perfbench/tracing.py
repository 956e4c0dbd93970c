"""Device busy time, idle gaps and kernel times from a ``torch.profiler``
trace: in this process (:func:`from_profiler`) or from the Chrome trace
that ``CSA_TPU_TORCH_TRACE`` makes the CLI write (:func:`from_chrome`).

Both give device events and host spans as ``(name, start_us, end_us)``
on the trace's own clock; host spans are the ``record_function`` ranges
(the harness's ``job`` and the program's phases).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Tuple

Event = Tuple[str, float, float]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def from_profiler(prof) -> Tuple[List[Event], List[Event]]:
    """(device events, host spans) of a finished ``torch.profiler``.
    Device events are kernels, copies and memsets; the device-side
    mirrors of host ranges (``gpu_user_annotation``, named as the
    range) are not."""
    from torch.autograd import DeviceType

    on_device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        item = (ev.name(), start, start + ev.duration_ns() / 1e3)
        if ev.device_type() == DeviceType.CUDA:
            on_device.append(item)
        elif ev.is_user_annotation():
            host.append(item)
    ranges = {name for name, _, _ in host}
    return [d for d in on_device if d[0] not in ranges], host


def from_chrome(path: str):
    """(device events, (first start, last end) of every event) of a
    Chrome trace file."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    device, lo, hi = [], float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0))
        lo, hi = min(lo, s), max(hi, e)
        if ev.get("cat") in DEVICE_CATS:
            device.append((ev["name"], s, e))
    return device, ((lo, hi) if device or hi > lo else (0.0, 0.0))


def merged(events: List[Event]) -> List[Tuple[float, float]]:
    """The union of the events' intervals, sorted."""
    out: List[List[float]] = []
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events: List[Event], t0: float, t1: float) -> float:
    """Microseconds of [t0, t1] in which some device event ran."""
    return sum(max(0.0, min(e, t1) - max(s, t0)) for s, e in merged(events))


def short_name(name: str) -> str:
    """A kernel's name without its parameter list, return type and
    template arguments (instantiations of one template add up)."""
    head = name.replace("(anonymous namespace)", "anon").split("(")[0]
    head = head[5:] if head.startswith("void ") else head
    base, lt, _ = head.partition("<")
    return (base + ("<...>" if lt else "")).strip()


def top_ops(events: List[Event], n: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    total: Dict[str, float] = defaultdict(float)
    for name, s, e in events:
        total[short_name(name)] += (e - s) / 1e6
    return _largest(total, n)


def _largest(total: Dict[str, float], n: int) -> List[list]:
    return [[k, v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def _segments(spans: List[Event], t0: float, t1: float, outside: str):
    """[t0, t1] cut into (start, end, innermost open span) pieces; the
    spans nest (each is a ``with`` block of one thread)."""
    out = []
    stack: List[Event] = []
    t = t0

    def emit(until):
        nonlocal t
        until = min(until, t1)
        if until > t:
            out.append((t, until, stack[-1][0] if stack else outside))
            t = until

    for span in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= span[1]:
            emit(stack[-1][2])
            stack.pop()
        emit(span[1])
        stack.append(span)
    while stack:
        emit(stack[-1][2])
        stack.pop()
    emit(t1)
    return out


def idle_by_host(device: List[Event], spans: List[Event], t0: float,
                 t1: float, outside: str, n: int = 10) -> List[list]:
    """[what the host was doing, seconds] of the device's idle time in
    [t0, t1], summed by the innermost host span, largest first."""
    busy = merged(device)
    gaps, t = [], t0
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, t1)))
        t = max(t, e)
    if t < t1:
        gaps.append((t, t1))
    total: Dict[str, float] = defaultdict(float)
    segs = _segments(spans, t0, t1, outside)
    i = 0
    for gs, ge in gaps:
        while i < len(segs) and segs[i][1] <= gs:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < ge:
            s, e, label = segs[j]
            total[label] += max(0.0, min(e, ge) - max(s, gs)) / 1e6
            j += 1
    return _largest(total, n)
