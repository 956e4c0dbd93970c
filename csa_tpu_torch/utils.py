"""Phase timing and tracing for the port.

``PROFILER`` is the JAX package's process-global phase timer, shared so
``--profile`` reports one breakdown whichever package ran a phase.
``sync`` makes a timed phase end when its device work ends (PyTorch
returns before the card is done); it costs nothing with profiling off.
``torch_trace`` wraps a region in ``torch.profiler`` and writes a Chrome
trace, the counterpart of ``csa_tpu.utils.profiling.jax_trace``.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from typing import Optional

import torch

from csa_tpu.utils.profiling import PROFILER

__all__ = ["PROFILER", "sync", "torch_trace"]


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
