"""What a fresh CLI process pays outside its job's phases: the child's
wall minus the sum of its top-level ``--profile`` phases (interpreter,
``import torch``, CUDA context, library loads, exit), the median over
the traced run's children that ran without ``torch.profiler`` (the one
that ran with it pays the profiler's start-up too), in s."""

import statistics


def read(run):
    jobs = [j for j in run.jobs if "outside_s" in j]
    plain = [j["outside_s"] for j in jobs if not j.get("traced")]
    outside = plain or [j["outside_s"] for j in jobs]
    return statistics.median(outside) if outside else None
