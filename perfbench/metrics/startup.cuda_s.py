"""The card's start-up in a fresh CLI process: the primary CUDA context
and the first loads of the kernel and host libraries (spans
``startup.cuda_context``, ``startup.kernel_library``,
``startup.host_library``), the median over the traced run's children
that ran without ``torch.profiler``, in s."""

import statistics

SPANS = ("startup.cuda_context", "startup.kernel_library",
         "startup.host_library")


def read(run):
    per_job = []
    for j in run.jobs:
        hit = [v for k, v in j.get("phases", {}).items() if k in SPANS]
        if hit:
            per_job.append((j.get("traced"), sum(hit)))
    vals = [v for traced, v in per_job if not traced] or \
        [v for _, v in per_job]
    return statistics.median(vals) if vals else None
