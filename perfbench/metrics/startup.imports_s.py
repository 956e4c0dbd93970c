"""Imports of a fresh CLI process (span ``startup.imports``: from the
package's import to ``cli.main``, ``import torch`` included): the median
over the traced run's children that ran without ``torch.profiler``, in
s."""

import statistics


def read(run):
    jobs = [j for j in run.jobs if "startup.imports" in j.get("phases", {})]
    plain = [j for j in jobs if not j.get("traced")] or jobs
    vals = [j["phases"]["startup.imports"] for j in plain]
    return statistics.median(vals) if vals else None
