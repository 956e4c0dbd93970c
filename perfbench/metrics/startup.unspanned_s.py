"""What a fresh CLI process pays outside its spans: the child's wall
minus ``startup.imports`` and ``cli.main`` (its spawn, the
interpreter's start before the package's import, its exit), the median
over the traced run's children that ran without ``torch.profiler``, in
s."""

import statistics


def read(run):
    vals = [j["wall_s"] - j["phases"]["startup.imports"]
            - j["phases"]["cli.main"]
            for j in run.jobs if not j.get("traced")
            and {"startup.imports", "cli.main"} <= set(j.get("phases", {}))]
    return statistics.median(vals) if vals else None
