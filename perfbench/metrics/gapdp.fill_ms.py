"""Gap-DP fills of a job, on the card and the host (phase
``align.dp_fill``): the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.dp_fill")
