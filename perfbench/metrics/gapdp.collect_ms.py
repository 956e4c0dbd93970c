"""The gap DP's collection of paths from the card (phase
``align.dp_collect``, inside ``align.dp_fill``: the wait for the fill
and walk kernels, the paths' download and split): the median over the
traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.dp_collect")
