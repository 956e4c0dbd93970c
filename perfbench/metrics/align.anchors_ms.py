"""Anchors of a job: linear suffix order and attachment (phase
``align.anchors``): the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.anchors")
