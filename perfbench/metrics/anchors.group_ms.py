"""The anchors' grouping into border nodes (span
``align.anchors.group``): the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.anchors.group")
