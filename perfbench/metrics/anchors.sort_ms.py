"""The anchors' linear suffix sort with its download (span
``align.anchors.sort``): the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.anchors.sort")
