"""The anchors' matching statistics and attachment depths (span
``align.anchors.attach``: ``native.anchor_attach`` or its numpy twin):
the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.anchors.attach")
