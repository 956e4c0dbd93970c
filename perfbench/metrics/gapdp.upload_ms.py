"""The gap DP's uploads to the card (phase ``align.dp_upload``, inside
``align.dp_fill``: the batch's host packing, its copies to the card and
the launch's scratch and direction store): the median over the traced
jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.dp_upload")
