"""The aligned FASTA's write and its integrity check (spans
``align.save``, ``align.check_output``): the median over the traced
jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.save", "align.check_output")
