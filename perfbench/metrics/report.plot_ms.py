"""Circular plot of a job (phase ``report.circular_plot``): the median over
the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("report.circular_plot")
