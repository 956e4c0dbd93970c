"""Chain linking and selection of a job (phase ``rot.chains``): the median
over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("rot.chains")
