"""The blocks report, its CSV and block map BMP (span
``rot.artifacts.blocks``): the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("rot.artifacts.blocks")
