"""Rotated FASTA and blocks report of a job (phase ``rot.artifacts``): the
median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("rot.artifacts")
