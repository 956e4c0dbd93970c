"""Rotation block stage of a job, on its route (phase
``rot.block_stage[*]``): the median over the traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("rot.block_stage[")
