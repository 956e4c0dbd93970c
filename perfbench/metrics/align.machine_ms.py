"""Anchor machine and HIS chain of a job (phases ``align.machine_init``,
``align.active_window``, ``align.his_chain``): the median over the
traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("align.machine_init",
                               "align.active_window",
                               "align.his_chain")
