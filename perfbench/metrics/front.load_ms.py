"""FASTA load of a job (phase ``io.load_fasta``): the median over the
traced jobs, in ms."""


def read(run):
    return run.phase_median_ms("io.load_fasta")
