"""Gap-DP host merges and DeleteGappedColumns of a job (phases
``align.dp_merge``, ``align.dgc``): the median over the traced jobs, in
ms."""


def read(run):
    return run.phase_median_ms("align.dp_merge", "align.dgc")
