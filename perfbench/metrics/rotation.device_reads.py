"""The host's reads of device values in a job's staged rotation block
stage (counter ``idx.device_reads``): the median over the traced jobs,
a count."""

import statistics


def read(run):
    vals = [j["counters"]["idx.device_reads"] for j in run.jobs
            if "idx.device_reads" in j.get("counters", {})]
    return statistics.median(vals) if vals else None
