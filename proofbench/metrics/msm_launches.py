"""MSM pipeline (`ops/msm.py`, `ops/ec_scan.py`, `ops/msm_kernels.py`):
the program's exact launch counters of the group-law kernels
(`curve/g1_kernels.LAUNCHES`) and the MSM glue (`ops/msm_kernels.LAUNCHES`),
launches/proof over the span window."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if not trace.jobs:
        return None
    total = sum(trace.counts["g1.launches"].values()) + \
        sum(trace.counts["msm.launches"].values())
    return total / trace.jobs
