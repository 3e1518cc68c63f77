"""MSM pipeline: profiler device time of the port's group-law kernels
(C entries g1_*) and MSM glue kernels (msm_*) in the profiled prove,
ms/proof.  PyTorch's own kernels that the MSM launches (its sort, copies)
are not in it."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if trace.device is None or not trace.profiled_jobs:
        return None
    s = trace.device.library_s("g1") + trace.device.library_s("msm")
    return s * 1e3 / trace.profiled_jobs if s > 0 else None
