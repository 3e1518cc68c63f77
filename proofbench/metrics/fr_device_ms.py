"""Field (`fields/fr_kernels.py`, `ops/poly.py`): profiler device time of
the port's Fr kernels (fr_*) in the profiled prove, ms/proof."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if trace.device is None or not trace.profiled_jobs:
        return None
    s = trace.device.library_s("fr")
    return s * 1e3 / trace.profiled_jobs if s > 0 else None
