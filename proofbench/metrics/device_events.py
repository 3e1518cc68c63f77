"""Device (launch path): the profiler's kernel, memcpy and memset events
in the profiled prove, events/proof."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if trace.device is None or not trace.profiled_jobs:
        return None
    return trace.device.events / trace.profiled_jobs
