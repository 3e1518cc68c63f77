"""Device: 1 - (union of the device intervals / the profiled prove's
host window), in %.  The profiler stretches host time, so this reads
higher than an untraced prove would."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    d = trace.device
    if d is None or d.window_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)
