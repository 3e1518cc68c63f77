"""Kernels (`curve/g1_kernels.py`, `csrc/g1_kernels.cu` g1_padd): the
least time of the padd lanes of the profiled prove (`roofline.PADD`,
lanes from `g1_kernels.LANES`) over padd_kernel's profiler device
time, in %."""

from proofbench.roofline import PADD


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if trace.device is None:
        return None
    lanes = trace.profiled_lanes["g1.lanes"].get("padd", 0)
    spent = trace.device.kernel_s.get("padd_kernel", 0.0)
    if lanes <= 0 or spent <= 0:
        return None
    return 100.0 * PADD.least_seconds(lanes) / spent
