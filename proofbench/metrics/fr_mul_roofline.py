"""Kernels (`fields/fr_kernels.py`, `csrc/fr_kernels.cu` fr_mul): the
least time of the fr_mul lanes of the profiled prove (`roofline.FR_MUL`,
lanes from `fr_kernels.LANES`) over fr_mul_kernel's profiler device
time, in %."""

from proofbench.roofline import FR_MUL


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if trace.device is None:
        return None
    lanes = trace.profiled_lanes["fr.lanes"].get("fr_mul", 0)
    spent = trace.device.kernel_s.get("fr_mul_kernel", 0.0)
    if lanes <= 0 or spent <= 0:
        return None
    return 100.0 * FR_MUL.least_seconds(lanes) / spent
