"""Compute primitives: scans, polynomial and sparse helpers, EC scans
and the MSM pipeline.  Import submodules explicitly:

    from gemini_tpu_torch.ops import poly, scan
    from gemini_tpu_torch.ops.msm import msm, msm_mont_scalars
"""

from . import poly, scan  # noqa: F401  (leaf modules, no cycles)
