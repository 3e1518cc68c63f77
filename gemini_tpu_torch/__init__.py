"""gemini_tpu_torch — the PyTorch and CUDA port of gemini_tpu.

The package mirrors gemini_tpu's layout and names and keeps its limb
layout, so the two give identical limbs, points, transcripts and proof
bytes for the same inputs.  Device code is PyTorch; the G1 group-law
and Fq Montgomery kernels are hand-written CUDA C++ for Hopper
(csrc/, curve/g1_kernels.py).  Host-only modules (params, refimpl,
native, hostcurve, transcript, serialize, utils/trace) are the port's
own copies.  Entry points run on `cuda` unless the caller passes
`device="cpu"`.

Layers (bottom-up):

  refimpl/        pure-Python ground truth (fields, curves, pairing)
  fields/         batched limb-tensor Fr/Fq arithmetic (Montgomery)
  curve/          G1 points on limb tensors + the CUDA kernels
  ops/            MSM (sort-by-digit Pippenger), scans, poly, sparse
  kzg/            KZG polynomial commitment
  subprotocols/   sumcheck, tensorcheck, plookup, entry product
  relation/       R1CS frontend, joint sparsity (pSNARK index)
  snark/          non-preprocessing SNARK (time prover + verifier)
  psnark/         preprocessing SNARK (index, time prover, verifier)
  interop.py      numpy arrays of gemini_tpu objects -> port objects
"""

__version__ = "0.1.0"

from . import params  # noqa: F401
