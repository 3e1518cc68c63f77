"""gemini_tpu_torch — the PyTorch and CUDA port of gemini_tpu.

The package mirrors gemini_tpu's layout and names and keeps its limb
layout, so the two give identical limbs, points, transcripts and proof
bytes for the same inputs.  Device code is PyTorch; the G1 group-law
and Fq Montgomery kernels are hand-written CUDA C++ for Hopper
(csrc/, curve/g1_kernels.py).  Host-only modules (params, refimpl,
native, hostcurve, transcript, serialize, utils/trace) are the port's
own copies, and so is herring/.  Entry points run on `cuda` unless the
caller passes `device="cpu"`.

Layers (bottom-up):

  refimpl/        pure-Python ground truth (fields, curves, pairing)
  fields/         batched limb-tensor Fr/Fq arithmetic (Montgomery)
  curve/          G1 points on limb tensors + the CUDA kernels
  ops/            MSM (sort-by-digit Pippenger), scans, poly, sparse
  kzg/            KZG polynomial commitment
  subprotocols/   sumcheck, tensorcheck, plookup, entry product
  relation/       R1CS frontend, joint sparsity (pSNARK index)
  snark/          non-preprocessing SNARK (time and elastic provers,
                  verifier)
  psnark/         preprocessing SNARK (index, index_stream, time and
                  elastic provers, verifier)
  streaming/      host-RAM vectors, space/elastic sumcheck, streaming
                  KZG and tensorcheck, the block ops of the elastic
                  provers
  herring/        module sumchecks and the pairing-based inner-product
                  argument (host-only)
  interop.py      numpy arrays of gemini_tpu objects -> port objects
"""

__version__ = "0.1.0"

from . import params  # noqa: F401

SPACE_TIME_THRESHOLD = 22  # lib.rs:76 analogue: host->HBM promotion bound
