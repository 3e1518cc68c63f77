"""Preprocessing (holographic) SNARK for R1CS (port of
gemini_tpu/psnark; psnark/mod.rs).

After a one-time indexing step committing to the joint sparsity
pattern of (A, B, C), the verifier runs in time logarithmic in the
circuit size: lookups reduce matrix structure to plookup grand
products, which reduce to entry products, which reduce to sumchecks,
all closed by one batched tensorcheck.
"""

from .proof import Proof, PsnarkVerificationError, index, index_stream

__all__ = ["Proof", "PsnarkVerificationError", "index", "index_stream"]
