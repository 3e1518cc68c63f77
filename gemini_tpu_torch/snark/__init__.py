"""Non-preprocessing elastic SNARK for R1CS (snark/mod.rs analogue).

Protocol (snark/mod.rs:4-56): commit w; challenge α; send
zc(α) = ⟨Cz, powers(α)⟩; sumcheck ⟨Az ∘ powers(α), Bz⟩ = zc(α);
challenge η; second sumcheck
⟨r_A^T A + η r_B^T B + η² r_C^T C, z⟩ with r_B = ⊗(1,ρ_j),
r_C = powers(α), r_A = r_B ∘ r_C; close both subclaims with one
tensorcheck over {abc_tensored, z} and base polynomial w.
"""

from .proof import Proof, SnarkVerificationError

__all__ = ["Proof", "SnarkVerificationError"]
