"""Herring: sumcheck over bilinear modules + pairing-based inner-
product argument (port of gemini_tpu/herring; src/herring/, upstream
status WIP).

Generalizes the twisted-scalar-product sumcheck from F x F -> F to
bilinear modules M: Lhs x Rhs -> Target (module.rs:11-28), with the
instances FModule (F x F -> F), G1Module (G1 x F -> G1), G2Module,
PModule (G1 x G2 -> GT via pairings) and GtModule (GT x F -> GT).

Host-only, as in gemini_tpu: group and pairing arithmetic run over the
port's own refimpl, hostcurve, serialize.fq_to_bytes and transcript
(the same tier as the reference's verifier-side pairing code), and the
module adds no device path.  The device paths apply to Fr-side provers
through the main sumcheck module.
"""

from .modules import FModule, G1Module, G2Module, PModule, GtModule
from .sumcheck import ModuleSumcheck, ModuleTimeProver, ModuleWitness
from .ipa import Crs, Vrs, InnerProductProof
from .space import (
    CrsStream, ModuleElasticProver, ModuleSpaceProver, folded_stream,
)

__all__ = [
    "FModule", "G1Module", "G2Module", "PModule", "GtModule",
    "ModuleSumcheck", "ModuleTimeProver", "ModuleWitness",
    "Crs", "Vrs", "InnerProductProof",
    "CrsStream", "ModuleElasticProver", "ModuleSpaceProver",
    "folded_stream",
]
