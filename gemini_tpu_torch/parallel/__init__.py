"""Multi-device paths (port of gemini_tpu/parallel/): a `Mesh` of
torch devices driven from one process, the sharded sumcheck prover and
the lane-split MSMs."""

from .mesh import Mesh, default_mesh, shard_vector
from .msm import msm_batch_multichip, msm_multichip
from .sumcheck import (
    round_message_sharded,
    fold_sharded,
    ShardedTimeProver,
)
