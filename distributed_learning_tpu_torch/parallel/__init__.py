"""Topology, mixing-matrix checks and the dense consensus engine."""

from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine
from distributed_learning_tpu_torch.parallel.schedule import (
    chebyshev_omegas,
    validate_mixing_matrix,
)
from distributed_learning_tpu_torch.parallel.topology import Topology, gamma

__all__ = [
    "ConsensusEngine",
    "Topology",
    "chebyshev_omegas",
    "gamma",
    "validate_mixing_matrix",
]
