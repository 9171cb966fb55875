"""Topology, mixing-matrix checks, the dense consensus engine (plain,
async and Byzantine-robust rounds) and CHOCO compressed gossip."""

from distributed_learning_tpu_torch.parallel.compression import (
    ChocoGossipEngine,
    ChocoState,
    Compressor,
    FusedCompressor,
    approx_top_k,
    compressor_delta,
    compressor_from_spec,
    identity,
    int8_quant,
    random_k,
    scaled_sign,
    top_k,
)
from distributed_learning_tpu_torch.parallel.consensus import AsyncGossipState, ConsensusEngine
from distributed_learning_tpu_torch.parallel.robust import RobustConfig, as_robust_config
from distributed_learning_tpu_torch.parallel.schedule import (
    chebyshev_omegas,
    validate_mixing_matrix,
)
from distributed_learning_tpu_torch.parallel.topology import Topology, gamma

__all__ = [
    "AsyncGossipState",
    "ChocoGossipEngine",
    "ChocoState",
    "Compressor",
    "ConsensusEngine",
    "FusedCompressor",
    "approx_top_k",
    "compressor_delta",
    "compressor_from_spec",
    "identity",
    "int8_quant",
    "random_k",
    "RobustConfig",
    "as_robust_config",
    "scaled_sign",
    "top_k",
    "Topology",
    "chebyshev_omegas",
    "gamma",
    "validate_mixing_matrix",
]
