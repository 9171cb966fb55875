"""Topology, fastest-mixing weights, mixing-matrix checks and schedules,
the consensus engine (dense: plain, pairwise, weighted, async and
Byzantine-robust rounds, the ``Mixer`` surface; sharded on
``torch.distributed`` with ``mesh=``, one agent a rank, ``multihost``),
CHOCO compressed gossip, push-sum, gradient tracking and EXTRA."""

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
from distributed_learning_tpu_torch.parallel.consensus import (
    AsyncGossipState,
    ConsensusEngine,
    Mixer,
    make_agent_mesh,
)
from distributed_learning_tpu_torch.parallel.extra import ExtraEngine, ExtraState
from distributed_learning_tpu_torch.parallel.fast_averaging import (
    FastAveragingResult,
    find_optimal_weights,
    solve_fastest_mixing,
)
from distributed_learning_tpu_torch.parallel.gradient_tracking import (
    GradientTrackingEngine,
    TrackingState,
)
from distributed_learning_tpu_torch.parallel.pushsum import PushSumEngine, push_sum_matrix
from distributed_learning_tpu_torch.parallel.robust import RobustConfig, as_robust_config
from distributed_learning_tpu_torch.parallel.schedule import (
    MatchingSchedule,
    chebyshev_omegas,
    validate_mixing_matrix,
)
from distributed_learning_tpu_torch.parallel.topology import (
    Topology,
    gamma,
    is_connected,
    spectral_gap,
)

__all__ = [
    "AsyncGossipState",
    "ChocoGossipEngine",
    "ChocoState",
    "Compressor",
    "ConsensusEngine",
    "ExtraEngine",
    "ExtraState",
    "FastAveragingResult",
    "FusedCompressor",
    "GradientTrackingEngine",
    "MatchingSchedule",
    "Mixer",
    "PushSumEngine",
    "RobustConfig",
    "Topology",
    "TrackingState",
    "approx_top_k",
    "as_robust_config",
    "chebyshev_omegas",
    "compressor_delta",
    "compressor_from_spec",
    "find_optimal_weights",
    "gamma",
    "identity",
    "int8_quant",
    "is_connected",
    "make_agent_mesh",
    "push_sum_matrix",
    "random_k",
    "scaled_sign",
    "solve_fastest_mixing",
    "spectral_gap",
    "top_k",
    "validate_mixing_matrix",
]
