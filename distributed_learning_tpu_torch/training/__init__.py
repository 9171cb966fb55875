"""Gossip training loop of the port."""

from distributed_learning_tpu_torch.training.trainer import (
    ConsensusNode,
    GossipTrainer,
    MasterNode,
    get_loss,
    get_metric,
    make_optimizer,
    resolve_mixing_matrix,
)

__all__ = [
    "ConsensusNode",
    "GossipTrainer",
    "MasterNode",
    "get_loss",
    "get_metric",
    "make_optimizer",
    "resolve_mixing_matrix",
]
