"""Gossip training loop of the port, and its checkpoint files."""

from distributed_learning_tpu_torch.training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
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
    "restore_checkpoint",
    "save_checkpoint",
]
