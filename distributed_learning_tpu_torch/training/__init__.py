"""Gossip training loop of the port, its experiment config and its
checkpoint files."""

from distributed_learning_tpu_torch.training.config import (
    DATASET_DEFAULTS,
    ExperimentConfig,
    wrn_lr_schedule,
)
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
    "ExperimentConfig",
    "DATASET_DEFAULTS",
    "wrn_lr_schedule",
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
