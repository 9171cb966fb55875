"""Data pipelines: Titanic (tabular) and CIFAR-10/100 (vision) — port of
``distributed_learning_tpu/data`` with the same exports, plus
:func:`draw_augment` (the crop and flip draw that the JAX package makes
inside ``augment_batch``)."""

from distributed_learning_tpu_torch.data.titanic import (
    FEATURES,
    load_titanic,
    prepare_rows,
    split_data,
    synthetic_titanic,
    titanic_source,
)
from distributed_learning_tpu_torch.data.prefetch import (
    epoch_batches,
    prefetch_to_device,
)
from distributed_learning_tpu_torch.data.partition import (
    label_skew_shards,
    size_skew_shards,
)
from distributed_learning_tpu_torch.data.cifar import (
    CIFAR_MEAN,
    CIFAR_STD,
    augment_batch,
    draw_augment,
    normalized_pad_value,
    load_cifar,
    normalize,
    shard_dataset,
    synthetic_cifar,
)

__all__ = [
    "FEATURES",
    "load_titanic",
    "prepare_rows",
    "split_data",
    "synthetic_titanic",
    "titanic_source",
    "CIFAR_MEAN",
    "CIFAR_STD",
    "augment_batch",
    "draw_augment",
    "normalized_pad_value",
    "load_cifar",
    "normalize",
    "shard_dataset",
    "synthetic_cifar",
    "epoch_batches",
    "prefetch_to_device",
    "label_skew_shards",
    "size_skew_shards",
]
