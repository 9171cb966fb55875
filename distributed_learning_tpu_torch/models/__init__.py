"""Model zoo of the port: logreg / MLP / LeNet / VGG / ResNet / WideResNet /
TransformerLM, every model agent-stacked (``models/_stacked.py``).

``get_model(name, *args, **kwargs)`` resolves the reference's string model
names (``MasterNode(model='lenet' | 'vggnet' | 'resnet' | 'wide-resnet')``,
``Man_Colab.ipynb`` cell 21) to the port's modules.
"""

from __future__ import annotations

from typing import Any

from distributed_learning_tpu_torch.models.logreg import (
    LogisticRegression,
    accuracy as logreg_accuracy,
    grad_step as logreg_grad_step,
    loss_fn as logreg_loss,
)
from distributed_learning_tpu_torch.models.mlp import ANNModel
from distributed_learning_tpu_torch.models.moe import MoEMLP
from distributed_learning_tpu_torch.models.transformer import TransformerLM, generate
from distributed_learning_tpu_torch.models.vision import LeNet, ResNet, VGG, WideResNet

_REGISTRY = {
    "lenet": LeNet,
    "vggnet": VGG,
    "resnet": ResNet,
    "wide-resnet": WideResNet,
    "wide_resnet": WideResNet,
    "ann": ANNModel,
    "mlp": ANNModel,
    "transformer": TransformerLM,
}
# Models whose first layer's width follows the input: flax infers it at
# init, the port needs it at construction.
_TAKES_INPUT_SHAPE = (LeNet, ANNModel)


def get_model(name: str, *args: Any, input_shape=None, **kwargs: Any):
    """Build a model by reference-compatible name.

    A positional argument follows the reference's ``model_args =
    [num_classes]`` convention: ``num_classes`` for the vision models,
    ``output_dim`` for ``ann``/``mlp``, ``vocab_size`` for the
    transformer.  ``input_shape`` (one sample's shape) reaches the models
    whose first layer depends on it and is ignored by the others.
    """
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    cls = _REGISTRY[key]
    if args:
        if cls is ANNModel:
            size_key = "output_dim"
        elif cls is TransformerLM:
            size_key = "vocab_size"
        else:
            size_key = "num_classes"
        if size_key in kwargs:
            raise ValueError(
                f"{size_key} given both positionally ({args[0]}) and as a "
                f"keyword ({kwargs[size_key]})"
            )
        if len(args) > 1:
            raise ValueError(
                "positional model_args beyond num_classes are not supported; "
                "use keyword arguments"
            )
        kwargs[size_key] = args[0]
    if input_shape is not None and cls in _TAKES_INPUT_SHAPE:
        kwargs.setdefault("input_shape", tuple(input_shape))
    return cls(**kwargs)


__all__ = [
    "ANNModel",
    "TransformerLM",
    "generate",
    "MoEMLP",
    "LeNet",
    "VGG",
    "ResNet",
    "WideResNet",
    "LogisticRegression",
    "logreg_loss",
    "logreg_grad_step",
    "logreg_accuracy",
    "get_model",
]
