"""Model registry (port of the ``get_model`` subset this slice needs).

``get_model(name, *args, **kwargs)`` resolves the reference's string model
names.  Only the transformer is ported; the vision/tabular zoo waits
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any

from distributed_learning_tpu_torch.models.transformer import TransformerLM

__all__ = ["TransformerLM", "get_model"]

_REGISTRY = {"transformer": TransformerLM}
_NOT_PORTED = ("lenet", "vggnet", "resnet", "wide-resnet", "wide_resnet", "ann", "mlp")


def get_model(name: str, *args: Any, **kwargs: Any):
    """Build a model by reference-compatible name.  A positional argument
    is the vocabulary size (the reference's ``model_args = [num_classes]``
    convention)."""
    key = name.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP.md: the WRN/Titanic path)"
        )
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; available: {sorted(_REGISTRY)}")
    if args:
        if "vocab_size" in kwargs:
            raise ValueError(
                f"vocab_size given both positionally ({args[0]}) and as a "
                f"keyword ({kwargs['vocab_size']})"
            )
        if len(args) > 1:
            raise ValueError(
                "positional model_args beyond num_classes are not supported; "
                "use keyword arguments"
            )
        kwargs["vocab_size"] = args[0]
    return _REGISTRY[key](**kwargs)
