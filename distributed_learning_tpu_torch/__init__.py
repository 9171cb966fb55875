"""PyTorch/CUDA port of ``distributed_learning_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference every module here is
held against; each file mirrors its counterpart's path
(``parallel/topology.py`` <-> ``distributed_learning_tpu/parallel/
topology.py``).  This package imports ``torch`` and never ``jax``, and
nothing of the JAX package: what it needs from there it keeps its own
copy of.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CPU tests do); with no card and no explicit CPU request they raise.
On a CPU tensor every kernel wrapper takes its plain PyTorch version; on
a CUDA tensor it launches the hand-written Hopper kernel.

The top-level names are the reference's (``dlt.Topology``,
``dlt.ConsensusEngine``, ``dlt.make_agent_mesh`` of the sharded route,
...), resolved on first use, and ``__version__``.
"""

import importlib

from distributed_learning_tpu_torch.device import resolve_device

__version__ = "0.1.0"

_LAZY = {
    "Topology": "distributed_learning_tpu_torch.parallel.topology",
    "gamma": "distributed_learning_tpu_torch.parallel.topology",
    "spectral_gap": "distributed_learning_tpu_torch.parallel.topology",
    "ConsensusEngine": "distributed_learning_tpu_torch.parallel.consensus",
    "Mixer": "distributed_learning_tpu_torch.parallel.consensus",
    "make_agent_mesh": "distributed_learning_tpu_torch.parallel.consensus",
    "find_optimal_weights": "distributed_learning_tpu_torch.parallel.fast_averaging",
    "solve_fastest_mixing": "distributed_learning_tpu_torch.parallel.fast_averaging",
    "PushSumEngine": "distributed_learning_tpu_torch.parallel.pushsum",
    "push_sum_matrix": "distributed_learning_tpu_torch.parallel.pushsum",
}


def __getattr__(name):
    try:
        module = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


__all__ = ["resolve_device", *_LAZY, "__version__"]
