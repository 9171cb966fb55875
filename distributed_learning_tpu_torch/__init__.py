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
"""

from distributed_learning_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
