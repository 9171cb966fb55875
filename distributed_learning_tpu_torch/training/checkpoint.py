"""Checkpoint files (port of ``distributed_learning_tpu/training/checkpoint.py``).

A checkpoint is one file written by ``torch.save``: a tree of dicts,
lists, numbers and CPU tensors (the trainer's parameters, statistics,
optimizer state, generator states, counters and CHOCO state; see
``GossipTrainer.save_checkpoint``).  It is read back with
``torch.load(weights_only=True)``, which unpickles nothing but such
trees.  Saving keeps the reference's atomic write: the new file is
written in full beside the old one and then renamed over it, so a save
that fails leaves the previous checkpoint as it was.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "check_structure"]


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to the file ``path``, replacing any file there only
    once the new one is complete."""
    path = os.path.abspath(path)
    tmp = path + ".tmp-save"
    try:
        torch.save(tree, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def check_structure(got: Any, want: Any, where: str = "") -> None:
    """Raise ``ValueError`` at the first place where ``got`` lacks a key
    of the template ``want`` (or has another), or holds a tensor of
    another shape or dtype."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(
                f"checkpoint structure differs at {where or 'the root'}: keys "
                f"{sorted(map(str, got)) if isinstance(got, dict) else type(got).__name__}"
                f", template {sorted(map(str, want))}"
            )
        for key in want:
            check_structure(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor) or got.shape != want.shape or got.dtype != want.dtype:
            desc = (f"{tuple(got.shape)} {got.dtype}" if isinstance(got, torch.Tensor)
                    else type(got).__name__)
            raise ValueError(
                f"checkpoint structure differs at {where}: {desc}, template "
                f"{tuple(want.shape)} {want.dtype}"
            )


def restore_checkpoint(path: str, template: Optional[Any] = None) -> Any:
    """Read the tree saved at ``path`` (CPU tensors).  With ``template``,
    every dict must have the template's keys and every tensor its shape
    and dtype, else ``ValueError`` names the first difference."""
    tree = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if template is not None:
        check_structure(tree, template)
    return tree
