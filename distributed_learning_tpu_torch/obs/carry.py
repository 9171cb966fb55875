"""Device-side metrics carry (port of ``distributed_learning_tpu/obs/carry.py``):
per-step scalars kept on the device through a chunk, flushed to the
registry once per chunk host-side.

The trainer writes each step's (N,) loss, accuracy and gradient norm
into a device trace (``(steps, 3, N)`` an epoch, ``(k, steps, 3, N)`` a
superstep) whether or not a registry is attached, so toggling
observability cannot change the computation: an obs-on run is
bit-identical to an obs-off one.  The host reads each trace once per
chunk, the read it already pays for its loss curve, and
:func:`flush_chunk` records the same arrays as registry series.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from distributed_learning_tpu_torch.obs.registry import MetricsRegistry

__all__ = ["global_norm", "flush_chunk"]

Tensors = Union[torch.Tensor, Mapping[str, torch.Tensor], Iterable[torch.Tensor]]


def global_norm(tensors: Tensors, dim: Optional[int] = None) -> torch.Tensor:
    """L2 norm accumulated in float32 whatever the tensors' dtype, so
    bf16 state still reports a usable norm (the reference's
    ``global_norm``).  ``tensors`` is one tensor, a mapping or an
    iterable of them; the result is a 0-dim float32 tensor on their
    device.  ``dim`` (one tensor only) keeps the other axes: the
    trainer's per-agent gradient norm is ``global_norm(flat_grads,
    dim=1)`` over the ``(N, P)`` gradient buffer."""
    if isinstance(tensors, torch.Tensor):
        return torch.linalg.vector_norm(tensors, dim=dim, dtype=torch.float32)
    if dim is not None:
        raise ValueError("dim applies to a single tensor")
    leaves = list(tensors.values()) if isinstance(tensors, Mapping) else list(tensors)
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    norms = torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in leaves])
    return torch.linalg.vector_norm(norms)


def _host(value: Any) -> np.ndarray:
    """A tensor read to the host with one ``.cpu()``; anything else
    taken as an array (a trace the caller already read)."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return np.asarray(value)


def flush_chunk(
    registry: Optional[MetricsRegistry],
    carry: Mapping[str, Any],
    *,
    step0: int = 0,
    node_names: Optional[Sequence] = None,
    prefix: str = "train",
) -> Dict[str, np.ndarray]:
    """Flush one chunk's carried metric traces to ``registry``.

    ``carry`` maps metric name to a per-chunk array: scalars,
    ``(steps,)`` traces, ``(steps, n_nodes)`` stacked traces, or — when
    the chunk is an epoch superstep — ``(k_epochs, steps, n_nodes)``
    traces, whose two leading axes collapse to one ``k*steps`` step
    trace here.  A tensor is read to the host with exactly one
    ``.cpu()``; a numpy array (views of a buffer the caller read once,
    as the trainer's packed flush) is taken as it is.  Per-node chunk
    means are recorded as ``{prefix}.{name}/{node}`` series points at
    the chunk's final step, plus the cross-node mean as
    ``{prefix}.{name}``; scalars record one point at ``step0``.
    Returns the host arrays (original shapes) so the caller reuses them.
    """
    arrays = {k: _host(v) for k, v in carry.items()}
    if registry is None:
        return arrays
    for name, arr in arrays.items():
        key = f"{prefix}.{name}" if prefix else str(name)
        if arr.ndim == 0:
            registry.observe(key, float(arr), step=step0)
            continue
        flat = arr
        if arr.ndim >= 3 and node_names is not None and arr.shape[-1] == len(node_names):
            flat = arr.reshape(-1, arr.shape[-1])  # (k, steps, n) -> (k*steps, n)
        end = step0 + flat.shape[0]
        if flat.ndim >= 2 and node_names is not None and flat.shape[1] == len(node_names):
            for a, node in enumerate(node_names):
                registry.observe(f"{key}/{node}", float(flat[:, a].mean()), step=end)
        registry.observe(key, float(flat.mean()), step=end)
    return arrays
