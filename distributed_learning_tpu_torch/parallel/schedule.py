"""Mixing-matrix validation (port of the numpy part of
``distributed_learning_tpu/parallel/schedule.py``).

The ppermute matching schedule and Chebyshev omegas of the reference
serve the sharded and accelerated routes, which this port does not have
yet; only the dense engine's input check lives here.
"""

from __future__ import annotations

import numpy as np

__all__ = ["validate_mixing_matrix"]


def validate_mixing_matrix(W: np.ndarray, *, atol: float = 1e-8) -> np.ndarray:
    """Check W is square, symmetric, and row-stochastic (rows sum to 1).

    Symmetric + row-stochastic => doubly stochastic, which is what preserves
    the mean under mixing.
    """
    W = np.asarray(W, dtype=np.float64)
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f"mixing matrix must be square, got {W.shape}")
    if not np.allclose(W, W.T, atol=atol):
        raise ValueError("mixing matrix must be symmetric")
    if not np.allclose(W.sum(axis=1), 1.0, atol=atol):
        raise ValueError("mixing matrix rows must sum to 1")
    return W
