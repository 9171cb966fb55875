"""Mixing-matrix validation and Chebyshev weights (port of the numpy
part of ``distributed_learning_tpu/parallel/schedule.py``).

The ppermute matching schedule of the reference serves the sharded
route, which this port does not have yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["chebyshev_omegas", "validate_mixing_matrix"]


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


def chebyshev_omegas(gamma: float, num_rounds: int) -> np.ndarray:
    """Chebyshev semi-iteration weights ``omega_1 .. omega_K`` (float64)
    for accelerated averaging with ``||W - 11^T/n||_2 <= gamma < 1``:
    ``x_{k+1} = omega_{k+1} (W x_k - x_{k-1}) + x_{k-1}`` with
    ``omega_1 = 1``, ``omega_2 = 2 / (2 - gamma^2)`` and
    ``omega_{k+1} = 1 / (1 - (gamma^2 / 4) omega_k)``.  ``omega_1`` is
    unused by the first (plain) round but kept for indexing.  The weights
    depend on ``gamma`` only, so ``chebyshev_omegas(g, t)`` is a prefix of
    ``chebyshev_omegas(g, T)`` for ``t <= T``."""
    if not (0.0 <= gamma < 1.0):
        raise ValueError(f"need 0 <= gamma < 1, got {gamma}")
    omegas = np.empty(max(num_rounds, 1))
    omegas[0] = 1.0
    if num_rounds > 1:
        omegas[1] = 2.0 / (2.0 - gamma**2)
        for k in range(2, num_rounds):
            omegas[k] = 1.0 / (1.0 - (gamma**2 / 4.0) * omegas[k - 1])
    return omegas[:num_rounds]
