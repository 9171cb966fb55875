"""Mixing-matrix validation, the matching schedule and Chebyshev weights
(port of ``distributed_learning_tpu/parallel/schedule.py``, numpy only).

:class:`MatchingSchedule` compiles a mixing matrix into matchings: the
support graph of ``W`` is edge-coloured greedily, and each colour class
is a set of vertex-disjoint pairs.  One gossip round is then
``x_i <- W[i,i] x_i + sum_r w_r[i] x_partner_r(i)``, one exchange per
matching.  The reference runs each matching as one ``ppermute``; the
port's sharded engine (``ConsensusEngine(mesh=)``) posts the
:meth:`MatchingSchedule.ppermute_pairs` of a matching as one batch of
send/recv pairs on ``torch.distributed``.  The rounds and
:meth:`MatchingSchedule.as_matrix` equal the reference's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from distributed_learning_tpu_torch.parallel.topology import Topology

__all__ = ["MatchingSchedule", "chebyshev_omegas", "validate_mixing_matrix"]


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


def _greedy_edge_coloring(
    n: int, edges: Sequence[Tuple[int, int]]
) -> List[List[Tuple[int, int]]]:
    """Partition edges into matchings (color classes) greedily.

    Each edge gets the smallest color unused at both endpoints; within a
    color the edges are vertex-disjoint by construction.
    """
    colors_at: List[set] = [set() for _ in range(n)]
    classes: List[List[Tuple[int, int]]] = []
    # Sort by max endpoint degree first for a tighter coloring.
    deg = np.zeros(n, dtype=int)
    for (u, v) in edges:
        deg[u] += 1
        deg[v] += 1
    order = sorted(edges, key=lambda e: -(deg[e[0]] + deg[e[1]]))
    for (u, v) in order:
        c = 0
        while c in colors_at[u] or c in colors_at[v]:
            c += 1
        while len(classes) <= c:
            classes.append([])
        classes[c].append((u, v))
        colors_at[u].add(c)
        colors_at[v].add(c)
    return classes


@dataclasses.dataclass(frozen=True)
class MatchingSchedule:
    """A mixing matrix compiled to matchings (one exchange each).

    Attributes
    ----------
    n:             number of agents.
    self_weights:  (n,) diagonal of W.
    matchings:     tuple of color classes; each is a tuple of disjoint
                   ``(i, j)`` pairs.
    weights:       (R, n) array; ``weights[r, i]`` is the weight agent ``i``
                   applies to its partner in matching ``r`` (0 if agent ``i``
                   is unmatched in that round).
    """

    n: int
    self_weights: np.ndarray
    matchings: Tuple[Tuple[Tuple[int, int], ...], ...]
    weights: np.ndarray

    @staticmethod
    def from_matrix(W: np.ndarray, *, atol: float = 1e-12) -> "MatchingSchedule":
        W = validate_mixing_matrix(W)
        n = W.shape[0]
        edges = [
            (i, j)
            for i in range(n)
            for j in range(i + 1, n)
            if abs(W[i, j]) > atol
        ]
        classes = _greedy_edge_coloring(n, edges)
        R = len(classes)
        weights = np.zeros((max(R, 1), n))
        for r, cls in enumerate(classes):
            for (i, j) in cls:
                weights[r, i] = W[i, j]
                weights[r, j] = W[j, i]
        return MatchingSchedule(
            n=n,
            self_weights=np.diag(W).copy(),
            matchings=tuple(tuple(sorted(cls)) for cls in classes),
            weights=weights,
        )

    @staticmethod
    def from_topology(
        topo: Topology, edge_weights: Sequence[float] | None = None
    ) -> "MatchingSchedule":
        """Compile a topology directly; uses Metropolis weights if no
        per-edge weights are given."""
        if edge_weights is None:
            W = topo.metropolis_weights()
        else:
            W = topo.mixing_matrix(edge_weights)
        return MatchingSchedule.from_matrix(W)

    @property
    def num_rounds(self) -> int:
        """Exchanges per gossip round (= chromatic index found)."""
        return len(self.matchings)

    def ppermute_pairs(self, r: int) -> Tuple[Tuple[int, int], ...]:
        """(source, destination) pairs of matching ``r``: both directions
        of every matched pair, the reference's ``ppermute`` pairs and the
        sharded engine's send/recv pairs."""
        out = []
        for (i, j) in self.matchings[r]:
            out.append((i, j))
            out.append((j, i))
        return tuple(out)

    def as_matrix(self) -> np.ndarray:
        """Reconstruct W (for testing / analytics)."""
        W = np.diag(self.self_weights.astype(np.float64)).copy()
        for r, cls in enumerate(self.matchings):
            for (i, j) in cls:
                W[i, j] = self.weights[r, i]
                W[j, i] = self.weights[r, j]
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
