"""Graph topology and spectral analytics for gossip consensus.

Port of ``distributed_learning_tpu/parallel/topology.py`` (numpy only, so
the port keeps its own copy rather than importing the JAX package).  The
subset here is what the dense gossip trainer needs: the edge-list, ring
and neighbor-dict constructors and the Metropolis mixing matrix.

Agents are arbitrary hashable *tokens*, indexed ``0..n-1`` in first-seen
order of the edge list; ``edges`` are stored canonically as
``(min(u, v), max(u, v))`` index pairs without duplicates or self-loops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List, Mapping, Tuple

import numpy as np

__all__ = ["Topology", "gamma"]


def _canonical_edges(
    edges: Iterable[Tuple[Hashable, Hashable]],
) -> Tuple[Dict[Hashable, int], List[Tuple[int, int]]]:
    """Index tokens in first-seen order and canonicalize the edge list."""
    index: Dict[Hashable, int] = {}
    out: List[Tuple[int, int]] = []
    seen = set()
    for (u, v) in edges:
        if u not in index:
            index[u] = len(index)
        if v not in index:
            index[v] = len(index)
        iu, iv = index[u], index[v]
        if iu == iv:
            continue  # self-loops carry no consensus information
        key = (min(iu, iv), max(iu, iv))
        if key in seen:
            continue
        seen.add(key)
        out.append(key)
    return index, out


@dataclasses.dataclass(frozen=True)
class Topology:
    """An undirected communication graph over ``n_agents`` gossip workers."""

    n_agents: int
    edges: Tuple[Tuple[int, int], ...]
    tokens: Tuple[Hashable, ...]

    @staticmethod
    def from_edges(edges: Iterable[Tuple[Hashable, Hashable]]) -> "Topology":
        """Build from an edge list over arbitrary hashable tokens."""
        index, canon = _canonical_edges(edges)
        if not index:
            raise ValueError("edge list is empty; need at least one edge")
        tokens = tuple(sorted(index, key=index.__getitem__))
        return Topology(n_agents=len(index), edges=tuple(canon), tokens=tokens)

    @staticmethod
    def from_neighbor_dict(
        topology: Mapping[Hashable, Mapping[Hashable, float]],
    ) -> Tuple["Topology", np.ndarray]:
        """Build from the ``{agent: {neighbor: weight}}`` format of the
        ``MasterNode(weights=...)`` argument.  Returns ``(topology, W)``
        where ``W[i, j]`` is agent *i*'s weight for neighbor *j*
        (self-weight on the diagonal)."""
        tokens = list(topology.keys())
        index = {t: i for i, t in enumerate(tokens)}
        # Neighbor tokens that never appear as top-level keys get indices
        # after the keys.
        for nbrs in topology.values():
            for s in nbrs:
                if s not in index:
                    index[s] = len(index)
                    tokens.append(s)
        n = len(tokens)
        W = np.zeros((n, n), dtype=np.float64)
        edges = set()
        for t, nbrs in topology.items():
            for s, w in nbrs.items():
                W[index[t], index[s]] = float(w)
                if index[t] != index[s]:
                    edges.add((min(index[t], index[s]), max(index[t], index[s])))
        topo = Topology(n_agents=n, edges=tuple(sorted(edges)), tokens=tuple(tokens))
        return topo, W

    @staticmethod
    def ring(n: int) -> "Topology":
        if n < 2:
            raise ValueError("ring needs n >= 2")
        return Topology.from_edges([(i, (i + 1) % n) for i in range(n)])

    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.n_agents, self.n_agents), dtype=np.float64)
        for (u, v) in self.edges:
            A[u, v] = A[v, u] = 1.0
        return A

    def degrees(self) -> np.ndarray:
        return self.adjacency().sum(axis=1)

    def metropolis_weights(self) -> np.ndarray:
        """Metropolis-Hastings mixing matrix: ``W[i, j] = 1/(1 + max(d_i, d_j))``
        for edges, diagonal making rows sum to 1.  Doubly stochastic and
        convergent on any connected graph."""
        d = self.degrees()
        W = np.zeros((self.n_agents, self.n_agents))
        for (u, v) in self.edges:
            w = 1.0 / (1.0 + max(d[u], d[v]))
            W[u, v] = W[v, u] = w
        np.fill_diagonal(W, 1.0 - W.sum(axis=1))
        return W


def gamma(W: np.ndarray) -> float:
    """Convergence factor of a mixing matrix: ``gamma = ||W - 11^T/n||_2``,
    the per-round contraction rate of the disagreement vector (``gamma < 1``
    iff repeated mixing converges to the average)."""
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    M = W - np.ones((n, n)) / n
    return float(np.linalg.norm(M, ord=2))
