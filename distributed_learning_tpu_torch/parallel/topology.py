"""Graph topology and spectral analytics for gossip consensus.

Port of ``distributed_learning_tpu/parallel/topology.py``: a host-side
numpy module, which the port keeps its own copy of rather than importing
the JAX package.  Every constructor draws from the same
``np.random.default_rng(seed)`` streams in the same order, so for every
seed the edges (and hence the weights and gamma of any matrix built from
them) are the reference's to the bit.

Conventions
-----------
* Agents are arbitrary hashable *tokens*, indexed ``0..n-1`` in
  first-seen order of the edge list.
* ``edges`` are undirected, stored canonically as ``(min(u, v), max(u, v))``
  index pairs with duplicates and self-loops removed.
* A *mixing matrix* ``W`` is the symmetric, row-stochastic (hence doubly
  stochastic) matrix applied per gossip round: ``x <- W @ x``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "Topology",
    "gamma",
    "spectral_gap",
    "is_connected",
]


def _canonical_edges(
    edges: Iterable[Tuple[Hashable, Hashable]],
) -> Tuple[Dict[Hashable, int], List[Tuple[int, int]]]:
    """Index tokens in first-seen order and canonicalize the edge list
    (the SDP front end of ``fast_averaging.py`` indexes vertices the same
    way, so per-edge weight vectors line up)."""
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

    # ------------------------------------------------------------------ #
    # Constructors                                                       #
    # ------------------------------------------------------------------ #
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
        """Build from the reference's ``{agent: {neighbor: weight}}`` format.

        This is the topology format of ``consensus_simple.Mixer`` and the
        documented ``MasterNode(weights=...)`` argument
        (``Man_Colab.ipynb`` cell 14/21).  Returns ``(topology, W)`` where
        ``W[i, j]`` is the mixing weight of agent *i* for neighbor *j*
        (including the self-weight on the diagonal).
        """
        tokens = list(topology.keys())
        index = {t: i for i, t in enumerate(tokens)}
        # Neighbor tokens that never appear as top-level keys (legal in the
        # reference's loosely-specified dict format) get indices after keys.
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

    # -- standard graph families --------------------------------------- #
    @staticmethod
    def ring(n: int) -> "Topology":
        if n < 2:
            raise ValueError("ring needs n >= 2")
        return Topology.from_edges([(i, (i + 1) % n) for i in range(n)])

    @staticmethod
    def chain(n: int) -> "Topology":
        return Topology.from_edges([(i, i + 1) for i in range(n - 1)])

    @staticmethod
    def complete(n: int) -> "Topology":
        return Topology.from_edges([(i, j) for i in range(n) for j in range(i + 1, n)])

    @staticmethod
    def star(n: int) -> "Topology":
        return Topology.from_edges([(0, i) for i in range(1, n)])

    @staticmethod
    def grid2d(rows: int, cols: int) -> "Topology":
        """Non-periodic 2-D grid (the '5-node grid' of the Titanic notebook
        is the 2x2 grid plus center; use ``from_edges`` for irregular ones)."""
        edges = []
        for r in range(rows):
            for c in range(cols):
                if c + 1 < cols:
                    edges.append((r * cols + c, r * cols + c + 1))
                if r + 1 < rows:
                    edges.append((r * cols + c, (r + 1) * cols + c))
        return Topology.from_edges(edges)

    @staticmethod
    def torus2d(rows: int, cols: int) -> "Topology":
        """Periodic 2-D grid (every agent has four neighbours)."""
        edges = []
        for r in range(rows):
            for c in range(cols):
                edges.append((r * cols + c, r * cols + (c + 1) % cols))
                edges.append((r * cols + c, ((r + 1) % rows) * cols + c))
        return Topology.from_edges(edges)

    @staticmethod
    def hypercube(dim: int) -> "Topology":
        n = 1 << dim
        edges = [(i, i ^ (1 << b)) for i in range(n) for b in range(dim)]
        return Topology.from_edges(edges)

    @staticmethod
    def watts_strogatz(n: int, k: int, p: float, seed: int = 0) -> "Topology":
        """Connected small-world graph (parity: ``Fast Averaging.ipynb``
        cell 4 uses ``nx.connected_watts_strogatz_graph(25, 6, 0.7)``)."""
        rng = np.random.default_rng(seed)
        for _ in range(100):
            edges = set()
            for i in range(n):
                for off in range(1, k // 2 + 1):
                    edges.add((i, (i + off) % n))
            edges = list(edges)
            out = []
            present = set(tuple(sorted(e)) for e in edges)
            for (u, v) in edges:
                if rng.random() < p:
                    choices = [
                        w
                        for w in range(n)
                        if w != u and tuple(sorted((u, w))) not in present
                    ]
                    if choices:
                        w = int(rng.choice(choices))
                        present.discard(tuple(sorted((u, v))))
                        present.add(tuple(sorted((u, w))))
                        v = w
                out.append((u, v))
            if is_connected(out, n):
                return Topology.from_edges(out)
        raise RuntimeError("failed to generate a connected Watts-Strogatz graph")

    @staticmethod
    def random_regular(degree: int, n: int, seed: int = 0) -> "Topology":
        """Random d-regular graph via the pairing model (parity:
        ``Fast Averaging.ipynb`` cell 8, ``nx.random_regular_graph(3, 12)``)."""
        if (degree * n) % 2 != 0:
            raise ValueError("degree * n must be even")
        rng = np.random.default_rng(seed)
        for _ in range(1000):
            stubs = np.repeat(np.arange(n), degree)
            rng.shuffle(stubs)
            pairs = stubs.reshape(-1, 2)
            edges = set()
            ok = True
            for (u, v) in pairs:
                u, v = int(u), int(v)
                if u == v or (min(u, v), max(u, v)) in edges:
                    ok = False
                    break
                edges.add((min(u, v), max(u, v)))
            if ok and is_connected(list(edges), n):
                return Topology.from_edges(sorted(edges))
        raise RuntimeError("failed to generate a connected random regular graph")

    @staticmethod
    def erdos_renyi(n: int, p: float, seed: int = 0) -> "Topology":
        """Connected Erdos-Renyi G(n, p) (used for time-varying random-graph
        schedules, BASELINE config 5)."""
        rng = np.random.default_rng(seed)
        for _ in range(1000):
            edges = [
                (i, j)
                for i in range(n)
                for j in range(i + 1, n)
                if rng.random() < p
            ]
            if is_connected(edges, n):
                return Topology.from_edges(edges)
        raise RuntimeError("failed to generate a connected G(n, p) graph")

    # ------------------------------------------------------------------ #
    # Basic structure                                                    #
    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def token_index(self) -> Dict[Hashable, int]:
        return {t: i for i, t in enumerate(self.tokens)}

    def neighbors(self, i: int) -> Tuple[int, ...]:
        out = [v for (u, v) in self.edges if u == i] + [
            u for (u, v) in self.edges if v == i
        ]
        return tuple(sorted(out))

    def neighbor_dict(self) -> Dict[Hashable, Tuple[Hashable, ...]]:
        return {
            t: tuple(self.tokens[j] for j in self.neighbors(i))
            for i, t in enumerate(self.tokens)
        }

    def adjacency(self) -> np.ndarray:
        A = np.zeros((self.n_agents, self.n_agents), dtype=np.float64)
        for (u, v) in self.edges:
            A[u, v] = A[v, u] = 1.0
        return A

    def degrees(self) -> np.ndarray:
        return self.adjacency().sum(axis=1)

    @property
    def max_degree(self) -> int:
        return int(self.degrees().max())

    def incidence(self) -> np.ndarray:
        """Oriented incidence matrix ``A`` with ``A[u, e] = 1, A[v, e] = -1``
        (parity: ``fast_averaging.py:18-22``), so that
        ``L(w) = A @ diag(w) @ A.T``."""
        A = np.zeros((self.n_agents, self.n_edges), dtype=np.float64)
        for e, (u, v) in enumerate(self.edges):
            A[u, e] = 1.0
            A[v, e] = -1.0
        return A

    def laplacian(self) -> np.ndarray:
        return np.diag(self.degrees()) - self.adjacency()

    # ------------------------------------------------------------------ #
    # Spectral analytics (parity: consensus_asyncio.py:59-86)            #
    # ------------------------------------------------------------------ #
    def laplacian_eigenvalues(self) -> np.ndarray:
        return np.sort(np.linalg.eigvalsh(self.laplacian()))

    def algebraic_connectivity(self) -> float:
        """Second-smallest Laplacian eigenvalue (Fiedler value)."""
        if self.n_agents < 2:
            return 0.0
        return float(self.laplacian_eigenvalues()[1])

    def connected(self) -> bool:
        return is_connected(list(self.edges), self.n_agents)

    def uniform_epsilon(self) -> float:
        """The reference's uniform Perron step size ``0.95 / max_degree``
        (parity: ``consensus_asyncio.py:78-86``).  An edgeless topology
        (single agent, or a neighbor dict with only self-weights) mixes with
        the identity, so the step size is 0."""
        if self.n_edges == 0:
            return 0.0
        return 0.95 / self.max_degree

    def perron(self, eps: float | None = None) -> np.ndarray:
        """Perron mixing matrix ``W = I - eps * L`` — the uniform-weight
        gossip matrix used by the asyncio backend's update rule
        ``y <- y (1 - eps * deg) + eps * sum(neighbors)``
        (``consensus_asyncio.py:295``)."""
        if eps is None:
            eps = self.uniform_epsilon()
        return np.eye(self.n_agents) - eps * self.laplacian()

    def metropolis_weights(self) -> np.ndarray:
        """Metropolis-Hastings mixing matrix: ``W[i, j] = 1/(1 + max(d_i, d_j))``
        for edges, diagonal making rows sum to 1.  Doubly stochastic and
        convergent on any connected graph without solving the SDP."""
        d = self.degrees()
        W = np.zeros((self.n_agents, self.n_agents))
        for (u, v) in self.edges:
            w = 1.0 / (1.0 + max(d[u], d[v]))
            W[u, v] = W[v, u] = w
        np.fill_diagonal(W, 1.0 - W.sum(axis=1))
        return W

    def mixing_matrix(self, edge_weights: Sequence[float]) -> np.ndarray:
        """``W = I - A diag(w) A^T`` for per-edge weights ``w`` — how the
        reference turns SDP weights into a mixing operator
        (``fast_averaging.py:23``)."""
        w = np.asarray(edge_weights, dtype=np.float64)
        if w.shape != (self.n_edges,):
            raise ValueError(f"expected {self.n_edges} edge weights, got {w.shape}")
        A = self.incidence()
        return np.eye(self.n_agents) - A @ np.diag(w) @ A.T

    def convergence_speed(self, eps: float | None = None) -> float:
        """Per-round contraction factor of the Perron matrix:
        ``max(|lambda| : lambda != 1)``.

        The reference prints ``abs(sorted_eigs[1])`` (second *smallest*,
        ``consensus_asyncio.py:76``), which understates the rate whenever the
        most negative eigenvalue dominates (e.g. near-bipartite graphs with a
        large step size).  We report the true subdominant spectral radius,
        which equals ``gamma(perron(eps))``.
        """
        return gamma(self.perron(eps))

    def describe(self) -> str:
        """Human-readable spectral summary (parity: the printed block of
        ``consensus_asyncio.py:59-76`` / ``consensus_tcp/master.py:245-260``)."""
        L = self.laplacian()
        L_eig = self.laplacian_eigenvalues()
        P = self.perron()
        P_eig = np.sort(np.linalg.eigvalsh(P))
        lines = [
            f"Topology over {self.n_agents} agents, {self.n_edges} edges",
            f"Laplacian:\n{L}",
            f"Eigenvalues: {L_eig}",
            f"Algebraic connectivity: {self.algebraic_connectivity()}",
            f"Perron matrix (eps={self.uniform_epsilon():.6f}):\n{P}",
            f"Eigenvalues: {P_eig}",
            f"Convergence speed: {self.convergence_speed()}",
        ]
        return "\n".join(lines)


# ---------------------------------------------------------------------- #
# Module-level helpers                                                   #
# ---------------------------------------------------------------------- #
def gamma(W: np.ndarray) -> float:
    """Convergence factor of a mixing matrix: ``gamma = ||W - 11^T/n||_2``.

    Per-round contraction rate of the disagreement vector; the objective the
    reference's SDP minimizes (``fast_averaging.py:25-30``).  ``gamma < 1``
    iff repeated mixing converges to the average.
    """
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    M = W - np.ones((n, n)) / n
    return float(np.linalg.norm(M, ord=2))


def spectral_gap(W: np.ndarray) -> float:
    return 1.0 - gamma(W)


def is_connected(edges: Sequence[Tuple[int, int]], n: int | None = None) -> bool:
    """Union-find connectivity check over integer edge endpoints."""
    if n is None:
        nodes = set()
        for (u, v) in edges:
            nodes.add(u)
            nodes.add(v)
        n = max(nodes) + 1 if nodes else 0
    if n <= 1:
        return True
    parent = list(range(n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (u, v) in edges:
        parent[find(u)] = find(v)
    root = find(0)
    return all(find(i) == root for i in range(n))
