"""Fastest-mixing edge weights ("fast averaging") without an external SDP solver.

Port of ``distributed_learning_tpu/parallel/fast_averaging.py``: numpy
only, kept as the port's own copy.  The iteration is the reference's
operation for operation, so weights and gamma equal its results to the
last bits on the same machine.

Reference parity: ``utils/fast_averaging.py:4-32`` solves, with cvxpy,

    minimize    gamma
    subject to  -gamma I  <=  I - L(w) - 11^T/n  <=  gamma I
                L(w) >= 0            (PSD)
    where       L(w) = A diag(w) A^T (graph Laplacian with per-edge weights)

i.e. the Boyd et al. *fastest mixing Markov chain* / fast linear averaging
problem: find per-edge weights minimizing the spectral norm of the
disagreement operator ``W - 11^T/n`` with ``W = I - L(w)``.

cvxpy (and its ECOS/SCS native solvers) is not a dependency, so the same
convex program is solved directly with a smoothed first-order method:

* objective  ``gamma(w) = || I - 11^T/n - L(w) ||_2``  (convex, nonsmooth)
  is smoothed by the soft-max of the absolute eigenvalues,
  ``F_beta(w) = (1/beta) log sum_k [exp(beta l_k) + exp(-beta l_k)]``,
  whose gradient needs only an eigendecomposition of an ``n x n`` symmetric
  matrix (``dl_k/dw_e = -(v_k[i] - v_k[j])^2``);
* the PSD constraint ``L(w) >= 0`` is enforced with an exact-penalty term
  ``rho * sum_k relu(-mu_k(L))`` (subgradient via the eigenvectors of L);
* Adam with an annealed smoothing temperature, tracking the best *exactly
  feasible* iterate, then returning that iterate's true gamma.

Graphs here are tiny (n <= a few hundred) and the solve runs once, at
set-up, so a dense ``eigh`` per step is the right tool.
"""

from __future__ import annotations

from typing import Hashable, Iterable, List, Sequence, Tuple

import numpy as np

from distributed_learning_tpu_torch.parallel.topology import (
    Topology,
    _canonical_edges,
    gamma as exact_gamma,
)

__all__ = ["find_optimal_weights", "solve_fastest_mixing", "FastAveragingResult"]


class FastAveragingResult(tuple):
    """``(weights, gamma)`` tuple with named accessors."""

    __slots__ = ()

    def __new__(cls, weights: np.ndarray, gamma: float):
        return tuple.__new__(cls, (weights, gamma))

    @property
    def weights(self) -> np.ndarray:
        return self[0]

    @property
    def gamma(self) -> float:
        return self[1]


def _spectral_state(B: np.ndarray, w: np.ndarray, n: int):
    """One eigendecomposition serving both M(w) = I - J/n - L(w) and L(w).

    ``B`` is the (E, n) signed incidence (rows b_e = e_u - e_v), so
    ``L = B.T @ diag(w) @ B``.  M and L share an eigenbasis: on the
    all-ones vector both have eigenvalue 0; on its orthogonal complement
    ``lam(M) = 1 - mu(L)``.  So a single ``eigh`` of M yields L's spectrum
    and the penalty eigenvectors for free (halving the per-iteration cost).
    """
    L = (B.T * w) @ B
    M = np.eye(n) - np.ones((n, n)) / n - L
    lam, V = np.linalg.eigh(M)
    ones_k = int(np.argmax(np.abs(V.T @ np.ones(n))))
    mu = 1.0 - lam
    mu[ones_k] = 0.0
    return lam, V, mu


def _solve(
    B: np.ndarray,
    n: int,
    w0: np.ndarray,
    *,
    betas: Sequence[float],
    lrs: Sequence[float],
    iters_per_phase: int,
    rho: float,
    psd_tol: float,
) -> Tuple[np.ndarray, float]:
    w = w0.copy()
    m_adam = np.zeros_like(w)
    v_adam = np.zeros_like(w)
    t = 0
    best_w, best_gamma = w.copy(), np.inf
    PLATEAU_EVERY, PLATEAU_TOL = 40, 1e-6

    n_phases = min(len(betas), len(lrs))
    for phase, (beta, lr) in enumerate(zip(betas, lrs)):
        # The final (sharpest-smoothing) phase polishes the last digits;
        # never cut it short.
        may_cut = phase < n_phases - 1
        gamma_at_check = best_gamma
        for it in range(iters_per_phase):
            t += 1
            lam, V, mu = _spectral_state(B, w, n)

            # Track best exactly-feasible iterate (true, unsmoothed gamma).
            if mu.min() >= -psd_tol:
                g = max(abs(lam[0]), abs(lam[-1]))
                if g < best_gamma:
                    best_gamma, best_w = g, w.copy()

            # Plateau cut: if a phase stops improving the best feasible
            # gamma, move to the next (sharper) smoothing temperature —
            # most graphs converge in a fraction of the nominal budget.
            if may_cut and (it + 1) % PLATEAU_EVERY == 0:
                if gamma_at_check - best_gamma < PLATEAU_TOL:
                    break
                gamma_at_check = best_gamma

            # Smoothed spectral-norm gradient.
            shift = max(abs(lam[0]), abs(lam[-1]))
            a = np.exp(beta * (lam - shift))
            b = np.exp(beta * (-lam - shift))
            p = (a - b) / (a + b).sum()
            DV = B @ V  # (E, n): DV[e, k] = v_k[u_e] - v_k[v_e]
            grad = -(DV**2) @ p

            # PSD exact-penalty subgradient: push negative eigenvalues of L up.
            # d/dw_e [ rho * sum_{mu_k<0} (-mu_k) ] = -rho * sum_k (u_k[u]-u_k[v])^2
            neg = mu < 0.0
            if neg.any():
                DU = B @ V[:, neg]
                grad -= rho * (DU**2).sum(axis=1)

            m_adam = 0.9 * m_adam + 0.1 * grad
            v_adam = 0.999 * v_adam + 0.001 * grad**2
            mhat = m_adam / (1 - 0.9**t)
            vhat = v_adam / (1 - 0.999**t)
            w = w - lr * mhat / (np.sqrt(vhat) + 1e-12)

    # Final exact evaluation of the last iterate too.
    lam, V, mu = _spectral_state(B, w, n)
    if mu.min() >= -psd_tol:
        g = max(abs(lam[0]), abs(lam[-1]))
        if g < best_gamma:
            best_gamma, best_w = g, w.copy()
    return best_w, float(best_gamma)


def find_optimal_weights(
    graph: Iterable[Tuple[Hashable, Hashable]],
    *,
    iters_per_phase: int = 200,
    rho: float = 25.0,
    psd_tol: float = 1e-8,
) -> FastAveragingResult:
    """Drop-in equivalent of the reference ``find_optimal_weights(graph)``.

    Parameters mirror ``fast_averaging.py:4-8``: ``graph`` is a list of token
    pairs; the return value is ``(weights, gamma)`` with one weight per input
    edge (in input order) and ``gamma`` the convergence factor
    ``||I - L(w) - 11^T/n||_2``.

    Golden values (recorded reference outputs, ``Fast Averaging.ipynb``):
      * ``[(0,1),(0,2),(0,3),(1,4),(4,2)]`` -> weights
        ``(1/3, 1/3, 1/2, 1/3, 1/3)``, gamma = 2/3   (cell 2)
      * complete graphs -> W = 11^T/n, gamma = 0
    """
    graph = list(graph)
    # Vertex indexing + unique-edge canonicalization shared with Topology
    # (first-seen order, parity: fast_averaging.py:9-15).
    index, canon = _canonical_edges(graph)
    n = len(index)
    if n < 2:
        raise ValueError("graph must contain at least two distinct vertices")
    E = len(canon)
    if E == 0:
        raise ValueError("graph has no non-self edges")

    # Column (unique edge) each input edge maps to; None for self-loops.
    col = {e: i for i, e in enumerate(canon)}
    col_of_input: List[int | None] = [
        None
        if index[u] == index[v]
        else col[(min(index[u], index[v]), max(index[u], index[v]))]
        for (u, v) in graph
    ]

    B = np.zeros((E, n))
    for e, (iu, iv) in enumerate(canon):
        B[e, iu] = 1.0
        B[e, iv] = -1.0

    # Metropolis initialization: feasible (w >= 0 => L PSD) and already mixing.
    deg = np.zeros(n)
    for (iu, iv) in canon:
        deg[iu] += 1
        deg[iv] += 1
    w0 = np.array([1.0 / (1.0 + max(deg[iu], deg[iv])) for (iu, iv) in canon])

    betas = (60.0, 200.0, 600.0, 2000.0, 8000.0)
    lrs = (0.03, 0.015, 0.006, 0.002, 0.0005)
    w_best, g_best = _solve(
        B,
        n,
        w0,
        betas=betas,
        lrs=lrs,
        iters_per_phase=iters_per_phase,
        rho=rho,
        psd_tol=psd_tol,
    )

    # Map unique-edge weights back onto the input edge list. Duplicate input
    # edges receive the full weight on their first occurrence and 0 after
    # (the reference would split it arbitrarily across duplicate columns).
    seen = set()
    out = np.zeros(len(graph))
    for i, c in enumerate(col_of_input):
        if c is None:
            continue
        if c not in seen:
            out[i] = w_best[c]
            seen.add(c)
    return FastAveragingResult(out, float(g_best))


def solve_fastest_mixing(topology: Topology, **kwargs) -> Tuple[np.ndarray, float]:
    """Solve for a :class:`Topology` and return ``(W, gamma)`` where ``W`` is
    the full ``n x n`` mixing matrix (the form every engine consumes)."""
    weights, g = find_optimal_weights(list(topology.edges), **kwargs)
    W = topology.mixing_matrix(weights)
    # Report the exact gamma of the realized matrix, not the solver estimate.
    return W, exact_gamma(W)
