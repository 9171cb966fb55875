"""Push-sum (weighted gossip) consensus on *directed* graphs, dense route
(port of ``distributed_learning_tpu/parallel/pushsum.py``).

Push-sum (Kempe-Dobra-Gehrke; the consensus core of Stochastic Gradient
Push) needs only a **column-stochastic** matrix on a strongly connected
digraph: each agent carries a (numerator, weight) pair,

    x_{t+1} = P x_t        w_{t+1} = P w_t        estimate = x_t / w_t,

column-stochasticity preserves the totals ``sum(x)`` and ``sum(w)``, and
the ratio converges to ``sum(x_0) / sum(w_0)`` on every agent.

``P`` is neither symmetric nor row-stochastic, so the engine does not
mix through :class:`~.consensus.ConsensusEngine` (which validates a
symmetric ``W``): it checks ``P`` itself and runs each round as one
float32 ``P @ X`` GEMM per tensor (:func:`ops.dense_mix`) plus the
(n,)-vector of weights.  With ``mesh=`` (one agent a rank) each rank
holds its agent as a stack of one and a round relays the numerator
buckets and the weight together over the agent ring
(:func:`~.consensus.local_ring_mix` on ``P``'s ring decomposition; a
direction with no weight anywhere is skipped).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.consensus import (
    local_ring_mix,
    local_sq_deviation,
    ring_offset_weights,
)

__all__ = ["PushSumEngine", "push_sum_matrix"]

Stacked = Dict[str, torch.Tensor]


def _lift(num: Stacked, w: torch.Tensor) -> Stacked:
    """Numerator initialization ``x_i * w_i`` in float32, stored in each
    tensor's dtype (not the mean-normalized :func:`ops.weighted_lift`: the
    ratio readout cancels any common scale)."""
    return {k: (v.float() * w.reshape((-1,) + (1,) * (v.dim() - 1))).to(v.dtype)
            for k, v in num.items()}


def _readout(num: Stacked, den: torch.Tensor) -> Stacked:
    """De-biased estimates ``x / w`` in float32, stored in each tensor's
    dtype."""
    return {k: (v.float() / den.reshape((-1,) + (1,) * (v.dim() - 1)).float()).to(v.dtype)
            for k, v in num.items()}


def push_sum_matrix(out_neighbors, n: Optional[int] = None) -> np.ndarray:
    """Column-stochastic mixing matrix from a directed graph.

    ``out_neighbors`` is either ``{i: [j, ...]}`` (i sends to j) or an edge
    list of ``(i, j)`` pairs meaning ``i -> j``.  Every node splits its
    mass uniformly over its out-neighbors plus itself:
    ``P[j, i] = 1 / (outdeg(i) + 1)`` for each receiver ``j``.
    """
    if not isinstance(out_neighbors, Mapping):
        edges = list(out_neighbors)
        nodes = {u for e in edges for u in e}
        n = n or (max(nodes) + 1 if nodes else 0)
        adj: dict = {i: [] for i in range(n)}
        for u, v in edges:
            adj[int(u)].append(int(v))
        out_neighbors = adj
    else:
        # Receivers count too: a node may appear only in a value list.
        nodes = set(out_neighbors) | {j for outs in out_neighbors.values() for j in outs}
        n = n or (max(nodes) + 1 if nodes else 0)
    P_ = np.zeros((n, n), np.float64)
    for i in range(n):
        outs = [j for j in out_neighbors.get(i, []) if j != i]
        share = 1.0 / (len(outs) + 1)
        P_[i, i] = share
        for j in outs:
            P_[j, i] += share
    return P_


class PushSumEngine:
    """Push-sum rounds on agent-stacked state, dense or sharded.

    ``P_matrix``: (n, n) column-stochastic matrix (columns sum to 1,
    entries >= 0) of a strongly connected digraph.  The state is an
    ``(n, ...)`` tensor or a ``{name: (n, ...)}`` dict on ``device`` (the
    card unless ``device="cpu"``); with ``mesh`` (an ``AgentMesh`` of n
    ranks) this rank's agent as a stack of one (:meth:`shard`), the
    ``weights`` of :meth:`mix` still the (n,) vector of every agent.
    """

    def __init__(self, P_matrix: np.ndarray, *, mesh=None, device=None):
        P_ = np.asarray(P_matrix, dtype=np.float64)
        if P_.ndim != 2 or P_.shape[0] != P_.shape[1]:
            raise ValueError(f"P must be square, got {P_.shape}")
        if (P_ < -1e-12).any():
            raise ValueError("P must be nonnegative")
        cols = P_.sum(axis=0)
        if not np.allclose(cols, 1.0, atol=1e-8):
            raise ValueError(f"P must be column-stochastic; column sums {cols}")
        self.P = P_
        self.n = P_.shape[0]
        self.mesh = mesh
        if mesh is not None:
            if mesh.size != self.n:
                raise ValueError(f"mesh axis {mesh.axis_name!r} has size {mesh.size}, "
                                 f"need {self.n}")
            device = mesh.device
            # This rank's ring weights; the live directions are decided on
            # every agent's weights, so every rank posts the same exchanges.
            sw, wf, wb, self._k_hops = ring_offset_weights(P_.astype(np.float32))
            a = mesh.agent
            self._ring = (float(sw[a]), wf[a], wb[a])
            self._use = (bool(wf.any()), bool(wb.any()))
        self.device = resolve_device(device)
        self._P_dev = torch.as_tensor(P_, dtype=torch.float32, device=self.device)

    def shard(self, stacked):
        """This rank's agent of a stacked state (a stack of one); without a
        mesh the state on the device."""
        if self.mesh is None:
            return stacked.to(self.device) if isinstance(stacked, torch.Tensor) else {
                k: v.to(self.device) for k, v in stacked.items()}
        a = self.mesh.agent

        def one(v):
            return torch.as_tensor(v)[a:a + 1].to(self.device, copy=True).contiguous()

        return one(stacked) if isinstance(stacked, torch.Tensor) else {
            k: one(v) for k, v in stacked.items()}

    # ------------------------------------------------------------------ #
    def _weights_vec(self, weights) -> torch.Tensor:
        if weights is None:
            return torch.ones(self.n, dtype=torch.float32, device=self.device)
        w = np.asarray(weights.cpu() if isinstance(weights, torch.Tensor) else weights,
                       np.float32)
        if w.shape != (self.n,):
            raise ValueError(f"weights must have shape ({self.n},), got {w.shape}")
        if not (np.isfinite(w).all() and (w > 0.0).all()):
            # A zero weight makes that agent's round-0 estimate x/0 and
            # poisons the residual (NaN never satisfies `res >= eps`).
            raise ValueError(f"agent weights must be finite and > 0, got {w.tolist()}")
        return torch.as_tensor(w, device=self.device)

    def lift(self, stacked, weights=None) -> Tuple[Stacked, torch.Tensor]:
        """The push-sum pair of ``stacked``: fused numerator buffers
        ``x_i w_i`` and the (n,) weights (ones for ``weights=None``; on a
        mesh this rank's (1,) entry)."""
        w0 = self._weights_vec(weights)
        if self.mesh is not None:
            w0 = w0[self.mesh.agent:self.mesh.agent + 1].clone()
        buffers, _ = ops.flatten_stacked(self._as_dict(stacked))
        return _lift(buffers, w0), w0

    def rounds_(self, num: Stacked, den: torch.Tensor, times: int,
                spare: Optional[Stacked] = None) -> torch.Tensor:
        """``times`` push-sum rounds in place on the numerator buffers
        ``num``; returns the mixed weights (a new (n,) tensor).  Rounds
        ping-pong between ``num`` and a spare set (``spare`` or fresh),
        with one copy home after an odd count; no host reads."""
        if self.mesh is not None:
            # The weight rides with the numerator buckets, one message more a hop.
            sw, wf, wb = self._ring
            for _ in range(int(times)):
                mixed = local_ring_mix({**num, "__den__": den}, sw, wf, wb, self._k_hops,
                                       mesh=self.mesh, use_fwd=self._use[0],
                                       use_bwd=self._use[1])
                den = mixed.pop("__den__")
                for k, v in mixed.items():
                    num[k].copy_(v)
            return den
        cur = num
        other = spare if spare is not None else {k: torch.empty_like(v) for k, v in num.items()}
        for _ in range(int(times)):
            cur, other = ops.dense_mix(cur, self._P_dev, out=other), cur
            den = self._P_dev @ den
        if cur is not num:
            for k, v in cur.items():
                num[k].copy_(v)
        return den

    @staticmethod
    def _as_dict(stacked) -> Stacked:
        return stacked if isinstance(stacked, dict) else {"": stacked}

    def _finish(self, stacked, num: Stacked, den: torch.Tensor):
        layout = ops.fused_layout(self._as_dict(stacked))
        est = ops.unflatten_stacked(_readout(num, den), layout)
        return est if isinstance(stacked, dict) else est[""]

    def mix(self, stacked, times: int = 1, *, weights=None):
        """``times`` push-sum rounds; returns the de-biased estimates
        ``x_t / w_t`` (every agent's estimate of the weighted average).
        ``weights``: optional (n,) per-agent contribution weights (sample
        counts); ``None`` means the plain average."""
        num, den = self.lift(stacked, weights)
        den = self.rounds_(num, den, times)
        return self._finish(stacked, num, den)

    def mix_until(self, stacked, *, eps: float, max_rounds: int = 10_000,
                  weights=None) -> Tuple[object, int, float]:
        """Push-sum until the estimates' max deviation from their mean
        drops below ``eps``; returns ``(estimates, rounds, residual)``.
        The stopping test reads the residual back once per round (the
        reference runs it as a device ``while_loop``)."""
        num, den = self.lift(stacked, weights)
        spare = {k: torch.empty_like(v) for k, v in num.items()}
        t = 0
        res = float(self._residual(_readout(num, den)))
        while res >= eps and t < max_rounds:
            den = self.rounds_(num, den, 1, spare)
            t += 1
            res = float(self._residual(_readout(num, den)))
        return self._finish(stacked, num, den), t, res

    def _residual(self, est: Stacked) -> torch.Tensor:
        """The estimates' max deviation from their mean (on a mesh the
        ``all_reduce(MAX)`` of every rank's)."""
        if self.mesh is None:
            return ops.max_deviation(est)
        dev = torch.sqrt(local_sq_deviation(est, self.mesh)).reshape(1)
        return self.mesh.all_reduce(dev, "max")[0]
