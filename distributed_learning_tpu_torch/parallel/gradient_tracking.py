"""Decentralized stochastic gradient tracking (DSGT), dense route (port of
``distributed_learning_tpu/parallel/gradient_tracking.py``).

Under heterogeneous shards and a constant step size, gossip SGD stalls at
a biased consensus point.  Gradient tracking (DIGing / DSGT, Pu & Nedic)
gossips a second variable ``y`` that tracks the network-average gradient:

    x_{t+1} = W (x_t - alpha * y_t)
    y_{t+1} = W y_t + g(x_{t+1}) - g(x_t),        y_0 = g(x_0)

A symmetric row-stochastic ``W`` keeps ``sum_i y_i = sum_i g_i`` at every
step (the tracking invariant, :meth:`GradientTrackingEngine.tracker_sum_gap`),
so once x reaches consensus each agent descends the *global* objective.

Both mixes are float32 ``W @ X`` GEMMs over the stacked agent axis; the
updates are plain PyTorch in the reference's order of operations.  A run
reads nothing back to the host: the step counter is a host int, the
residual trace a device tensor (``parallel/_spmd.py``).  With ``mesh=``
(one agent a rank) each rank holds its agent as a stack of one and both
mixes run the consensus engine's matching exchanges.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple, Union

import numpy as np
import torch

from distributed_learning_tpu_torch.parallel._spmd import (
    Tree,
    agent_sum,
    leaves,
    mix_once,
    per_agent_grads,
    place,
    run_steps,
    tree_map,
)
from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine

__all__ = ["TrackingState", "GradientTrackingEngine"]

Schedule = Union[float, Callable[[int], float]]


class TrackingState(NamedTuple):
    """Stacked DSGT state: parameters, tracker, last gradients, and the
    step counter (a host int)."""

    x: Tree
    y: Tree
    g: Tree
    step: int


def _sub_scaled(x: torch.Tensor, y: torch.Tensor, alpha) -> torch.Tensor:
    """``x - alpha * y`` in float32, stored in ``x``'s dtype.  A number
    ``alpha`` takes the one-rounding ``add(.., alpha=)`` form, as XLA
    contracts the reference's update."""
    if isinstance(alpha, torch.Tensor):
        out = x.float() - alpha * y.float()
    else:
        out = torch.add(x.float(), y.float(), alpha=-float(alpha))
    return out.to(x.dtype)


class GradientTrackingEngine:
    """Runs DSGT over a mixing matrix, dense or sharded.

    Parameters
    ----------
    W:
        (n, n) symmetric row-stochastic mixing matrix (validated by
        :class:`ConsensusEngine`).
    grad_fn:
        The gradient oracle: per agent ``(x_i, agent_idx, step) -> grads``
        (the reference's contract, looped over the agents), or with
        ``stacked_grads=True`` ``(x, step) -> stacked grads``.  The engine
        keeps a copy of what a stacked oracle returns, so the oracle may
        return a buffer it reuses (a model's ``flat_grads``).
    learning_rate:
        Constant float, or ``step -> alpha`` (a number or a 0-dim device
        tensor) called with the host's step counter.
    mesh:
        An :class:`~distributed_learning_tpu_torch.parallel.multihost.AgentMesh`
        of n ranks: the state is then this rank's agent (:meth:`init`
        takes the stacked ``x0`` and keeps its row) and the mixes are the
        consensus engine's matching exchanges.
    device:
        The card unless ``"cpu"`` is asked for (on a mesh, the mesh's).
    """

    def __init__(self, W: np.ndarray, grad_fn: Callable, *, learning_rate: Schedule = 1e-2,
                 stacked_grads: bool = False, mesh=None, device=None):
        self.engine = ConsensusEngine(W, mesh=mesh, device=device)
        self.mesh = mesh
        self.n = self.engine.n
        self.device = self.engine.device
        self.grad_fn = grad_fn
        self.stacked_grads = bool(stacked_grads)
        if callable(learning_rate):
            self._lr = learning_rate
        else:
            lr = float(learning_rate)
            self._lr = lambda step: lr

    def _grads(self, x: Tree, step: int) -> Tree:
        return per_agent_grads(self, self.grad_fn, x, step, stacked=self.stacked_grads)

    def _step(self, s: TrackingState) -> TrackingState:
        alpha = self._lr(s.step)
        descended = tree_map(lambda xv, yv: _sub_scaled(xv, yv, alpha), s.x, s.y)
        x_new = mix_once(self.engine, descended)
        del descended
        g_new = self._grads(x_new, s.step + 1)
        y_mixed = mix_once(self.engine, s.y)
        y_new = tree_map(
            lambda ym, gn, go: ((ym.float() + gn.float()) - go.float()).to(ym.dtype),
            y_mixed, g_new, s.g)
        return TrackingState(x=x_new, y=y_new, g=g_new, step=s.step + 1)

    def init(self, x0: Tree) -> TrackingState:
        """``y_0 = g_0 = grad(x_0)``, the tracking invariant's anchor; the
        state holds copies of ``x0`` on the engine's device (on a mesh of
        this rank's agent of the stacked ``x0``)."""
        x = place(self, x0)
        g0 = self._grads(x, 0)
        return TrackingState(x=x, y=tree_map(torch.clone, g0), g=g0, step=0)

    def run(self, state: TrackingState, steps: int) -> Tuple[TrackingState, torch.Tensor]:
        """``steps`` DSGT iterations; returns the final state and the
        ``(steps,)`` consensus-residual trace of ``x`` (a device tensor).
        ``state`` is left as it was."""
        return run_steps(self, state, steps, self._step)

    def tracker_sum_gap(self, state: TrackingState) -> float:
        """Max-norm of ``sum_i y_i - sum_i g_i``: zero to float32 round-off
        at every step by the tracking invariant (a runtime self-check;
        one host read)."""
        gaps = [(agent_sum(self, y) - agent_sum(self, g)).abs().max()
                for y, g in zip(leaves(state.y), leaves(state.g))]
        return float(torch.stack(gaps).max()) if gaps else 0.0
