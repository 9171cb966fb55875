"""Consensus (gossip) engine, dense route (port of
``distributed_learning_tpu/parallel/consensus.py``).

All N agents' replicas live on one device as a leading axis and one
round is one float32 ``W @ X`` GEMM per dtype bucket of the fused
``{dtype: (N, P)}`` layout.  ``mix_`` / ``mix_until_`` run in place on
fused buffers (the trainer's parameter buffer); ``mix`` / ``mix_until``
take any stacked dict, ravel it into fresh fused buffers once per call
and return the mixed state in the caller's layout.  The sharded
``torch.distributed`` route, Chebyshev, traced-W and async programs of
the reference are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.schedule import validate_mixing_matrix
from distributed_learning_tpu_torch.parallel.topology import gamma as exact_gamma

__all__ = ["ConsensusEngine"]

Stacked = Dict[str, torch.Tensor]


class ConsensusEngine:
    """Executes gossip rounds on stacked per-agent state.

    ``W`` is the (n, n) symmetric row-stochastic mixing matrix; the state
    passed to each method is a ``{name: (n, ...)}`` dict on ``device``.
    """

    def __init__(self, W: np.ndarray, *, device="cpu"):
        self.W = validate_mixing_matrix(W)
        self.n = self.W.shape[0]
        self.gamma = exact_gamma(self.W)
        self._W_dev = torch.as_tensor(self.W, dtype=torch.float32, device=device)

    def _rounds(self, buffers: Stacked, more: Callable[[int, Stacked], bool]) -> int:
        """Gossip rounds in place on ``buffers`` while ``more(rounds done,
        current state)``; returns the rounds run.  Rounds ping-pong
        between the buffers and a spare set of their shape, so a round
        only writes its GEMM's output; one copy brings the state home
        when the last round landed in the spare.  The spare comes from
        the caching allocator at the call, when the training step's
        activations are free."""
        cur, spare = buffers, {k: torch.empty_like(x) for k, x in buffers.items()}
        t = 0
        while more(t, cur):
            cur, spare = ops.dense_mix(cur, self._W_dev, out=spare), cur
            t += 1
        if cur is not buffers:
            for key, x in cur.items():
                buffers[key].copy_(x)
        return t

    def mix_(self, buffers: Stacked, times: int = 1) -> None:
        """Run exactly ``times`` gossip rounds in place on fused buffers."""
        self._rounds(buffers, lambda t, _: t < times)

    def mix_until_(
        self,
        buffers: Stacked,
        *,
        eps: float,
        min_times: int = 0,
        max_rounds: int = 10_000,
    ) -> Tuple[int, float]:
        """Gossip in place until ``max_deviation < eps`` (and at least
        ``min_times`` rounds); returns ``(rounds_done, final_residual)``.

        The reference runs this as a device ``while_loop``; eagerly the
        stopping test reads the residual back once per round, which exact
        stopping needs.
        """
        res = 0.0

        def more(t, state):
            nonlocal res
            res = float(ops.max_deviation(state))
            return t < min_times or (res >= eps and t < max_rounds)

        return self._rounds(buffers, more), res

    def mix(self, stacked: Stacked, times: int = 1) -> Stacked:
        """Run exactly ``times`` gossip rounds; ``stacked`` is left as it was."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.mix_(buffers, times)
        return ops.unflatten_stacked(buffers, layout)

    def mix_until(
        self,
        stacked: Stacked,
        *,
        eps: float,
        min_times: int = 0,
        max_rounds: int = 10_000,
    ) -> Tuple[Stacked, int, float]:
        """:meth:`mix_until_` on a copy: ``(state, rounds_done, residual)``."""
        buffers, layout = ops.flatten_stacked(stacked)
        t, res = self.mix_until_(buffers, eps=eps, min_times=min_times, max_rounds=max_rounds)
        return ops.unflatten_stacked(buffers, layout), t, res

    def deviations(self, stacked: Stacked) -> torch.Tensor:
        """(n,) per-agent L2 distance from the mean parameter vector."""
        return ops.agent_deviations(stacked)

    def max_deviation(self, stacked: Stacked) -> torch.Tensor:
        return ops.max_deviation(stacked)
