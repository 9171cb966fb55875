"""Consensus (gossip) engine, dense route (port of
``distributed_learning_tpu/parallel/consensus.py``).

All N agents' replicas live on one device as a leading axis and one
round is one float32 ``W @ X`` GEMM per dtype bucket of the fused
``{dtype: (N, P)}`` layout.  The ``*_`` methods run in place on fused
buffers (the trainer's parameter buffer): plain rounds (``mix_``), rounds
against a per-call matrix (``mix_with_``, the time-varying graphs of a
``topology_schedule``), eps-stopping (``mix_until_``,
``mix_until_with_``), Chebyshev-accelerated rounds (``mix_chebyshev_``)
and exact averaging (``global_average_``, the Gossip-PGA epoch).
``mix`` / ``mix_until`` take any stacked dict, ravel it into fresh fused
buffers once per call and return the mixed state in the caller's layout.

The fixed-count forms read nothing back to the host.  Given their spare
buffers (:meth:`ConsensusEngine.spare_for`, drawn once) and their
matrices and Chebyshev weights as device tensors, they allocate nothing
either, so a CUDA graph can capture them (``training/graphs.py``), with
:meth:`ConsensusEngine.max_deviation_` writing the residual into a device
scalar.  The
eps-stopping forms read the residual back once per round, which exact
stopping needs.  The sharded ``torch.distributed`` route and the async
programs of the reference are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.schedule import (
    chebyshev_omegas,
    validate_mixing_matrix,
)
from distributed_learning_tpu_torch.parallel.topology import gamma as exact_gamma

__all__ = ["ConsensusEngine"]

Stacked = Dict[str, torch.Tensor]
Spare = Sequence[Stacked]


def _cheby_step(wx: torch.Tensor, prev: torch.Tensor, omega: torch.Tensor) -> None:
    """``wx <- omega (wx - prev) + prev`` in place, in float32 whatever
    the storage dtype (the reference's order of operations)."""
    if wx.dtype == torch.float32:
        wx.sub_(prev).mul_(omega).add_(prev)
        return
    p = prev.to(torch.float32)
    wx.copy_((wx.to(torch.float32) - p) * omega + p)


class ConsensusEngine:
    """Executes gossip rounds on stacked per-agent state.

    ``W`` is the (n, n) symmetric row-stochastic mixing matrix; the state
    passed to each method is a ``{name: (n, ...)}`` dict on ``device``.
    """

    def __init__(self, W: np.ndarray, *, device="cpu"):
        self.W = validate_mixing_matrix(W)
        self.n = self.W.shape[0]
        self.gamma = exact_gamma(self.W)
        self.device = torch.device(device)
        self._W_dev = torch.as_tensor(self.W, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #
    def spare_for(self, buffers: Stacked, sets: int = 2) -> Tuple[Stacked, ...]:
        """``sets`` fresh buffer sets of ``buffers``' keys, shapes and
        dtypes: the ping-pong targets of the rounds (plain rounds use one,
        Chebyshev two).  Passing them to the in-place methods makes those
        allocate nothing."""
        return tuple({k: torch.empty_like(x) for k, x in buffers.items()}
                     for _ in range(sets))

    def _matrix(self, W=None) -> torch.Tensor:
        """The float32 (n, n) device matrix a round contracts with: the
        engine's own for ``None``, a device tensor as given, an array
        copied to the device."""
        if W is None:
            return self._W_dev
        shape = tuple(W.shape) if isinstance(W, torch.Tensor) else np.shape(W)
        if shape != (self.n, self.n):
            raise ValueError(f"W must have shape ({self.n}, {self.n}), got {shape}")
        if isinstance(W, torch.Tensor):
            return W.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(W, dtype=np.float32), device=self.device)

    def _rounds(self, buffers: Stacked, more: Callable[[int, Stacked], bool],
                W: torch.Tensor, spare: Optional[Spare]) -> int:
        """Gossip rounds in place on ``buffers`` while ``more(rounds done,
        current state)``; returns the rounds run.  Rounds ping-pong
        between the buffers and a spare set of their shape, so a round
        only writes its GEMM's output; one copy brings the state home
        when the last round landed in the spare.  Without ``spare`` the
        spare set comes from the caching allocator at the call, when the
        training step's activations are free."""
        cur = buffers
        other = spare[0] if spare is not None else self.spare_for(buffers, 1)[0]
        t = 0
        while more(t, cur):
            cur, other = ops.dense_mix(cur, W, out=other), cur
            t += 1
        if cur is not buffers:
            for key, x in cur.items():
                buffers[key].copy_(x)
        return t

    # -- fixed round counts: no host reads ----------------------------- #
    def mix_(self, buffers: Stacked, times: int = 1, *, spare: Optional[Spare] = None) -> None:
        """Run exactly ``times`` gossip rounds in place on fused buffers."""
        self._rounds(buffers, lambda t, _: t < times, self._W_dev, spare)

    def mix_with_(self, buffers: Stacked, W, times: int = 1, *,
                  spare: Optional[Spare] = None) -> None:
        """``times`` rounds in place against the per-call matrix ``W``
        (the reference's traced-W ``mix_with``: a time-varying graph
        costs an (n, n) copy, nothing more)."""
        self._rounds(buffers, lambda t, _: t < times, self._matrix(W), spare)

    def mix_chebyshev_(self, buffers: Stacked, times: Optional[int] = None, *, W=None,
                       omegas=None, spare: Optional[Spare] = None) -> None:
        """Chebyshev-accelerated gossip in place:
        ``x_{k+1} = omega_{k+1} (W x_k - x_{k-1}) + x_{k-1}``, the first
        round plain.  ``omegas`` (one per round; a device tensor keeps
        the call free of host copies) default to
        ``chebyshev_omegas(self.gamma, times)`` for the engine's own
        ``W``; with another ``W`` pass that graph's."""
        if omegas is None:
            if W is not None:
                raise ValueError("a per-call W needs its own omegas (chebyshev_omegas of its gamma)")
            omegas = chebyshev_omegas(self.gamma, int(times))
        if not isinstance(omegas, torch.Tensor):
            omegas = torch.as_tensor(np.asarray(omegas, dtype=np.float32), device=self.device)
        k = omegas.shape[0]
        if times is not None and int(times) != k:
            raise ValueError(f"{k} omegas for {times} rounds")
        if k == 0:
            return
        Wd = self._matrix(W)
        one, two = spare if spare is not None else self.spare_for(buffers, 2)
        prev, cur, free = buffers, ops.dense_mix(buffers, Wd, out=one), two
        for r in range(1, k):
            nxt = ops.dense_mix(cur, Wd, out=free)
            for key, x in nxt.items():
                _cheby_step(x, prev[key], omegas[r])
            prev, cur, free = cur, nxt, prev
        if cur is not buffers:
            for key, x in cur.items():
                buffers[key].copy_(x)

    def global_average_(self, buffers: Stacked) -> None:
        """Exact averaging in place: every agent gets the float32 mean
        over agents (the Gossip-PGA epoch, ``gamma = 0``)."""
        ops.global_average(buffers, out=buffers)

    # -- eps-stopping: one residual read per round ---------------------- #
    def _until(self, buffers, W, eps, min_times, max_rounds, spare) -> Tuple[int, float]:
        res = 0.0

        def more(t, state):
            nonlocal res
            res = float(ops.max_deviation(state))
            return t < min_times or (res >= eps and t < max_rounds)

        return self._rounds(buffers, more, W, spare), res

    def mix_until_(
        self,
        buffers: Stacked,
        *,
        eps: float,
        min_times: int = 0,
        max_rounds: int = 10_000,
        spare: Optional[Spare] = None,
    ) -> Tuple[int, float]:
        """Gossip in place until ``max_deviation < eps`` (and at least
        ``min_times`` rounds); returns ``(rounds_done, final_residual)``.

        The reference runs this as a device ``while_loop``; eagerly the
        stopping test reads the residual back once per round, which exact
        stopping needs.
        """
        return self._until(buffers, self._W_dev, eps, min_times, max_rounds, spare)

    def mix_until_with_(
        self,
        buffers: Stacked,
        W,
        *,
        eps: float,
        min_times: int = 0,
        max_rounds: int = 10_000,
        spare: Optional[Spare] = None,
    ) -> Tuple[int, float]:
        """:meth:`mix_until_` against the per-call matrix ``W``."""
        return self._until(buffers, self._matrix(W), eps, min_times, max_rounds, spare)

    # -- copies ---------------------------------------------------------- #
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

    def max_deviation_(self, stacked: Stacked, out: torch.Tensor) -> None:
        """The residual written into the 0-dim device tensor ``out``, with
        no host read: what a captured gossip program reports."""
        out.copy_(ops.max_deviation(stacked))
