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
stopping needs.

Asynchronous (stale-weighted, double-buffered) gossip models the
straggler-tolerant runtime on one device: agent ``j`` publishes its
parameters every ``periods[j]`` rounds into the carry's ``pub`` buffer,
and its neighbours mix against that publication, decayed by
``1/(1+age)`` and dropped beyond the staleness bound ``tau``
(:meth:`ConsensusEngine.mix_async_`).  The carry
(:class:`AsyncGossipState`) is fixed-address state the rounds update in
place, and the publish test runs on the device, so a captured graph
replays the straggler's cadence.  The Byzantine-robust rounds (clipped,
trimmed-mean, coordinate-median; ``parallel/robust.py``) run through
:meth:`ConsensusEngine.mix_robust_` and
:meth:`ConsensusEngine.mix_async_robust_`.

Also here: randomized pairwise gossip (:meth:`ConsensusEngine.mix_pairwise`,
one edge per round, the literal model), the weighted consensus round
(:meth:`ConsensusEngine.run_round`), :meth:`ConsensusEngine.max_std`, and
:class:`Mixer`, the reference's synchronous mixer surface over per-agent
parameter dicts.  The sharded ``torch.distributed`` route is not ported
yet (ROADMAP.md).

Every mix route carries the reference's obs hooks, host-side only (no
device read): a ``consensus.<route>`` span on the default tracer; the
``consensus.rounds_run`` and ``consensus.bytes_mixed`` counters and the
``consensus.leaf_count`` / ``consensus.fused_buckets`` gauges on the
default registry (``consensus.mix_until.calls``,
``consensus.global_averages`` and ``consensus.robust.rounds`` on their
routes).  The in-place routes take the fused buffers' leaf ``layout``
for the leaf count (one leaf per buffer without it).  Inside a CUDA-graph
capture the hooks count into the capture's record, and each replay adds
that record once (``training/graphs.py``), so a replayed round counts as
an eager one.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.obs.registry import get_registry
from distributed_learning_tpu_torch.obs.spans import get_tracer
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.schedule import (
    chebyshev_omegas,
    validate_mixing_matrix,
)
from distributed_learning_tpu_torch.parallel.topology import Topology
from distributed_learning_tpu_torch.parallel.topology import gamma as exact_gamma

__all__ = ["AsyncGossipState", "ConsensusEngine", "Mixer"]

Stacked = Dict[str, torch.Tensor]
Spare = Sequence[Stacked]
Step = Callable[[Stacked, Stacked], Stacked]


class AsyncGossipState(NamedTuple):
    """The carry of simulated asynchronous gossip (the double-buffer
    model on one device), updated in place by the async rounds.

    ``pub`` is buffer B, the state each agent last *published* (what its
    neighbours mix against), with the live state's keys, shapes and
    dtypes; ``age[j]`` counts rounds since agent ``j`` last published;
    ``rnd`` is the async round counter that drives the publish periods.
    """

    pub: Stacked
    age: torch.Tensor  # (n,) int32
    rnd: torch.Tensor  # () int32


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
    passed to each method is a ``{name: (n, ...)}`` dict on ``device``
    (the card unless ``device="cpu"`` is asked for).
    """

    def __init__(self, W: np.ndarray, *, device=None):
        self.W = validate_mixing_matrix(W)
        self.n = self.W.shape[0]
        self.gamma = exact_gamma(self.W)
        self.device = resolve_device(device)
        self._W_dev = torch.as_tensor(self.W, dtype=torch.float32, device=self.device)
        self._periods_dev: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._edges_dev: Optional[torch.Tensor] = None

    # -- obs hooks (host-side only) -------------------------------------- #
    def _note_layout(self, buffers: Stacked, rounds: Optional[int] = None,
                     layout: Optional[ops.FusedLayout] = None) -> None:
        """Fused-layout accounting: the leaf and bucket gauges and, for a
        known round count, the bytes the rounds touched."""
        if layout is None:  # one leaf per buffer
            layout = ops.fused_layout(buffers)
        reg = get_registry()
        reg.gauge("consensus.leaf_count", layout.leaf_count)
        reg.gauge("consensus.fused_buckets", layout.bucket_count)
        if rounds is not None:
            reg.inc("consensus.bytes_mixed", layout.bytes_per_round(self.n) * int(rounds))

    @staticmethod
    def _count_rounds(times: int) -> None:
        get_registry().inc("consensus.rounds_run", int(times))

    def _hooks(self, route: str, buffers: Stacked, rounds: Optional[int],
               layout: Optional[ops.FusedLayout]):
        """Round and layout accounting for a fixed-count route, then its span."""
        if rounds is not None:
            self._count_rounds(rounds)
        self._note_layout(buffers, rounds, layout)
        return get_tracer().span(f"consensus.{route}")

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

    @staticmethod
    def _plain(W: torch.Tensor) -> Step:
        return lambda x, out: ops.dense_mix(x, W, out=out)

    def _rounds(self, buffers: Stacked, more: Callable[[int, Stacked], bool],
                step: Step, spare: Optional[Spare]) -> int:
        """Gossip rounds ``step(state, out) -> out`` in place on
        ``buffers`` while ``more(rounds done, current state)``; returns
        the rounds run.  Rounds ping-pong between the buffers and a spare
        set of their shape, so a round only writes its output; one copy
        brings the state home when the last round landed in the spare.
        Without ``spare`` the spare set comes from the caching allocator
        at the call, when the training step's activations are free."""
        cur = buffers
        other = spare[0] if spare is not None else self.spare_for(buffers, 1)[0]
        t = 0
        while more(t, cur):
            cur, other = step(cur, other), cur
            t += 1
        if cur is not buffers:
            for key, x in cur.items():
                buffers[key].copy_(x)
        return t

    # -- fixed round counts: no host reads ----------------------------- #
    def mix_(self, buffers: Stacked, times: int = 1, *, spare: Optional[Spare] = None,
             layout: Optional[ops.FusedLayout] = None) -> None:
        """Run exactly ``times`` gossip rounds in place on fused buffers."""
        with self._hooks("mix", buffers, times, layout):
            self._rounds(buffers, lambda t, _: t < times, self._plain(self._W_dev), spare)

    def mix_with_(self, buffers: Stacked, W, times: int = 1, *,
                  spare: Optional[Spare] = None,
                  layout: Optional[ops.FusedLayout] = None) -> None:
        """``times`` rounds in place against the per-call matrix ``W``
        (the reference's traced-W ``mix_with``: a time-varying graph
        costs an (n, n) copy, nothing more); ``W=None`` is the engine's
        own matrix, :meth:`mix_`."""
        with self._hooks("mix" if W is None else "mix_with", buffers, times, layout):
            self._rounds(buffers, lambda t, _: t < times, self._plain(self._matrix(W)), spare)

    def mix_chebyshev_(self, buffers: Stacked, times: Optional[int] = None, *, W=None,
                       omegas=None, spare: Optional[Spare] = None,
                       layout: Optional[ops.FusedLayout] = None) -> None:
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
        with self._hooks("mix_chebyshev" if W is None else "mix_chebyshev_with",
                         buffers, k, layout):
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

    def global_average_(self, buffers: Stacked, *,
                        layout: Optional[ops.FusedLayout] = None) -> None:
        """Exact averaging in place: every agent gets the float32 mean
        over agents (the Gossip-PGA epoch, ``gamma = 0``)."""
        get_registry().inc("consensus.global_averages")
        self._note_layout(buffers, 1, layout)
        with get_tracer().span("consensus.global_average"):
            ops.global_average(buffers, out=buffers)

    # -- eps-stopping: one residual read per round ---------------------- #
    def _until(self, route, buffers, W, eps, min_times, max_rounds, spare,
               layout) -> Tuple[int, float]:
        res = 0.0

        def more(t, state):
            nonlocal res
            res = float(ops.max_deviation(state))
            return t < min_times or (res >= eps and t < max_rounds)

        get_registry().inc("consensus.mix_until.calls")
        with self._hooks(route, buffers, None, layout):
            return self._rounds(buffers, more, self._plain(W), spare), res

    def mix_until_(
        self,
        buffers: Stacked,
        *,
        eps: float,
        min_times: int = 0,
        max_rounds: int = 10_000,
        spare: Optional[Spare] = None,
        layout: Optional[ops.FusedLayout] = None,
    ) -> Tuple[int, float]:
        """Gossip in place until ``max_deviation < eps`` (and at least
        ``min_times`` rounds); returns ``(rounds_done, final_residual)``.

        The reference runs this as a device ``while_loop``; eagerly the
        stopping test reads the residual back once per round, which exact
        stopping needs.  Like the reference's, it counts a call
        (``consensus.mix_until.calls``), not rounds: its caller knows them.
        """
        return self._until("mix_until", buffers, self._W_dev, eps, min_times, max_rounds,
                           spare, layout)

    def mix_until_with_(
        self,
        buffers: Stacked,
        W,
        *,
        eps: float,
        min_times: int = 0,
        max_rounds: int = 10_000,
        spare: Optional[Spare] = None,
        layout: Optional[ops.FusedLayout] = None,
    ) -> Tuple[int, float]:
        """:meth:`mix_until_` against the per-call matrix ``W``."""
        return self._until("mix_until" if W is None else "mix_until_with", buffers,
                           self._matrix(W), eps, min_times, max_rounds, spare, layout)

    # -- asynchronous (stale-weighted) gossip ----------------------------- #
    def _normalize_periods(self, periods) -> Tuple[int, ...]:
        """Per-agent publish periods: agent ``j`` publishes every
        ``periods[j]``-th async round (1 = every round; a ``k``-slow
        straggler has ``periods[j] = k``)."""
        if np.isscalar(periods):
            periods = (int(periods),) * self.n
        periods = tuple(int(p) for p in periods)
        if len(periods) != self.n:
            raise ValueError(f"periods must have length {self.n}, got {len(periods)}")
        if any(p < 1 for p in periods):
            raise ValueError(f"publish periods must be >= 1, got {periods}")
        return periods

    def _periods_tensor(self, periods) -> torch.Tensor:
        """The periods as an (n,) int32 device tensor, copied to the
        device once per distinct value (a warm-up makes it before a
        capture, which must not copy from the host)."""
        key = self._normalize_periods(periods)
        if key not in self._periods_dev:
            self._periods_dev[key] = torch.tensor(key, dtype=torch.int32, device=self.device)
        return self._periods_dev[key]

    def init_async_state(self, stacked: Stacked) -> AsyncGossipState:
        """Fresh carry: ``pub`` a copy of ``stacked``, ages and round 0.
        Round 0 publishes every agent (0 is a multiple of every period),
        so the initial ``pub`` contents never survive a mix: zeros serve
        as well (the trainer's fresh carry)."""
        return AsyncGossipState(
            pub={k: v.detach().clone() for k, v in stacked.items()},
            age=torch.zeros(self.n, dtype=torch.int32, device=self.device),
            rnd=torch.zeros((), dtype=torch.int32, device=self.device))

    @staticmethod
    def _publish_(x: Stacked, state: AsyncGossipState, periods: torch.Tensor) -> None:
        """The start of an async round, on the device: agents whose period
        divides the round copy their live value into ``pub`` and reset
        their age; every other age grows by one."""
        publish = torch.remainder(state.rnd, periods) == 0
        for key, v in x.items():
            pv = state.pub[key]
            torch.where(publish.view((-1,) + (1,) * (v.dim() - 1)), v, pv, out=pv)
        state.age.add_(1).masked_fill_(publish, 0)

    def _async_round_body(self, periods: torch.Tensor):
        """``(x, out, state, tau) -> out``: one async round, publish ->
        age -> stale-weighted mix (:func:`ops.stale_weight_matrix`), the
        round counter advanced.  ``tau`` is an int or a 0-dim device
        tensor."""
        W = self._W_dev

        def round_once(x: Stacked, out: Stacked, state: AsyncGossipState, tau) -> Stacked:
            self._publish_(x, state, periods)
            W_eff = ops.stale_weight_matrix(W, state.age, tau=tau)
            state.rnd.add_(1)
            return ops.stale_weighted_mix(x, state.pub, W_eff, out)

        return round_once

    def mix_async_(self, buffers: Stacked, state: AsyncGossipState, tau, times: int = 1, *,
                   periods, spare: Optional[Spare] = None,
                   layout: Optional[ops.FusedLayout] = None) -> None:
        """``times`` asynchronous (stale-weighted, double-buffered) rounds
        in place on fused buffers, the carry ``state`` (its ``pub`` in the
        buffers' layout) updated in place: the reference's ``mix_async``
        with the carry threaded through.  ``tau`` is the staleness bound,
        an int or a 0-dim int32 device tensor (one captured graph then
        serves every epoch's bound).  ``tau=0`` with every period 1 is
        bitwise :meth:`mix_`.  Reads nothing back to the host."""
        round_once = self._async_round_body(self._periods_tensor(periods))
        with self._hooks("mix_async", buffers, times, layout):
            self._rounds(buffers, lambda t, _: t < times,
                         lambda x, out: round_once(x, out, state, tau), spare)

    # -- Byzantine-robust gossip (parallel/robust.py) --------------------- #
    def mix_robust_(self, buffers: Stacked, spec, times: int = 1, *, mass: torch.Tensor,
                    spare: Optional[Spare] = None,
                    layout: Optional[ops.FusedLayout] = None) -> None:
        """``times`` robust rounds (clipped, trimmed-mean or
        coordinate-median) in place on fused buffers, adding the edge
        weight the defense redirected onto self edges to the 0-dim float32
        device tensor ``mass`` (0.0 at the neutral knobs, where the rounds
        are bitwise :meth:`mix_`)."""
        from distributed_learning_tpu_torch.parallel import robust

        with self._hooks("mix_robust", buffers, times, layout):
            robust.robust_mix_times_program(self, spec)(buffers, times, mass, spare)
        get_registry().inc("consensus.robust.rounds", int(times))

    def mix_async_robust_(self, buffers: Stacked, state: AsyncGossipState, spec, tau,
                          times: int = 1, *, periods, mass: torch.Tensor,
                          spare: Optional[Spare] = None,
                          layout: Optional[ops.FusedLayout] = None) -> None:
        """Robust :meth:`mix_async_`: the robust estimator on top of the
        stale-decayed matrix, each delta measured from the receiver's live
        value to the neighbour's publication; the redirected mass is added
        to ``mass``.  At the neutral knobs bitwise :meth:`mix_async_`."""
        from distributed_learning_tpu_torch.parallel import robust

        with self._hooks("mix_async_robust", buffers, times, layout):
            robust.robust_async_gossip_times_program(self, spec, periods=periods)(
                buffers, state, times, tau, mass, spare)

    # -- copies ---------------------------------------------------------- #
    def mix(self, stacked: Stacked, times: int = 1) -> Stacked:
        """Run exactly ``times`` gossip rounds; ``stacked`` is left as it was."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.mix_(buffers, times, layout=layout)
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
        t, res = self.mix_until_(buffers, eps=eps, min_times=min_times, max_rounds=max_rounds,
                                 layout=layout)
        return ops.unflatten_stacked(buffers, layout), t, res

    def _fused_carry(self, state: Optional[AsyncGossipState], stacked: Stacked,
                     layout) -> AsyncGossipState:
        """A fresh fused copy of a caller-layout carry (``None``: a new one)."""
        if state is None:
            state = self.init_async_state(stacked)
        return AsyncGossipState(ops.flatten_stacked(state.pub, layout)[0],
                                state.age.clone(), state.rnd.clone())

    def mix_async(self, stacked: Stacked, state: Optional[AsyncGossipState] = None, *,
                  tau: int, periods, times: int = 1) -> Tuple[Stacked, AsyncGossipState]:
        """:meth:`mix_async_` on copies: returns ``(mixed, carry)`` in the
        caller's layout; thread the carry into the next call so ages and
        the round counter persist.  ``state=None`` starts a fresh carry."""
        buffers, layout = ops.flatten_stacked(stacked)
        st = self._fused_carry(state, stacked, layout)
        self.mix_async_(buffers, st, tau, times, periods=periods, layout=layout)
        return (ops.unflatten_stacked(buffers, layout),
                AsyncGossipState(ops.unflatten_stacked(st.pub, layout), st.age, st.rnd))

    def mix_robust(self, stacked: Stacked, spec, times: int = 1) -> Tuple[Stacked, torch.Tensor]:
        """:meth:`mix_robust_` on a copy: ``(mixed, mass)``, the mass a
        0-dim device tensor."""
        buffers, layout = ops.flatten_stacked(stacked)
        mass = torch.zeros((), dtype=torch.float32, device=self.device)
        self.mix_robust_(buffers, spec, times, mass=mass, layout=layout)
        return ops.unflatten_stacked(buffers, layout), mass

    def mix_async_robust(self, stacked: Stacked, state: Optional[AsyncGossipState] = None, *,
                         spec, tau: int, periods,
                         times: int = 1) -> Tuple[Stacked, AsyncGossipState, torch.Tensor]:
        """:meth:`mix_async_robust_` on copies: ``(mixed, carry, mass)``."""
        buffers, layout = ops.flatten_stacked(stacked)
        st = self._fused_carry(state, stacked, layout)
        mass = torch.zeros((), dtype=torch.float32, device=self.device)
        self.mix_async_robust_(buffers, st, spec, tau, times, periods=periods, mass=mass,
                               layout=layout)
        return (ops.unflatten_stacked(buffers, layout),
                AsyncGossipState(ops.unflatten_stacked(st.pub, layout), st.age, st.rnd), mass)

    # -- weighted consensus and randomized pairwise gossip ------------- #
    def run_round(self, stacked: Stacked, weights, *, convergence_eps: float = 1e-4,
                  max_rounds: int = 10_000) -> Stacked:
        """Weighted average consensus: every agent contributes its value
        with weight ``w_i`` (e.g. its sample count) and receives the
        weighted average.  Values are lifted to ``x_i w_i / mean(w)``
        (:func:`ops.weighted_lift`), then gossiped until the global
        symmetric residual (the max agent deviation) drops below
        ``convergence_eps``, at least one round.  The reference's
        ``ConsensusAgent.run_round`` stops on a one-sided per-agent check,
        a recorded defect this follows the JAX package in not keeping."""
        w = torch.as_tensor(np.asarray(weights.cpu() if isinstance(weights, torch.Tensor)
                                       else weights, dtype=np.float32), device=self.device)
        if tuple(w.shape) != (self.n,):
            raise ValueError(f"weights must have shape ({self.n},), got {tuple(w.shape)}")
        total = float(w.sum())
        if not np.isfinite(total) or total <= 0.0:
            raise ValueError(f"agent weights must sum to a positive finite value, got {total}")
        mixed, _, _ = self.mix_until(ops.weighted_lift(stacked, w), eps=convergence_eps,
                                     min_times=1, max_rounds=max_rounds)
        return mixed

    def pairwise_edges(self) -> np.ndarray:
        """(E, 2) edges ``i < j`` of W's support in row-major order, an edge
        being a ``|W_ij| > 1e-12`` entry (SDP weights may be negative, and
        round-off must not become a full-strength averaging edge)."""
        return np.argwhere(np.abs(np.triu(self.W, 1)) > 1e-12)

    def mix_pairwise(self, stacked: Stacked, generator: torch.Generator,
                     rounds: int) -> Stacked:
        """``rounds`` of randomized pairwise gossip (Boyd-Ghosh-Prabhakar-
        Shah 2006): each round one edge of the mixing graph is drawn
        uniformly from ``generator`` and its two endpoints average,
        ``x_i, x_j <- (x_i + x_j) / 2``.  The mean is kept exactly every
        round.  The draws are made up front on the generator's device
        (``torch.Generator`` cannot replay the reference's ``jax.random``
        stream; :meth:`mix_pairwise_edges` takes fed draws)."""
        n_edges = len(self.pairwise_edges())
        if n_edges == 0:
            return stacked
        draws = torch.randint(0, n_edges, (int(rounds),), generator=generator,
                              device=generator.device)
        return self.mix_pairwise_edges(stacked, draws)

    def mix_pairwise_edges(self, stacked: Stacked, draws) -> Stacked:
        """Pairwise gossip with the per-round edge indices ``draws`` (into
        :meth:`pairwise_edges`) given: on a copy of ``stacked``."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.pairwise_(buffers, draws, layout=layout)
        return ops.unflatten_stacked(buffers, layout)

    def pairwise_(self, buffers: Stacked, draws, *,
                  layout: Optional[ops.FusedLayout] = None) -> None:
        """The pairwise rounds in place on fused buffers.  The two rows of
        a round are gathered and written back through device index tensors
        (``index_select`` / ``index_copy_``), so no round reads the device
        from the host.  The average is taken in float32 and stored in
        each buffer's dtype."""
        if self._edges_dev is None:
            self._edges_dev = torch.as_tensor(self.pairwise_edges(), dtype=torch.int64,
                                              device=self.device)
        draws = torch.as_tensor(draws, dtype=torch.int64).to(self.device)
        with self._hooks("mix_pairwise", buffers, draws.shape[0], layout):
            pairs = self._edges_dev.index_select(0, draws)
            for r in range(pairs.shape[0]):
                ij = pairs[r]
                for x in buffers.values():
                    rows = x.index_select(0, ij).to(torch.float32)
                    avg = ((rows[0] + rows[1]) * 0.5).to(x.dtype)
                    x.index_copy_(0, ij, avg.expand(2, *avg.shape))

    def deviations(self, stacked: Stacked) -> torch.Tensor:
        """(n,) per-agent L2 distance from the mean parameter vector."""
        return ops.agent_deviations(stacked)

    def max_deviation(self, stacked: Stacked) -> torch.Tensor:
        return ops.max_deviation(stacked)

    def max_std(self, stacked: Stacked) -> torch.Tensor:
        """Max across-agent parameter std (population std), a 0-dim device
        tensor."""
        return ops.max_std(stacked)

    def max_deviation_(self, stacked: Stacked, out: torch.Tensor) -> None:
        """The residual written into the 0-dim device tensor ``out``, with
        no host read: what a captured gossip program reports."""
        out.copy_(ops.max_deviation(stacked))

    def cost_profile(self, stacked: Stacked, *, times: int = 1,
                     name: str = "consensus.mix"):
        """:class:`~distributed_learning_tpu_torch.obs.cost.CostProfile` of
        ``times`` plain rounds on ``stacked``'s shapes, registered
        process-wide under ``name``: the mixing GEMMs' FLOPs.  The rounds
        run once on a copy of ``stacked``, with the hooks muted, so the
        caller's state and counters stay as they were."""
        from distributed_learning_tpu_torch.obs.cost import profile_fn, register_profile
        from distributed_learning_tpu_torch.obs.instrument import muted

        buffers, _ = ops.flatten_stacked(stacked)
        with muted():
            profile = profile_fn(self.mix_, buffers, int(times), name=name, register=False)
        return register_profile(profile)


class Mixer:
    """The reference's synchronous in-process mixer surface
    (``utils/consensus_simple/mixer.py``), device-resident.

    Takes per-agent parameters ``{token: {name: tensor}}`` (or ``{token:
    tensor}``) and the reference's ``{agent: {neighbor: weight}}``
    topology dict, or an (n, n) mixing matrix with ``tokens``; stacks them
    into fused ``(n, P)`` buffers on ``device`` (the card unless
    ``device="cpu"``) and gossips there with a :class:`ConsensusEngine`.
    """

    def __init__(self, params: Mapping[Hashable, object], topology, *,
                 tokens: Optional[Sequence[Hashable]] = None, device=None, logger=None,
                 max_rounds: int = 10_000):
        if isinstance(topology, Mapping):
            topo, W = Topology.from_neighbor_dict(topology)
            self.tokens = topo.tokens
        else:
            W = np.asarray(topology)
            self.tokens = tuple(tokens) if tokens is not None else tuple(range(W.shape[0]))
            if len(self.tokens) != W.shape[0]:
                raise ValueError(f"expected {W.shape[0]} tokens for a {W.shape} mixing "
                                 f"matrix, got {len(self.tokens)}")
        self.engine = ConsensusEngine(W, device=device)
        self.device = self.engine.device
        self._logger = logger
        self._max_rounds = max_rounds
        self.set_parameters(params)

    def mix(self, times: int = 1, eps: Optional[float] = None) -> int:
        """Gossip ``times`` rounds; with ``eps`` keep going until the max
        deviation drops below it (at least ``times`` rounds).  Returns the
        number of rounds run."""
        if len(self.tokens) <= 1:
            return 0
        if self._logger is not None:
            self._logger.debug(f"Mixer start with times= {times}, eps= {eps}")
        if eps is None:
            self.engine.mix_(self._buffers, times)
            done = int(times)
        else:
            done, _ = self.engine.mix_until_(self._buffers, eps=eps, min_times=times,
                                             max_rounds=self._max_rounds)
        if self._logger is not None:
            self._logger.debug(f"Mixer finished with {done} times")
        return done

    def stacked_parameters(self):
        """The stacked state in the callers' structure (views of the fused
        buffers)."""
        stacked = ops.unflatten_stacked(self._buffers, self._layout)
        return stacked[""] if self._bare else stacked

    def parameters(self) -> Dict[Hashable, object]:
        """Current per-agent parameters (views of the fused buffers)."""
        return dict(zip(self.tokens, ops.unstack_tree(self.stacked_parameters(),
                                                      len(self.tokens))))

    def fused_state(self) -> Tuple[Stacked, ops.FusedLayout]:
        """The fused ``(n, P)`` buffers (one per dtype) and their layout:
        what an adapter such as ``interop.TorchModelMixer`` gathers into
        and scatters from."""
        return self._buffers, self._layout

    def set_parameters(self, params: Mapping[Hashable, object]) -> None:
        """Replace the device state from per-agent parameters."""
        missing = [t for t in self.tokens if t not in params]
        if missing:
            raise ValueError(f"params missing for agents: {missing}")
        stacked = ops.stack_trees([params[t] for t in self.tokens])
        self._bare = not isinstance(stacked, dict)
        if self._bare:
            stacked = {"": stacked}
        stacked = {k: v.to(self.device) for k, v in stacked.items()}
        self._buffers, self._layout = ops.flatten_stacked(stacked)

    def get_parameters_deviation(self) -> Dict[Hashable, float]:
        devs = self.engine.deviations(self._buffers).cpu().numpy()
        return {t: float(d) for t, d in zip(self.tokens, devs)}

    def get_max_parameters_std(self) -> float:
        return float(self.engine.max_std(self._buffers))
