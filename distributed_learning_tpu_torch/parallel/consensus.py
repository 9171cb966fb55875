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
parameter dicts.

Sharded route (``ConsensusEngine(W, mesh=)``, ``mesh`` a
:class:`~distributed_learning_tpu_torch.parallel.multihost.AgentMesh`):
one agent a rank, each rank holding its agent as a stack of one
(:meth:`ConsensusEngine.shard`).  A round is this rank's self term plus
one exchange per matching of :class:`MatchingSchedule` (a send/recv pair
with the partner; an unmatched rank sends nothing); a per-call matrix
relays over the agent ring with ``k``-hop relays in both directions
(:func:`local_ring_mix`) or gathers every agent and contracts with this
rank's row of ``W`` (``route``, as the reference's ``_route_for``); the
residual is an ``all_reduce(MAX)`` of each rank's deviation from the
all-reduced mean, the exact average one ``all_reduce(SUM)``.  Each
exchange moves the fused ``{dtype: (1, P)}`` buckets, one message a
bucket.  The same in-place and copy methods serve both routes; the
sharded ``consensus.bytes_mixed`` counts the bytes this rank sent.  An
async round on a mesh publishes this rank's copy, gathers every agent's
publication (one ``all_gather`` a bucket) and contracts it with this
rank's row of the stale-decayed matrix; the carry's ``pub`` is this
rank's, its ``age`` and ``rnd`` are replicated.  The robust rounds'
mesh halves are in ``parallel/robust.py``; their redirected mass is
summed across the ranks with one ``all_reduce`` a call.

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

import contextlib
from typing import Callable, Dict, Hashable, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.obs.registry import get_registry
from distributed_learning_tpu_torch.obs.spans import get_tracer
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel.multihost import AgentMesh
from distributed_learning_tpu_torch.parallel.schedule import (
    MatchingSchedule,
    chebyshev_omegas,
    validate_mixing_matrix,
)
from distributed_learning_tpu_torch.parallel.topology import Topology
from distributed_learning_tpu_torch.parallel.topology import gamma as exact_gamma

__all__ = [
    "AsyncGossipState",
    "ConsensusEngine",
    "Mixer",
    "make_agent_mesh",
    "ring_offset_weights",
    "local_ring_mix",
    "local_sq_deviation",
]

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


def make_agent_mesh(n: int, *, device=None, axis_name: str = "agents") -> AgentMesh:
    """The agent mesh of ``n`` agents over the process group, agent ``i``
    on rank ``i`` (the group must have ``n`` ranks: one agent a rank).
    ``device`` is this rank's; ``None`` is the card (and raises without
    one), so a CPU rank asks for ``"cpu"``."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_agent_mesh needs the process group: call "
                           "parallel.multihost.initialize first")
    if dist.get_world_size() != n:
        raise ValueError(f"need {n} ranks for {n} agents, the group has "
                         f"{dist.get_world_size()}")
    return AgentMesh(range(n), resolve_device(device), axis_name=axis_name)


def ring_offset_weights(W: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Decompose a mixing matrix's off-diagonal onto signed ring offsets.

    Returns ``(self_w, w_fwd, w_bwd, k_hops)``: ``w_fwd[i, k-1]`` weights
    agent ``(i-k) % n`` (reached by ``k`` forward relay hops on the agent
    ring) and ``w_bwd[i, k-1]`` weights ``(i+k) % n``; ``k_hops`` is the
    largest offset carrying any weight, the relays a routed round needs.
    For ``n`` even the antipodal offset ``n/2`` is reachable both ways and
    is counted once (forward).  Any square matrix decomposes (directed
    push-sum matrices too).  The reference's numpy, unchanged."""
    W = np.asarray(W)
    n = W.shape[0]
    k_cap = n // 2
    w_fwd = np.zeros((n, max(k_cap, 1)), np.float32)
    w_bwd = np.zeros((n, max(k_cap, 1)), np.float32)
    i = np.arange(n)
    for k in range(1, k_cap + 1):
        w_fwd[:, k - 1] = W[i, (i - k) % n]
        if not (n % 2 == 0 and k == n // 2):
            w_bwd[:, k - 1] = W[i, (i + k) % n]
    k_hops = 0
    for k in range(k_cap, 0, -1):
        if w_fwd[:, k - 1].any() or w_bwd[:, k - 1].any():
            k_hops = k
            break
    return np.diag(W).astype(np.float32), w_fwd, w_bwd, k_hops


def _f32(w) -> float:
    """A weight as the float32 value the reference's arrays hold."""
    return float(np.float32(w))


def _scaled(v: torch.Tensor, w: float) -> torch.Tensor:
    """``v * w`` in float32, stored in ``v``'s dtype (the reference's
    ``scale``)."""
    if v.dtype == torch.float32:
        return v * w
    return (v.float() * w).to(v.dtype)


def local_ring_mix(x: Stacked, self_w: float, w_fwd: Sequence[float], w_bwd: Sequence[float],
                   k_hops: int, *, mesh: AgentMesh, use_fwd: bool = True, use_bwd: bool = True,
                   out: Optional[Stacked] = None) -> Stacked:
    """One gossip round under per-offset weights, routed over the agent
    ring with ``k_hops`` relays: each hop passes the value one step in
    both ring directions (one exchange per hop, a message per bucket and
    direction) and adds that offset's weighted term, in float32 whatever
    the storage dtype, cast back once at the end.  ``self_w`` and the
    ``w_fwd`` / ``w_bwd`` rows are this rank's (:func:`ring_offset_weights`);
    a direction whose weights are zero on every agent (``use_fwd`` /
    ``use_bwd``, the same on every rank) is skipped, so a one-way push-sum
    ring moves ``k_hops`` messages a bucket, not ``2 k_hops``.  Writes
    ``out`` (or fresh tensors) and returns it."""
    n, a = mesh.size, mesh.agent
    nxt, prv = (a + 1) % n, (a - 1) % n
    acc = {k: v.float() * _f32(self_w) for k, v in x.items()}
    fwd, bwd = x, x
    for hop in range(int(k_hops)):
        sends, recvs = [], []
        nf = {k: torch.empty_like(v) for k, v in x.items()} if use_fwd else fwd
        nb = {k: torch.empty_like(v) for k, v in x.items()} if use_bwd else bwd
        if use_fwd:
            sends += [(nxt, fwd[k]) for k in x]
            recvs += [(prv, nf[k]) for k in x]
        if use_bwd:
            sends += [(prv, bwd[k]) for k in x]
            recvs += [(nxt, nb[k]) for k in x]
        mesh.exchange(sends, recvs)
        fwd, bwd = nf, nb
        for k in x:
            if use_fwd:
                acc[k] += fwd[k].float() * _f32(w_fwd[hop])
            if use_bwd:
                acc[k] += bwd[k].float() * _f32(w_bwd[hop])
    if out is None:
        return {k: acc[k].to(v.dtype) for k, v in x.items()}
    for k, v in out.items():
        v.copy_(acc[k])
    return out


def local_sq_deviation(x: Stacked, mesh: AgentMesh) -> torch.Tensor:
    """This rank's squared L2 distance from the agents' mean vector (a
    0-dim float32 tensor): the mean is an ``all_reduce(SUM)`` over the
    agents divided by n, one per bucket."""
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for v in x.values():
        lf = v.float()
        mean = mesh.all_reduce(lf.clone(), "sum") / mesh.size
        d = lf - mean
        total = total + (d * d).sum()
    return total


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
    (the card unless ``device="cpu"`` is asked for).  With ``mesh`` (an
    :class:`AgentMesh` of n ranks) the rounds run sharded, and the state
    is this rank's agent as a ``{name: (1, ...)}`` stack of one
    (:meth:`shard`) on the mesh's device.
    """

    def __init__(self, W: np.ndarray, *, mesh: Optional[AgentMesh] = None, device=None):
        self.W = validate_mixing_matrix(W)
        self.n = self.W.shape[0]
        self.gamma = exact_gamma(self.W)
        self.mesh = mesh
        self.schedule = MatchingSchedule.from_matrix(self.W)
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if mesh.size != self.n:
                raise ValueError(f"mesh axis {mesh.axis_name!r} has size {mesh.size}, need "
                                 f"{self.n} (one rank per agent)")
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            self.device = mesh.device
            a = mesh.agent
            # This rank's weights: its self weight, and per matching its
            # partner (None: unmatched) and the partner's weight.
            self._sw = _f32(self.schedule.self_weights[a])
            self._partners = [next((j if i == a else i for i, j in m if a in (i, j)), None)
                              for m in self.schedule.matchings]
            self._mw = [_f32(self.schedule.weights[r, a]) for r in range(len(self._partners))]
            self._recv: Dict[str, torch.Tensor] = {}
        self._W_dev = torch.as_tensor(self.W, dtype=torch.float32, device=self.device)
        self._periods_dev: Dict[Tuple[int, ...], torch.Tensor] = {}
        self._edges_dev: Optional[torch.Tensor] = None

    # -- the sharded route's building blocks ----------------------------- #
    def shard(self, stacked):
        """This rank's agent of a stacked ``(n, ...)`` tensor or dict, as a
        stack of one on the engine's device (a copy); without a mesh the
        state on the device."""
        def one(v):
            v = torch.as_tensor(v)
            if self.mesh is None:
                return v.to(self.device)
            if v.shape[0] != self.n:
                raise ValueError(f"shard takes the stacked (n={self.n}, ...) state, got "
                                 f"{tuple(v.shape)}")
            a = self.mesh.agent
            return v[a:a + 1].to(self.device, copy=True).contiguous()

        return {k: one(v) for k, v in stacked.items()} if isinstance(stacked, dict) else one(
            stacked)

    def _recv_like(self, key: str, v: torch.Tensor) -> torch.Tensor:
        buf = self._recv.get(key)
        if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
            buf = self._recv[key] = torch.empty_like(v, memory_format=torch.contiguous_format)
        return buf

    def _local_mix_once(self, x: Stacked, out: Stacked) -> Stacked:
        """One gossip round on this rank's stack: the self term, then one
        exchange per matching with this rank's partner (every bucket
        sent, every bucket received), each term scaled in float32 and
        summed in the storage dtype, as the reference's ``_local_mix_once``."""
        for k, v in x.items():
            out[k].copy_(_scaled(v, self._sw))
        for p, w in zip(self._partners, self._mw):
            if p is None:  # unmatched in this matching: nothing to send
                continue
            recv = {k: self._recv_like(k, v) for k, v in x.items()}
            self.mesh.exchange([(p, v) for v in x.values()], [(p, r) for r in recv.values()])
            for k, r in recv.items():
                out[k].add_(_scaled(r, w))
        return out

    def _local_allgather_mix(self, x: Stacked, W_row: torch.Tensor, out: Stacked) -> Stacked:
        """One round against a per-call row of W: gather every agent's
        buckets and contract with this rank's row, in float32."""
        for k, v in x.items():
            ag = self.mesh.all_gather(v[0].contiguous()).float().reshape(self.n, -1)
            out[k].copy_(torch.matmul(W_row[None], ag).reshape(v.shape))
        return out

    def _local_residual(self, x: Stacked) -> torch.Tensor:
        """The sharded residual: this rank's deviation, ``all_reduce(MAX)``
        over the agents (a 0-dim float32 tensor, the same on every rank)."""
        dev = torch.sqrt(local_sq_deviation(x, self.mesh)).reshape(1)
        return self.mesh.all_reduce(dev, "max")[0]

    def _local_global_avg(self, x: Stacked) -> None:
        """Every agent's buckets replaced by the float32 mean over the
        agents: one ``all_reduce(SUM)`` a bucket, divided by n."""
        for v in x.values():
            mean = self.mesh.all_reduce(v.float().clone(), "sum") / self.n
            v.copy_(mean)

    def _host_matrix(self, W) -> np.ndarray:
        if isinstance(W, torch.Tensor):
            W = W.detach().cpu().numpy()
        W = np.asarray(W, dtype=np.float32)
        if W.shape != (self.n, self.n):
            raise ValueError(f"W must have shape ({self.n}, {self.n}), got {W.shape}")
        return W

    def _route_for(self, W: np.ndarray, route: str) -> Tuple[str, tuple]:
        """The sharded strategy for a per-call matrix: ``"ring"`` relays
        over the agent ring (``2 k_hops`` messages a bucket and round),
        ``"allgather"`` gathers every agent (``n - 1``); ``"auto"`` picks
        the ring exactly when it moves less.  Returns the choice and the
        ring decomposition."""
        if route not in ("auto", "ring", "allgather"):
            raise ValueError(f"unknown route {route!r}")
        self_w, w_fwd, w_bwd, k_hops = ring_offset_weights(W)
        if route == "auto":
            route = "ring" if 2 * k_hops < self.n - 1 else "allgather"
        return route, (self_w, w_fwd, w_bwd, k_hops)

    def _step_for(self, W=None, route: str = "auto") -> Step:
        """One round ``(state, out) -> out`` against ``W`` (``None``: the
        engine's own): the dense GEMM, or on a mesh the matchings (own
        ``W``), the ring relay or the gathered row (a per-call ``W``)."""
        if self.mesh is None:
            if route not in ("auto", "ring", "allgather"):
                raise ValueError(f"unknown route {route!r}")
            return self._plain(self._matrix(W))
        if W is None:
            return self._local_mix_once
        Wh = self._host_matrix(W)
        route, (sw, wf, wb, k) = self._route_for(Wh, route)
        a = self.mesh.agent
        if route == "allgather":
            row = torch.as_tensor(Wh[a], dtype=torch.float32, device=self.device)
            return lambda x, out: self._local_allgather_mix(x, row, out)
        use_fwd, use_bwd = bool(wf.any()), bool(wb.any())
        return lambda x, out: local_ring_mix(x, sw[a], wf[a], wb[a], k, mesh=self.mesh,
                                             use_fwd=use_fwd, use_bwd=use_bwd, out=out)

    def _residual(self, state: Stacked) -> torch.Tensor:
        return ops.max_deviation(state) if self.mesh is None else self._local_residual(state)

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

    @contextlib.contextmanager
    def _hooks(self, route: str, buffers: Stacked, rounds: Optional[int],
               layout: Optional[ops.FusedLayout]):
        """Round and layout accounting for a fixed-count route, then its
        span; on a mesh ``consensus.bytes_mixed`` adds the bytes this rank
        sent inside it."""
        if rounds is not None:
            self._count_rounds(rounds)
        if self.mesh is None:
            self._note_layout(buffers, rounds, layout)
            with get_tracer().span(f"consensus.{route}"):
                yield
            return
        self._note_layout(buffers, None, layout)
        sent = self.mesh.clock.bytes_sent
        with get_tracer().span(f"consensus.{route}"):
            yield
        get_registry().inc("consensus.bytes_mixed", self.mesh.clock.bytes_sent - sent)

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
            self._rounds(buffers, lambda t, _: t < times, self._step_for(), spare)

    def mix_with_(self, buffers: Stacked, W, times: int = 1, *,
                  spare: Optional[Spare] = None,
                  layout: Optional[ops.FusedLayout] = None, route: str = "auto") -> None:
        """``times`` rounds in place against the per-call matrix ``W``
        (the reference's traced-W ``mix_with``: a time-varying graph
        costs an (n, n) copy, nothing more); ``W=None`` is the engine's
        own matrix, :meth:`mix_`.  On a mesh ``route`` picks the ring
        relay or the gathered row (``"auto"``: whichever moves less)."""
        with self._hooks("mix" if W is None else "mix_with", buffers, times, layout):
            self._rounds(buffers, lambda t, _: t < times, self._step_for(W, route), spare)

    def mix_chebyshev_(self, buffers: Stacked, times: Optional[int] = None, *, W=None,
                       omegas=None, spare: Optional[Spare] = None,
                       layout: Optional[ops.FusedLayout] = None, route: str = "auto") -> None:
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
            step = self._step_for(W, route)
            one, two = spare if spare is not None else self.spare_for(buffers, 2)
            prev, cur, free = buffers, step(buffers, one), two
            for r in range(1, k):
                nxt = step(cur, free)
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
        if self.mesh is not None:
            with self._hooks("global_average", buffers, None, layout):
                self._local_global_avg(buffers)
            return
        self._note_layout(buffers, 1, layout)
        with get_tracer().span("consensus.global_average"):
            ops.global_average(buffers, out=buffers)

    # -- eps-stopping: one residual read per round ---------------------- #
    def _until(self, route, buffers, step, eps, min_times, max_rounds, spare,
               layout) -> Tuple[int, float]:
        res = 0.0

        def more(t, state):
            nonlocal res
            res = float(self._residual(state))
            return t < min_times or (res >= eps and t < max_rounds)

        get_registry().inc("consensus.mix_until.calls")
        with self._hooks(route, buffers, None, layout):
            return self._rounds(buffers, more, step, spare), res

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
        return self._until("mix_until", buffers, self._step_for(), eps, min_times, max_rounds,
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
        route: str = "auto",
    ) -> Tuple[int, float]:
        """:meth:`mix_until_` against the per-call matrix ``W`` (on a mesh
        routed as :meth:`mix_with_`)."""
        return self._until("mix_until" if W is None else "mix_until_with", buffers,
                           self._step_for(W, route), eps, min_times, max_rounds, spare, layout)

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

    def _publish_local_(self, x: Stacked, state: AsyncGossipState,
                        periods: torch.Tensor) -> None:
        """:meth:`_publish_` on a mesh: this rank copies its live value into
        its ``pub`` when its period divides the round; every agent's age
        advances or resets (the ages are replicated on every rank)."""
        publish = torch.remainder(state.rnd, periods) == 0
        mine = publish[self.mesh.agent]
        for key, v in x.items():
            pv = state.pub[key]
            torch.where(mine, v, pv, out=pv)
        state.age.add_(1).masked_fill_(publish, 0)

    def _local_async_round_body(self, periods: torch.Tensor):
        """Sharded counterpart of :meth:`_async_round_body` (the
        reference's ``_local_async_round``): publish -> age -> one
        ``all_gather`` of the published bucket -> ``W_row @ gathered +
        d (x - pub)`` in float32, ``d`` this rank's stale-decayed self
        weight."""
        W, a, n = self._W_dev, self.mesh.agent, self.n

        def round_once(x: Stacked, out: Stacked, state: AsyncGossipState, tau) -> Stacked:
            self._publish_local_(x, state, periods)
            W_row = ops.stale_weight_matrix(W, state.age, tau=tau)[a]
            state.rnd.add_(1)
            with ops._highest_precision():
                for key, v in x.items():
                    pv = state.pub[key]
                    pf = self.mesh.all_gather(pv[0].contiguous()).float().reshape(n, -1)
                    acc = torch.matmul(W_row[None], pf)
                    acc = acc + W_row[a] * (v.reshape(1, -1).float() - pv.reshape(1, -1).float())
                    out[key].copy_(acc.reshape(v.shape))
            return out

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
        bitwise :meth:`mix_`.  Reads nothing back to the host.  On a mesh
        each round gathers the published buckets (``state.pub`` is this
        rank's; ``age`` and ``rnd`` are the same on every rank)."""
        periods = self._periods_tensor(periods)
        round_once = (self._async_round_body(periods) if self.mesh is None
                      else self._local_async_round_body(periods))
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
        are bitwise :meth:`mix_`).  On a mesh ``mass`` gets the total over
        the agents (one ``all_reduce`` a call)."""
        from distributed_learning_tpu_torch.parallel import robust

        with self._hooks("mix_robust", buffers, times, layout), self._mass_total(mass) as share:
            robust.robust_mix_times_program(self, spec)(buffers, times, share, spare)
        get_registry().inc("consensus.robust.rounds", int(times))

    @contextlib.contextmanager
    def _mass_total(self, mass: torch.Tensor):
        """The tensor the robust rounds add their redirected mass to:
        ``mass`` itself on one device; on a mesh this rank's share, summed
        across the ranks into ``mass`` when the rounds are done."""
        if self.mesh is None:
            yield mass
            return
        share = torch.zeros((), dtype=torch.float32, device=self.device)
        yield share
        mass.add_(self.mesh.all_reduce(share.reshape(1), "sum")[0])

    def mix_async_robust_(self, buffers: Stacked, state: AsyncGossipState, spec, tau,
                          times: int = 1, *, periods, mass: torch.Tensor,
                          spare: Optional[Spare] = None,
                          layout: Optional[ops.FusedLayout] = None) -> None:
        """Robust :meth:`mix_async_`: the robust estimator on top of the
        stale-decayed matrix, each delta measured from the receiver's live
        value to the neighbour's publication; the redirected mass is added
        to ``mass`` (on a mesh the total over the agents).  At the neutral
        knobs bitwise :meth:`mix_async_`."""
        from distributed_learning_tpu_torch.parallel import robust

        with (self._hooks("mix_async_robust", buffers, times, layout),
              self._mass_total(mass) as share):
            robust.robust_async_gossip_times_program(self, spec, periods=periods)(
                buffers, state, times, tau, share, spare)

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

    def mix_with(self, stacked: Stacked, W, times: int = 1, *, route: str = "auto") -> Stacked:
        """:meth:`mix_with_` on a copy."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.mix_with_(buffers, W, times, layout=layout, route=route)
        return ops.unflatten_stacked(buffers, layout)

    def mix_until_with(self, stacked: Stacked, W, *, eps: float, min_times: int = 0,
                       max_rounds: int = 10_000,
                       route: str = "auto") -> Tuple[Stacked, int, float]:
        """:meth:`mix_until_with_` on a copy: ``(state, rounds_done, residual)``."""
        buffers, layout = ops.flatten_stacked(stacked)
        t, res = self.mix_until_with_(buffers, W, eps=eps, min_times=min_times,
                                      max_rounds=max_rounds, layout=layout, route=route)
        return ops.unflatten_stacked(buffers, layout), t, res

    def mix_chebyshev(self, stacked: Stacked, times: Optional[int] = None, *, W=None,
                      omegas=None, route: str = "auto") -> Stacked:
        """:meth:`mix_chebyshev_` on a copy."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.mix_chebyshev_(buffers, times, W=W, omegas=omegas, layout=layout, route=route)
        return ops.unflatten_stacked(buffers, layout)

    def global_average(self, stacked: Stacked) -> Stacked:
        """:meth:`global_average_` on a copy."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.global_average_(buffers, layout=layout)
        return ops.unflatten_stacked(buffers, layout)

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
        if self.mesh is None:
            lifted = ops.weighted_lift(stacked, w)
        else:  # this rank's row of the lift
            a = self.mesh.agent
            scale = (w / w.mean())[a:a + 1]
            lifted = {k: x * ops._agent_axis(scale, x).to(x.dtype) for k, x in stacked.items()}
        mixed, _, _ = self.mix_until(lifted, eps=convergence_eps, min_times=1,
                                     max_rounds=max_rounds)
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
        stream; :meth:`mix_pairwise_edges` takes fed draws).  On a mesh
        each round draws one of :meth:`random_maximal_matchings` instead and
        all its pairs average at once; agent 0's draws are broadcast, so
        every rank runs the same matchings."""
        n_edges = len(self.pairwise_edges())
        if n_edges == 0:
            return stacked
        if self.mesh is not None:
            pool = self.random_maximal_matchings()
            draws = torch.randint(0, len(pool), (int(rounds),), generator=generator,
                                  device=generator.device).to(self.device)
            return self.mix_pairwise_matchings(stacked, self.mesh.broadcast(draws))
        draws = torch.randint(0, n_edges, (int(rounds),), generator=generator,
                              device=generator.device)
        return self.mix_pairwise_edges(stacked, draws)

    def mix_pairwise_matchings(self, stacked: Stacked, draws) -> Stacked:
        """:meth:`pairwise_matchings_` on a copy of ``stacked``."""
        buffers, layout = ops.flatten_stacked(stacked)
        self.pairwise_matchings_(buffers, draws, layout=layout)
        return ops.unflatten_stacked(buffers, layout)

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
        if self.mesh is not None:
            raise ValueError("one edge a round is the dense model; on a mesh every matched "
                             "pair of a random maximal matching averages "
                             "(mix_pairwise, pairwise_matchings_)")
        draws = torch.as_tensor(draws, dtype=torch.int64).to(self.device)
        with self._hooks("mix_pairwise", buffers, draws.shape[0], layout):
            pairs = self._edges_dev.index_select(0, draws)
            for r in range(pairs.shape[0]):
                ij = pairs[r]
                for x in buffers.values():
                    rows = x.index_select(0, ij).to(torch.float32)
                    avg = ((rows[0] + rows[1]) * 0.5).to(x.dtype)
                    x.index_copy_(0, ij, avg.expand(2, *avg.shape))

    def random_maximal_matchings(self) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
        """The pool of random maximal matchings sharded pairwise gossip
        draws from, the reference's exactly: greedy completions of edge
        orders from ``np.random.default_rng(0x5EED)``, one order seeded by
        each edge (so every edge is in some matching) and eight fully
        random ones, deduplicated in first-seen order."""
        cached = getattr(self, "_pairwise_matchings", None)
        if cached is not None:
            return cached
        rng = np.random.default_rng(0x5EED)
        E = [(int(i), int(j)) for i, j in self.pairwise_edges()]

        def greedy(order):
            used, M = set(), []
            for (i, j) in order:
                if i not in used and j not in used:
                    M.append((i, j))
                    used.update((i, j))
            return tuple(sorted(M))

        pool: Dict[Tuple, None] = {}
        for k, e in enumerate(E):
            rest = E[:k] + E[k + 1:]
            rng.shuffle(rest)
            pool.setdefault(greedy([e] + rest), None)
        for _ in range(8):
            order = list(E)
            rng.shuffle(order)
            pool.setdefault(greedy(order), None)
        self._pairwise_matchings = tuple(pool.keys())
        return self._pairwise_matchings

    def pairwise_matchings_(self, buffers: Stacked, draws, *,
                            layout: Optional[ops.FusedLayout] = None) -> None:
        """Sharded pairwise gossip in place (the reference's
        ``_mix_pairwise_sharded``): round ``r`` takes matching
        ``draws[r]`` of :meth:`random_maximal_matchings`; a matched rank
        exchanges its buckets with its partner and both keep
        ``(1 - 0.5) x + 0.5 x_partner`` in float32, an unmatched rank keeps
        its value.  The draws must be the same on every rank."""
        if self.mesh is None:
            raise ValueError("pairwise_matchings_ is the sharded route; the dense one is "
                             "pairwise_ (one edge a round)")
        pool = self.random_maximal_matchings()
        draws = [int(d) for d in torch.as_tensor(draws).reshape(-1).tolist()]
        a = self.mesh.agent
        with self._hooks("mix_pairwise", buffers, len(draws), layout):
            for d in draws:
                p = next((j if i == a else i for i, j in pool[d] if a in (i, j)), None)
                if p is None:
                    continue
                recv = {k: self._recv_like(k, v) for k, v in buffers.items()}
                self.mesh.exchange([(p, v) for v in buffers.values()],
                                   [(p, r) for r in recv.values()])
                for k, v in buffers.items():
                    v.copy_(0.5 * v.float() + 0.5 * recv[k].float())

    def deviations(self, stacked: Stacked) -> torch.Tensor:
        """(n,) per-agent L2 distance from the mean parameter vector (on a
        mesh gathered from every rank)."""
        if self.mesh is None:
            return ops.agent_deviations(stacked)
        return self.mesh.all_gather(torch.sqrt(local_sq_deviation(stacked, self.mesh)))

    def max_deviation(self, stacked: Stacked) -> torch.Tensor:
        return self._residual(stacked)

    def max_std(self, stacked: Stacked) -> torch.Tensor:
        """Max across-agent parameter std (population std), a 0-dim device
        tensor (on a mesh the same on every rank)."""
        if self.mesh is None:
            return ops.max_std(stacked)
        m = torch.zeros((), dtype=torch.float32, device=self.device)
        for v in stacked.values():
            lf = v.float()
            mean = self.mesh.all_reduce(lf.clone(), "sum") / self.n
            var = self.mesh.all_reduce((lf - mean) ** 2, "sum") / self.n
            m = torch.maximum(m, torch.sqrt(var).max())
        return m

    def max_deviation_(self, stacked: Stacked, out: torch.Tensor) -> None:
        """The residual written into the 0-dim device tensor ``out``, with
        no host read on the dense route: what a captured gossip program
        reports."""
        out.copy_(self._residual(stacked))

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
