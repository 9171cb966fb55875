"""Asynchronous straggler-tolerant gossip runtime over the TCP backend
(port of ``distributed_learning_tpu/comm/async_runtime.py``: the same
frames, validation, staleness accounting and host arithmetic).  Values
are torch tensors at :meth:`AsyncGossipRunner.begin_round`,
:meth:`~AsyncGossipRunner.finish_round`,
:meth:`~AsyncGossipRunner.run_async_round` and
:meth:`~AsyncGossipRunner.run_async_choco`: one copy to the host in,
one copy back onto the caller's device out
(:func:`~distributed_learning_tpu_torch.comm.agent.host_value`).

The reference's own notes follow.

Every other backend in this repo runs LOCK-STEP rounds: the protocol the
reference gestures at in its asyncio backend (``consensus_asyncio.py:
209-312``) still pairs every request with a response, so the slowest of
N agents sets the pace of all of them.  This module is the asynchronous
round engine the ROADMAP names: gossip overlaps local compute, stale
neighbor state is mixed at decayed weight instead of waited for, and a
wedged straggler costs its own progress — not the fleet's.

Model (grounded in *Improving Efficiency in Large-Scale Decentralized
Distributed Training*, arXiv:2002.01119, for stale-tolerant mixing, and
*Local SGD with Periodic Averaging*, arXiv:1910.13598, for when it is
safe to communicate less):

* **Push, don't pull.**  Each round an agent PUSHES its current value to
  every neighbor as an :class:`~distributed_learning_tpu_torch.comm.protocol.
  AsyncValue` frame (round- and generation-tagged) and mixes against
  whatever sits in its per-neighbor inbox — the **double buffer**:
  buffer A is the live value local compute runs on, buffer B is the last
  *received* neighbor state the wire keeps filling.
* **Arrival-anchored staleness.**  A neighbor's staleness is how many of
  MY rounds already mixed its standing value (0 = fresh this round), so
  round counters never need cross-agent alignment — a rejoiner's frames
  are immediately usable.  Stale values mix at weight ``w/(1+s)``; the
  decayed/dropped mass stays on the self edge so the mixing row still
  sums to one (mirroring
  :func:`~distributed_learning_tpu_torch.ops.mixing.stale_weight_matrix`, the
  device-side program of the same model).
* **Hard staleness bound tau.**  Beyond ``tau`` the contribution is
  DROPPED (zero weight this round) and the neighbor is POKED — the
  re-request half of drop-and-re-request.  ``tau=0`` means synchronous:
  block until every neighbor delivered a value newer than the last round
  — the runtime degenerates to the lock-step protocol and is
  bit-identical to ``run_once``/``run_choco_once`` sequences.
* **Deadline-bounded waits.**  ``deadline_s`` caps any blocking wait; on
  expiry the missing neighbors are dropped for this round (sticky until
  their next frame arrives, so a dead peer is paid for once, not every
  round).

CHOCO-compressed rounds ride the same runtime with one twist: the
replicated public estimates (``x̂``) ARE the double buffer, and
corrections are deltas, so they must be applied **exactly once, in
order** — the inbox keeps a per-neighbor FIFO and a straggler's backlog
is drained in one catch-up batch (``tau=0`` applies exactly one per
round: the lock-step recurrence).  A round that got no correction from a
neighbor simply mixes against the standing estimates, which is why CHOCO
tolerates asynchrony so naturally.
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.comm import protocol as P
from distributed_learning_tpu_torch.comm.agent import (
    AgentStatus,
    ConsensusAgent,
    ShutdownError,
    host_value,
)
from distributed_learning_tpu_torch.comm.tensor_codec import (
    DenseFrame,
    FusedFrame,
    SparseFrame,
)

__all__ = [
    "AsyncGossipRunner",
    "AsyncRoundStats",
    "QUARANTINE_PAYLOAD_KIND",
]



#: ``payload["kind"]`` marking a Telemetry payload as a quarantine report
#: (runner -> master): ``{"kind": ..., "accused": token, "violations": n,
#: "round": r, "generation": g}``.  The master accumulates accusers per
#: accused token and, at quorum, evicts the peer and (with
#: ``regenerate=True``) excludes it from the next membership generation
#: (docs/robustness.md §Quarantine).
QUARANTINE_PAYLOAD_KIND = "robust.quarantine"


@dataclasses.dataclass
class AsyncRoundStats:
    """What one async round actually mixed (``runner.last_stats``)."""

    round: int = 0
    #: token -> staleness of the contribution mixed (0 = fresh).
    mixed: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: tokens whose contribution was dropped this round (staleness > tau
    #: or deadline expiry); their edge weight stayed on self.
    dropped: List[str] = dataclasses.field(default_factory=list)
    #: queued frames skipped: latest-wins consumption (plain rounds,
    #: tau > 0) or replayed corrections deduplicated by the exactly-once
    #: watermark (CHOCO rounds).
    skipped: int = 0
    #: corrections applied this round (CHOCO rounds), token -> count.
    applied: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Inbox:
    """Per-neighbor receive state: the FIFO of unconsumed frames plus
    the standing (last mixed) value and its reuse count."""

    __slots__ = (
        "queue", "last", "times_mixed", "dropped", "choco_lag",
        "violations", "seen_gen", "seen_round", "seen_stale",
        "last_trace", "choco_applied_gen", "choco_applied_round",
    )

    def __init__(self):
        self.queue: deque = deque()  # (value, sender_round, staleness, trace)
        self.last: Optional[np.ndarray] = None
        # TraceContext of the frame `last` came from (None untraced):
        # consumed by the first mix of that frame — the "mix" hop that
        # closes its flow chain in the merged trace.
        self.last_trace = None
        self.times_mixed = 0  # rounds `last` was already mixed
        self.dropped = False  # sticky: dropped until a fresh arrival
        self.choco_lag = 0  # consecutive rounds without a correction
        # Wire-field validation state (docs/robustness.md §Validation):
        # violation tally + the last accepted (generation, round,
        # staleness) — round ids must be monotone per neighbor within a
        # generation, staleness monotone within a round (re-pushes age).
        self.violations = 0
        self.seen_gen: Optional[int] = None
        self.seen_round = -1
        self.seen_stale = -1
        # Exactly-once CHOCO accounting: the newest sender round whose
        # correction was APPLIED (within choco_applied_gen).  A replayed
        # frame — a dup, or a poke-triggered re-push of a round that
        # already landed through the normal path — carries a round id at
        # or below this watermark and must be counted, never re-applied:
        # corrections are deltas on the replicated estimate, so a second
        # apply corrupts x̂ for every subsequent round (the
        # reference's protocol model checks exactly this bug).
        self.choco_applied_gen: Optional[int] = None
        self.choco_applied_round = -1


class AsyncGossipRunner:
    """Drives asynchronous gossip rounds over a started
    :class:`~distributed_learning_tpu_torch.comm.agent.ConsensusAgent`.

    Parameters
    ----------
    agent:
        A READY agent (handshake complete).  The runner owns the
        agent's receive path while its rounds run; do not interleave
        lock-step collectives (``run_once``/``run_round``) with async
        rounds without a quiescent point in between.
    staleness_bound:
        tau.  0 = synchronous (bit-identical to the lock-step path);
        k >= 1 mixes values up to k rounds old at ``w/(1+s)`` weight and
        drops older ones.
    deadline_s:
        Cap on any blocking wait for a required-fresh neighbor; expiry
        drops it for this round (sticky) and pokes it.  None = wait
        forever (pure bounded-staleness mode).
    validate_wire:
        Validate the protocol fields of every incoming
        :class:`~distributed_learning_tpu_torch.comm.protocol.AsyncValue`
        (round ids monotone per neighbor within a generation, staleness
        monotone within a round, both non-negative and within
        ``round_slack`` of this runner's own round).  An honest runtime
        never trips these, so the default is on; a violating frame is
        dropped unmixed and the peer poked for a well-formed push.
    quarantine_after:
        Violations (per neighbor) before the peer is QUARANTINED: its
        stream is evicted, its edge weight renormalizes to self, and the
        master is notified via a :data:`QUARANTINE_PAYLOAD_KIND`
        telemetry payload so regeneration can exclude it.
    round_slack:
        Bound on how far ahead of this runner's own round counter a
        claimed ``round_id``/``staleness`` may run.  Generous on purpose
        — honest peers legitimately run ahead in bounded-staleness mode;
        the bound only has to catch absurd claims (a lying peer
        advertising round 10**18 to poison staleness accounting).
    overlap:
        Decode/compute overlap (zero-copy wire path, docs/wire.md
        §Zero-copy receive path).  Off (default): the dispatch loop
        densifies each arriving frame into the edge's scratch ravel at
        its service point.  On: frames stay lazy in the inbox and
        :meth:`finish_round` pipelines them — the NEXT neighbor's frame
        densifies on a worker thread (ctypes/numpy release the GIL)
        while the round task numpy-mixes the PREVIOUS one.  Mixing
        order and arithmetic are identical either way.
    """

    def __init__(
        self,
        agent: ConsensusAgent,
        *,
        staleness_bound: int = 0,
        deadline_s: Optional[float] = None,
        validate_wire: bool = True,
        quarantine_after: int = 3,
        round_slack: int = 100_000,
        overlap: bool = False,
    ):
        if staleness_bound < 0:
            raise ValueError(
                f"staleness_bound must be >= 0, got {staleness_bound}"
            )
        if quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {quarantine_after}"
            )
        self.agent = agent
        self.tau = int(staleness_bound)
        self.deadline_s = (
            None if deadline_s is None else float(deadline_s)
        )
        self.validate_wire = bool(validate_wire)
        self.quarantine_after = int(quarantine_after)
        self.round_slack = int(round_slack)
        self.overlap = bool(overlap)
        self._round = 0
        self._inbox: Dict[str, _Inbox] = {}
        self._pub_value: Optional[np.ndarray] = None
        self._pub_round = 0
        # Brings the open round's host result back onto the caller's device.
        self._pub_back: Optional[Callable[[np.ndarray], torch.Tensor]] = None
        self._poked: set = set()
        self._quarantined: set = set()
        # Per-edge decode scratch pool (zero-copy receive path): token ->
        # ONE idle f32 ravel awaiting the edge's next frame.  A buffer
        # leaves the pool at the dispatch service point (decode target),
        # rides the inbox as the decoded value, and re-enters the pool —
        # adopt-on-supersede — when the round task replaces it as the
        # standing value (or applies it, for CHOCO corrections).  All
        # hand-offs run on the round task's turns (the comments at the
        # pool's pops below say why each one does).
        # Evicted wholesale on membership realignment and per-edge on
        # quarantine: a stale-sized buffer must miss, never corrupt.
        self._scratch: Dict[str, np.ndarray] = {}
        self._decode_pool = None  # 1-thread executor, built on first use
        # In-flight detached value sends (_send_detached): tracked so a
        # late failure is still silenced/observed, bounded by the round
        # structure itself (a round cannot finish without the neighbors
        # it pushed to making progress of their own).
        self._send_tasks: set = set()
        self.last_stats = AsyncRoundStats()

    # ------------------------------------------------------------------ #
    @property
    def round(self) -> int:
        """Completed async rounds."""
        return self._round

    def _box(self, token: str) -> _Inbox:
        box = self._inbox.get(token)
        if box is None:
            box = self._inbox[token] = _Inbox()
        return box

    @property
    def quarantined(self) -> frozenset:
        """Tokens this runner has quarantined (their edges renormalize
        to self until the master regenerates the topology without them)."""
        return frozenset(self._quarantined)

    def _active(self) -> List[str]:
        """Weighted neighbors with a live stream, sorted (mixing
        accumulates in this order on every agent — deterministic, and
        the tau=0 oracle against the lock-step path can be bit-exact).
        Quarantined peers are excluded even if a replacement stream
        reappears: only a membership regeneration can readmit them."""
        a = self.agent
        return sorted(
            t for t in a._weights
            if t in a._neighbors and t not in self._quarantined
        )

    # ------------------------------------------------------------------ #
    # Decode scratch pool (docs/wire.md §Zero-copy receive path)         #
    # ------------------------------------------------------------------ #
    def _scratch_buf(
        self, token: str, buf: Optional[np.ndarray], size: int
    ) -> np.ndarray:
        """Account and return a decode target for ``token``'s next
        frame: the pool buffer the caller popped when it fits
        (``comm.wire.scratch_hits``), else a fresh ravel (misses — the
        first two frames of an edge, and any size change).  Each bump
        lands twice: the bare run total and a per-edge labeled copy
        under the frame's inbound direction (``<peer>-><self>``, the
        same convention as ``comm.edge.*``) so the ``obs-report
        --merge`` edge table can attribute pool behavior per link."""
        a = self.agent
        edge = f"{token}->{a.token}"
        if buf is not None and buf.size == size:
            a._count_wire("scratch_hits")
            a._count_wire(f"scratch_hits/{edge}")
        else:
            buf = np.empty(size, np.float32)
            a._count_wire("scratch_misses")
            a._count_wire(f"scratch_misses/{edge}")
        a._count_wire("scratch_bytes", 4 * size)
        a._count_wire(f"scratch_bytes/{edge}", 4 * size)
        return buf

    def _densify_dispatch(
        self, token: str, value: Any, buf: Optional[np.ndarray]
    ) -> np.ndarray:
        """Serial-mode dispatch decode: densify an arriving dense/sparse
        frame into the edge's scratch ravel.  Direct-injected ndarrays
        (tests drive ``_handle_peer_msg`` without the wire) are copied
        into a runner-owned buffer too, so adopt-on-supersede can never
        recycle caller memory into the pool."""
        if isinstance(value, np.ndarray):
            v = np.ascontiguousarray(value, np.float32).ravel()
            out = self._scratch_buf(token, buf, v.size)
            np.copyto(out, v)
            return out
        return value.densify(out=self._scratch_buf(token, buf, value.size))

    def _recycle(self, token: str, old: Any, new: Any) -> None:
        """Adopt a superseded decode buffer back into the pool (single
        idle slot per edge; ``setdefault`` keeps an existing idle buffer
        and simply drops the extra)."""
        if (
            old is not None
            and old is not new
            and isinstance(old, np.ndarray)
            and old.ndim == 1
            and old.dtype == np.float32
            and old.flags.c_contiguous
            and old.flags.writeable
        ):
            self._scratch.setdefault(token, old)

    def _decode_executor(self):
        """The overlap mode's single decode worker, built lazily (a
        serial runner never spawns a thread)."""
        if self._decode_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._decode_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dlt-decode"
            )
        return self._decode_pool

    # ------------------------------------------------------------------ #
    # Wire-field validation + quarantine (docs/robustness.md)            #
    # ------------------------------------------------------------------ #
    def _validate_async_fields(self, token: str, msg: Any) -> bool:
        """Check an AsyncValue's protocol fields against the per-neighbor
        history: non-negative, round ids monotone within a generation
        (an honest peer's counter never runs backwards; a rejoin resets
        it WITH a generation bump), staleness monotone for re-pushes of
        the same round, and both within ``round_slack`` of our own round
        (arrival-anchored staleness never needs alignment, so the bound
        only rejects absurd claims).  Accepting updates the history."""
        box = self._box(token)
        if box.seen_gen != msg.generation:
            # New membership generation: the peer's counter legitimately
            # restarts (rejoin/replacement); reset the monotonicity base.
            box.seen_gen = msg.generation
            box.seen_round = -1
            box.seen_stale = -1
        bound = self._round + self.round_slack
        ok = (
            msg.round_id >= 0
            and msg.staleness >= 0
            and msg.round_id >= box.seen_round
            and not (
                msg.round_id == box.seen_round
                and msg.staleness < box.seen_stale
            )
            and msg.round_id <= bound
            and msg.staleness <= bound
        )
        if ok:
            box.seen_round = msg.round_id
            box.seen_stale = msg.staleness
        return ok

    def _on_violation(self, token: str) -> None:
        """One protocol violation from ``token``: the frame was already
        dropped unmixed; tally it, poke for a well-formed push
        (drop-and-poke), and quarantine at the threshold."""
        a = self.agent
        box = self._box(token)
        box.violations += 1
        a._count("async_field_violations")
        if box.violations >= self.quarantine_after:
            self._quarantine(token)
        else:
            task = asyncio.ensure_future(self._poke(token))
            task.add_done_callback(a._silence)

    def _quarantine(self, token: str) -> None:
        """Evict a repeatedly-violating peer: purge its inbox (its edge
        weight renormalizes to self exactly like a dropped straggler's),
        close its stream, and notify the master with a
        :data:`QUARANTINE_PAYLOAD_KIND` telemetry payload so
        regeneration can exclude it from the next generation."""
        a = self.agent
        if token in self._quarantined:
            return
        self._quarantined.add(token)
        box = self._box(token)
        box.queue.clear()
        box.last = None
        box.dropped = True
        self._scratch.pop(token, None)  # the edge's decode buffer dies too
        a._mux.remove(token)
        stream = a._neighbors.pop(token, None)
        if stream is not None:
            stream.close()
        a._count("async_quarantines")
        task = asyncio.ensure_future(
            a.send_telemetry(
                {
                    "kind": QUARANTINE_PAYLOAD_KIND,
                    "accused": token,
                    "violations": box.violations,
                    "round": self._round,
                    "generation": a._generation,
                }
            )
        )
        task.add_done_callback(a._silence)

    # ------------------------------------------------------------------ #
    # Wire I/O (the dispatch loop; values stay numpy, no device syncs)  #
    # ------------------------------------------------------------------ #
    async def _push(self, value: np.ndarray, staleness: int = 0) -> None:
        """Ship the current value to every active neighbor (the
        unsolicited push half of the runtime)."""
        a = self.agent
        if a._fused_spans is not None:
            # Fused CHOCO push (run_async_choco(buckets=...)): the whole
            # correction ships as ONE fused frame — the receiver applies
            # it straight onto its replicated estimate, no densify.
            kind = P._ASYNC_FUSED
        elif a.sparse_wire and a._sparse_wins(value):
            kind = P._ASYNC_SPARSE
        else:
            kind = P._ASYNC_DENSE
        msg = P.AsyncValue(
            round_id=self._round, generation=a._generation,
            staleness=staleness, value=value, kind=kind,
            buckets=a._fused_spans,
            bf16_wire=a.bf16_wire, int8_wire=a._int8_active,
        )
        a._count("async_pushes")
        for token in self._active():
            # Trace stamping is per NEIGHBOR (the edge label and seq
            # differ per destination): replace on the shared base frame.
            out = a._stamp_trace(msg, token)
            self._send_detached(token, out)

    def _send_detached(self, token: str, out) -> None:
        """Ship one frame to ``token`` on a detached (tracked) task.

        The round task must never await a neighbor's socket drain: it is
        also the mux pump (``_recv_step``) that re-arms this agent's
        reads.  When every agent pushes a frame larger than the kernel's
        socket buffers at once, synchronous sends form a cycle — each
        round task parked in ``drain()``, nobody pumping reads, every
        reader idle — and the deployment deadlocks (observed at ~2 MB
        frames on loopback; full model width is ~146 MB).  Detached
        sends keep FIFO order per edge (the framer's ``_send_lock``
        wakes waiters in acquisition order) and let the pump resume
        immediately; a failed send marks the edge dropped exactly as the
        inline path did."""
        a = self.agent
        framer = a._neighbors[token]

        async def _send_one():
            try:
                await framer.send(out)
            except (ConnectionError, OSError):
                self._box(token).dropped = True
                return
            if out.trace is not None:
                a._emit_flow("send", out.trace, f"{a.token}->{token}")

        task = asyncio.ensure_future(_send_one())
        self._send_tasks.add(task)
        task.add_done_callback(self._send_tasks.discard)
        task.add_done_callback(a._silence)

    async def _answer_poke(self, token: str) -> None:
        """Re-send the standing published value to a poked-by neighbor
        (best effort; nothing published yet means nothing to send)."""
        a = self.agent
        if self._pub_value is None or token not in a._neighbors:
            return
        a._count("pokes_answered")
        if a._fused_spans is not None:
            # Poke answered inside the fused-push window: same bytes as
            # the push.  Outside it, the standing (already wire-rounded)
            # value re-encodes sparse/dense — narrowing is idempotent,
            # so a CHOCO replay carries identical values and the
            # exactly-once watermark dedups it.
            kind = P._ASYNC_FUSED
        elif a.sparse_wire and a._sparse_wins(self._pub_value):
            kind = P._ASYNC_SPARSE
        else:
            kind = P._ASYNC_DENSE
        msg = a._stamp_trace(
            P.AsyncValue(
                round_id=self._pub_round, generation=a._generation,
                staleness=self._round - self._pub_round,
                value=self._pub_value, kind=kind,
                buckets=a._fused_spans,
                bf16_wire=a.bf16_wire, int8_wire=a._int8_active,
            ),
            token,
        )
        try:
            await a._neighbors[token].send(msg)
        except (ConnectionError, OSError):
            return
        if msg.trace is not None:
            a._emit_flow("send", msg.trace, f"{a.token}->{token}")

    async def _poke(self, token: str) -> None:
        """The re-request half of drop-and-re-request: ask a
        staleness-bound-exceeded neighbor for a fresh push.  One poke
        per staleness excursion (cleared when its next frame lands).

        Shipped detached for the same reason value pushes are: the
        framer's send lock may be held by an in-flight multi-MB frame
        whose receiver has stopped reading (a peer past its last
        round), and an inline ``send`` would park the round task behind
        that drain forever — the deadline loop never expires and the
        round never finishes."""
        a = self.agent
        if token in self._poked or token not in a._neighbors:
            return
        self._poked.add(token)
        a._count("pokes_sent")
        self._send_detached(
            token,
            P.AsyncPoke(round_id=self._round, generation=a._generation),
        )

    async def _recv_step(self, timeout: Optional[float]) -> bool:
        """Receive + handle ONE message from the master or any neighbor;
        False on timeout.  The persistent-task discipline of the agent
        is kept: an in-flight frame read is never cancelled."""
        a = self.agent
        if a._master_task is None and a._master is not None:
            a._master_task = asyncio.ensure_future(a._master.recv())
            a._master_task.add_done_callback(a._silence)
        if a._mux_task is None:
            a._mux_task = asyncio.ensure_future(a._mux.__anext__())
        tasks = {t for t in (a._master_task, a._mux_task) if t is not None}
        done, _ = await asyncio.wait(
            tasks, timeout=timeout, return_when=asyncio.FIRST_COMPLETED
        )
        if not done:
            return False
        if a._master_task is not None and a._master_task in done:
            task, a._master_task = a._master_task, None
            await self._handle_master(task.result())
            return True
        token, msg, src = a._mux_task.result()
        a._mux_task = None
        self._handle_peer_msg(token, msg, src)
        return True

    async def _handle_master(self, msg: Any) -> None:
        a = self.agent
        if isinstance(msg, P.NeighborhoodData):
            # Membership generation broadcast: realign weights/streams;
            # inboxes of removed edges die with their streams, and the
            # WHOLE decode scratch pool is evicted — replacement peers
            # may publish a different model width, and a stale-sized
            # buffer must cost one miss, never a corrupt decode.
            await a._apply_neighborhood(msg)
            # generation-realignment turn discipline: _handle_master runs inside the round task's own _recv_step await, so no pipelined decode is writing into a pooled buffer while the pool empties (the round task is HERE, not in _mix_pipelined) and the next dispatch simply takes misses
            self._scratch.clear()
            for token in list(self._inbox):
                if token not in a._weights:
                    # membership turn discipline: _handle_master runs inside the round task's own _recv_step await (never concurrently with _consume/_mix_plain, which only run after _collect returns), so evicting a removed edge's inbox here cannot race the round's reads
                    del self._inbox[token]
        elif isinstance(msg, P.Shutdown):
            a.status = AgentStatus.SHUTDOWN
            raise ShutdownError(msg.reason)
        # else: round-lifecycle traffic of the lock-step protocol —
        # stale here, dropped.

    def _handle_peer_msg(self, token: str, msg: Any, src: Any) -> None:
        a = self.agent
        if msg is None:
            cur = a._neighbors.get(token)
            if token not in a._weights or (cur is not None and cur is not src):
                return  # removed edge or an already-replaced stream
            # Neighbor died: the async runtime tolerates it — its edge
            # is dropped (sticky) until a replacement pushes; the
            # membership generation machinery heals the stream set.
            a._neighbors.pop(token, None)
            a._count("async_neighbor_deaths")
            self._box(token).dropped = True
            return
        if isinstance(msg, P.AsyncValue):
            if token in self._quarantined:
                a._count("async_quarantined_dropped")
                return
            if msg.generation != a._generation:
                a._count("async_gen_dropped")
                return
            if self.validate_wire and not self._validate_async_fields(
                token, msg
            ):
                self._on_violation(token)
                return
            value = msg.value
            if not self.overlap and not isinstance(value, FusedFrame):
                # Serial mode: densify dense/sparse frames HERE, into
                # the edge's scratch ravel — one pinned buffer per peer
                # stream instead of an allocation per frame.  Fused
                # frames stay lazy in either mode: the CHOCO consume
                # applies their sections straight onto the replicated
                # estimate.  In overlap mode everything stays lazy and
                # _mix_pipelined decodes off the event loop.
                # scratch-pool turn discipline: every pop of an idle decode buffer runs on one of the round task's own turns (dispatch executes inside its _recv_step await; pipelined decode pops on the round task itself), and a buffer only re-enters the pool after that same task supersedes the value decoded into it, so no other task ever holds or writes these buffers
                buf = self._scratch.pop(token, None)
                value = self._densify_dispatch(token, value, buf)
            box = self._box(token)
            box.queue.append(
                (value, msg.round_id, msg.staleness, msg.trace)
            )
            box.dropped = False
            if a.trace and msg.trace is not None:
                # Receiver half of the traced frame: recv+decode hops
                # (the frame body was decoded by the recv that produced
                # msg) plus the edge's wall-clock transit latency.
                edge = f"{token}->{a.token}"
                a._emit_flow("recv", msg.trace, edge)
                a._emit_flow("decode", msg.trace, edge)
                if msg.trace.t_wall:
                    # cross-process edge latency: t_wall is the SENDER's wall-clock send stamp; monotonic clocks cannot compare across processes
                    lat = time.time() - msg.trace.t_wall
                    a._observe(f"comm.edge.latency_s/{edge}", lat)
            # arrival-clears-excursion FIFO discipline: the discard runs at the single dispatch service point (inside the round task's _recv_step await), and _poke only re-adds after _collect has re-checked _needs_fresh on the post-arrival state
            self._poked.discard(token)
            a._count("async_values_received")
        elif isinstance(msg, P.AsyncPoke):
            if token in self._quarantined:
                a._count("async_quarantined_dropped")
                return
            a._count("pokes_received")
            # Answer at this service point (we are inside the dispatch
            # loop already): schedule the re-push.
            task = asyncio.ensure_future(self._answer_poke(token))
            task.add_done_callback(a._silence)
        # else: lock-step frames (ValueRequest/...) — not part of an
        # async run; dropped.

    # ------------------------------------------------------------------ #
    # Plain (uncompressed) async rounds                                  #
    # ------------------------------------------------------------------ #
    def _needs_fresh(self, token: str) -> bool:
        """Whether the round must wait for a new frame from ``token``:
        nothing usable is queued AND the standing value would exceed the
        staleness bound (never-arrived counts as infinitely stale), AND
        it has not already been dropped this excursion."""
        box = self._box(token)
        if box.queue or box.dropped:
            return False
        return box.last is None or box.times_mixed > self.tau

    async def _drain_ready(self) -> None:
        """Dispatch every ALREADY-COMPLETED read before computing the
        round's requirements.  Sticky drops only clear at dispatch, so
        a round that requires nothing (every neighbor dropped, or all
        within tau) must still consume what the persistent reader tasks
        finished while the round task was elsewhere — otherwise a
        fully-dropped excursion never polls the mux again and the
        poke/re-push recovery path is a lost wakeup: frames pile up
        parsed-but-undelivered while every round free-runs on self."""
        while await self._recv_step(0):
            pass

    async def _collect(self) -> None:
        """Wait (deadline-bounded) until no active neighbor is required
        to deliver a fresh frame; expiry drops the stragglers for this
        round and pokes them."""
        a = self.agent
        await self._drain_ready()
        deadline = (
            None if self.deadline_s is None
            else asyncio.get_event_loop().time() + self.deadline_s
        )
        while True:
            required = [t for t in self._active() if self._needs_fresh(t)]
            if not required:
                return
            timeout = None
            if deadline is not None:
                timeout = deadline - asyncio.get_event_loop().time()
                if timeout <= 0:
                    for t in required:
                        self._box(t).dropped = True
                        a._count("async_deadline_drops")
                        await self._poke(t)
                    return
            if not await self._recv_step(timeout):
                continue  # deadline re-checked at the loop head

    def _consume(
        self, token: str, stats: AsyncRoundStats, *, densify: bool = True
    ) -> _Inbox:
        """Advance ``token``'s inbox for this round: tau=0 consumes the
        OLDEST unread frame (lock-step order — exactly one frame per
        sender round), tau>0 jumps to the latest (mix the newest
        information, count the skips).  The superseded standing buffer
        re-enters the scratch pool (adopt-on-supersede); a still-lazy
        payload densifies into edge scratch here unless the pipelined
        mixer (``densify=False``) is about to decode it off-loop."""
        box = self._box(token)
        if box.queue:
            if self.tau == 0:
                value, _, sent_stale, trace = box.queue.popleft()
            else:
                stats.skipped += len(box.queue) - 1
                value, _, sent_stale, trace = box.queue[-1]
                box.queue.clear()
            if densify and not isinstance(value, np.ndarray):
                # A FUSED push consumed by a plain round (deployment
                # mismatch — tolerated, the frame is self-describing):
                # densify on the round task.  _consume is round-owned,
                # so the pool hand-off needs no suppression here.
                buf = self._scratch.pop(token, None)
                value = value.densify(
                    out=self._scratch_buf(token, buf, value.size)
                )
            self._recycle(token, box.last, value)
            box.last = value
            box.last_trace = trace
            box.times_mixed = 0
            box.dropped = False
        return box

    def _mix_plain(self, y: np.ndarray) -> np.ndarray:
        """The stale-weighted mixing update, accumulated in sorted-token
        order: fresh neighbors at full weight, stale ones at
        ``w/(1+s)`` with the difference on self, dropped ones fully on
        self — the host-side twin of the fused device program
        (``ops.mixing.stale_weight_matrix``); rows always sum to 1."""
        a = self.agent
        stats = self.last_stats
        total_w = sum(a._weights.values())
        out = (1.0 - total_w) * y
        for token in sorted(a._weights):
            w = a._weights[token]
            box = self._consume(token, stats)
            s = box.times_mixed
            usable = (
                box.last is not None and not box.dropped and s <= self.tau
            )
            if not usable:
                stats.dropped.append(token)
                a._count("async_stale_dropped")
                out = out + w * y  # dropped mass renormalizes to self
            elif s == 0:
                stats.mixed[token] = 0
                out = out + w * box.last
            else:
                stats.mixed[token] = s
                a._count("async_stale_mixed")
                w_eff = w / (1.0 + s)
                out = out + w_eff * box.last + (w - w_eff) * y
            if usable and s == 0 and box.last_trace is not None:
                # First mix of this frame closes its flow chain; stale
                # re-mixes of the standing value don't re-emit.
                a._emit_flow("mix", box.last_trace, f"{token}->{a.token}")
                box.last_trace = None
            box.times_mixed += 1
            stale_pt = float(s if usable else self.tau + 1)
            a._observe("comm.agent.staleness", stale_pt, step=self._round)
            a._observe(
                f"comm.edge.staleness/{token}->{a.token}",
                stale_pt, step=self._round,
            )
        return out

    async def _mix_pipelined(self, y: np.ndarray) -> np.ndarray:
        """Overlap-mode twin of :meth:`_mix_plain`: identical queue
        discipline, accumulation order, and arithmetic, but the inbox
        still holds LAZY frames (dispatch skipped the densify), so each
        frame decodes into edge scratch on the single worker thread
        (``loop.run_in_executor`` — the ctypes engine and numpy release
        the GIL) while the round task numpy-mixes the PREVIOUS
        neighbor's contribution.  At most two decodes are in flight:
        one running, one queued behind it.  The decoded array replaces
        ``box.last`` so stale re-mixes in later rounds never re-decode.
        """
        a = self.agent
        loop = asyncio.get_event_loop()
        stats = self.last_stats
        tokens = sorted(a._weights)
        # Stage 1 (sync, round task): advance every inbox — the frames
        # to decode this round, in mixing order.
        boxes = {t: self._consume(t, stats, densify=False) for t in tokens}
        jobs = [
            t for t in tokens if not isinstance(
                boxes[t].last, (np.ndarray, type(None))
            )
        ]
        inflight: Dict[str, Any] = {}
        nxt = 0

        def _submit(t: str) -> None:
            frame = boxes[t].last
            # Round-task turn: the pool hand-off happens HERE, not on
            # the worker — the thread only ever writes the buffer it
            # was handed (the scratch-pool turn-discipline claim).
            buf = self._scratch.pop(t, None)
            buf = self._scratch_buf(t, buf, frame.size)
            inflight[t] = loop.run_in_executor(
                self._decode_executor(),
                functools.partial(frame.densify, out=buf),
            )

        if jobs:
            _submit(jobs[0])
            nxt = 1
        total_w = sum(a._weights.values())
        out = (1.0 - total_w) * y
        for token in tokens:
            box = boxes[token]
            if token in inflight:
                # Keep the pipe full BEFORE blocking on this decode.
                while nxt < len(jobs) and len(inflight) < 2:
                    _submit(jobs[nxt])
                    nxt += 1
                box.last = await inflight.pop(token)
            w = a._weights[token]
            s = box.times_mixed
            usable = (
                box.last is not None and not box.dropped and s <= self.tau
            )
            if not usable:
                stats.dropped.append(token)
                a._count("async_stale_dropped")
                out = out + w * y
            elif s == 0:
                stats.mixed[token] = 0
                out = out + w * box.last
            else:
                stats.mixed[token] = s
                a._count("async_stale_mixed")
                w_eff = w / (1.0 + s)
                out = out + w_eff * box.last + (w - w_eff) * y
            if usable and s == 0 and box.last_trace is not None:
                a._emit_flow("mix", box.last_trace, f"{token}->{a.token}")
                box.last_trace = None
            box.times_mixed += 1
            stale_pt = float(s if usable else self.tau + 1)
            a._observe("comm.agent.staleness", stale_pt, step=self._round)
            a._observe(
                f"comm.edge.staleness/{token}->{a.token}",
                stale_pt, step=self._round,
            )
        return out

    async def begin_round(self, value: torch.Tensor) -> None:
        """Open an async round: advance the round counter and push the
        value.  Run local compute between ``begin_round`` and
        ``finish_round`` — the wire fills the inbox (buffer B) while the
        device works on buffer A."""
        a = self.agent
        if a.status not in (AgentStatus.READY, AgentStatus.IN_ROUND):
            raise RuntimeError(f"agent not ready (status={a.status})")
        self._round += 1
        self.last_stats = AsyncRoundStats(round=self._round)
        y, self._pub_back = host_value(value)
        self._pub_value, self._pub_round = y, self._round
        a._count("async_rounds")
        await self._push(y)

    async def finish_round(self) -> torch.Tensor:
        """Close the round: deadline-bounded collect, then the
        stale-weighted mix of the published value against the inbox
        (pipelined with the neighbor decodes in ``overlap`` mode)."""
        a = self.agent
        t0 = time.perf_counter()
        await self._collect()
        if self.overlap:
            out = await self._mix_pipelined(self._pub_value)
        else:
            out = self._mix_plain(self._pub_value)
        a._observe(
            "comm.agent.async_round_s",
            time.perf_counter() - t0, step=self._round,
        )
        return self._pub_back(out)

    async def run_async_round(
        self,
        value: torch.Tensor,
        *,
        local: Optional[Callable[[], Any]] = None,
    ) -> torch.Tensor:
        """One full async gossip round; with ``local`` given, the
        callable runs between push and collect — overlapping local
        compute with the wire exchange (its result, if awaitable, is
        awaited and stored on ``self.last_local``)."""
        await self.begin_round(value)
        if local is not None:
            result = local()
            if asyncio.iscoroutine(result) or isinstance(
                result, asyncio.Future
            ):
                result = await result
            self.last_local = result
        return await self.finish_round()

    # ------------------------------------------------------------------ #
    # CHOCO (compressed) async rounds                                    #
    # ------------------------------------------------------------------ #
    def _needs_correction(self, token: str) -> bool:
        box = self._box(token)
        if box.queue or box.dropped:
            return False
        return box.choco_lag >= self.tau if self.tau > 0 else True

    async def _collect_choco(self) -> None:
        a = self.agent
        await self._drain_ready()
        deadline = (
            None if self.deadline_s is None
            else asyncio.get_event_loop().time() + self.deadline_s
        )
        while True:
            required = [
                t for t in self._active() if self._needs_correction(t)
            ]
            if not required:
                return
            timeout = None
            if deadline is not None:
                timeout = deadline - asyncio.get_event_loop().time()
                if timeout <= 0:
                    for t in required:
                        self._box(t).dropped = True
                        a._count("async_deadline_drops")
                        await self._poke(t)
                    return
            if not await self._recv_step(timeout):
                continue

    async def run_async_choco(
        self,
        value: torch.Tensor,
        compressor: Callable[[np.ndarray], np.ndarray],
        *,
        gamma: float = 0.3,
        buckets: Optional[Tuple] = None,
    ) -> torch.Tensor:
        """One asynchronous CHOCO-GOSSIP round: push the compressed
        correction ``q = C(x - x̂_self)``, apply whatever neighbor
        corrections have arrived (exactly once each, in order — the
        replicated-estimate contract), and step the iterate against the
        standing estimates.

        ``tau=0`` blocks for exactly one correction per neighbor per
        round and is bit-identical to the lock-step
        :meth:`~distributed_learning_tpu_torch.comm.agent.ConsensusAgent.
        run_choco_once` sequence; ``tau>0`` lets a straggler's
        correction stream lag up to tau rounds (its backlog is drained
        in one batch when it catches up), and a deadline expiry simply
        proceeds on the standing estimates — a CHOCO round without a
        fresh correction is still exact.

        ``buckets`` (``TreeSpec.dtype_buckets()`` spans) engages the
        fused sparse wire under ``sparse_wire``: the correction ships
        as ONE fused frame per neighbor (``_ASYNC_FUSED``), and an
        arriving fused correction scatter-adds straight onto the
        replicated estimate (``FusedFrame.apply_into``) with no dense
        intermediate — the zero-copy consume path.  All agents of a
        deployment must agree on ``buckets`` (the usual TreeSpec
        deployment invariant).
        """
        a = self.agent
        x, back = a._choco_begin_tensor(value, require_aligned=False)
        self._round += 1
        self.last_stats = AsyncRoundStats(round=self._round)
        a._count("async_choco_rounds")
        q = np.asarray(
            compressor(x - a._choco_hat_self), np.float32
        ).ravel()
        a._int8_active = a.int8_wire
        if buckets is not None and a.sparse_wire:
            a._fused_spans = tuple(buckets)
        try:
            q = a._wire_round(q)
            self._pub_value, self._pub_round = q, self._round
            await self._push(q)
        finally:
            a._int8_active = False
            a._fused_spans = None
        a._choco_hat_self = a._choco_hat_self + q
        for t in a._weights:
            a._choco_hat_nbrs.setdefault(t, np.zeros_like(x))
        await self._collect_choco()
        stats = self.last_stats
        out = x.copy()
        for token in sorted(a._weights):
            box = self._box(token)
            applied = 0
            if box.queue:
                if self.tau == 0:
                    batch = [box.queue.popleft()]
                else:
                    batch = list(box.queue)
                    box.queue.clear()
                if box.choco_applied_gen != a._generation:
                    # New membership generation: the peer's correction
                    # counter legitimately restarts with its round ids.
                    box.choco_applied_gen = a._generation
                    box.choco_applied_round = -1
                for qn, q_round, _, qtrace in batch:
                    if q_round <= box.choco_applied_round:
                        # Replayed correction (a dup, or a poke-answer
                        # re-push of an already-applied round): count
                        # it, never apply — a correction is a delta on
                        # the replicated estimate and must land exactly
                        # once (the choco-replay-apply contract).
                        a._count("async_choco_replay_skipped")
                        stats.skipped += 1
                        self._recycle(token, qn, None)
                        continue
                    box.choco_applied_round = q_round
                    if isinstance(qn, FusedFrame):
                        # Zero-copy consume: the frame's sections
                        # scatter-add straight onto the replicated
                        # estimate (validated at unpack; a CodecError
                        # can no longer happen here).
                        a._apply_fused(qn, a._choco_hat_nbrs[token])
                    else:
                        a._choco_hat_nbrs[token] = a._choco_hat_nbrs[
                            token
                        ] + np.asarray(qn, np.float32).ravel()
                        # The applied correction buffer is dead — back
                        # to the pool for this edge's next frame.
                        self._recycle(token, qn, None)
                    applied += 1
                    if a.trace and qtrace is not None:
                        # Applying the correction is this frame's mix hop.
                        a._emit_flow(
                            "mix", qtrace, f"{token}->{a.token}"
                        )
            if applied:
                box.choco_lag = 0
                box.dropped = False
                stats.applied[token] = applied
                if applied > 1:
                    a._count("async_choco_catchup", applied - 1)
            else:
                # No NEW correction this round (empty queue, or a batch
                # of pure replays): mix against the standing estimates.
                box.choco_lag += 1
                a._count("async_stale_dropped")
                stats.dropped.append(token)
            a._observe(
                "comm.agent.staleness", float(box.choco_lag),
                step=self._round,
            )
            a._observe(
                f"comm.edge.staleness/{token}->{a.token}",
                float(box.choco_lag), step=self._round,
            )
            out += gamma * a._weights[token] * (
                a._choco_hat_nbrs[token] - a._choco_hat_self
            )
        return back(out)
