"""TCP consensus master: control plane for multi-process deployments
(port of ``distributed_learning_tpu/comm/master.py``: the same topology
forming, weights (the port's ``parallel.topology`` and
``parallel.fast_averaging``, equal to the reference's to the bit), round
ids, generations and messages; it never touches a tensor).

Parity: ``utils/consensus_tcp/master.py:21-266`` (``ConsensusMaster``) —
agent registration (:70-97), back-channel neighborhood distribution with
solved mixing weights (:99-126), round lifecycle served off a socket
multiplexer (:128-203), telemetry dispatch (:192-199), shutdown broadcast
(:48-61) — with the recorded defects fixed:

* the round flag is initialized in ``__init__`` (the reference reads
  ``self.running_round`` which is never set, ``master.py:140`` — its round
  path crashes on first use);
* agents' convergence reports are tracked per round id, two-sided (the
  asyncio backend's one-sided ``(y - v) <= eps`` check at
  ``consensus_asyncio.py:297`` is another recorded defect);
* no pickle: framing is the typed binary protocol.

Where the reference opens a *back-connection* to each agent (master.py:
103-104), this master sends the neighborhood over the same registered
control stream — one fewer socket per agent with identical information
flow.

The master never sees gossip values (data plane is agent<->agent), exactly
like the reference.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from distributed_learning_tpu_torch.comm.framing import FramedStream
from distributed_learning_tpu_torch.comm.multiplexer import StreamMultiplexer
from distributed_learning_tpu_torch.comm import protocol as P
from distributed_learning_tpu_torch.obs import (
    FlightRecorder,
    HealthSentinel,
    RunAggregator,
    get_registry,
)
from distributed_learning_tpu_torch.parallel.fast_averaging import solve_fastest_mixing
from distributed_learning_tpu_torch.parallel.topology import Topology
from distributed_learning_tpu_torch.utils.telemetry import TelemetryProcessor

__all__ = ["ConsensusMaster"]




class ConsensusMaster:
    """Serve registration, weight distribution, and round lifecycle."""

    def __init__(
        self,
        topology: Topology | Sequence[Tuple[Hashable, Hashable]],
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        weight_mode: str = "metropolis",
        convergence_eps: float = 1e-4,
        telemetry: Optional[TelemetryProcessor] = None,
        elastic: bool = False,
        regenerate: bool = False,
        debug: bool = False,
        aggregator: Optional[RunAggregator] = None,
        flight: Optional[FlightRecorder] = None,
        sentinel: Optional["HealthSentinel"] = None,
        round_deadline_s: Optional[float] = None,
        enforce_round_deadline: bool = False,
        quarantine_quorum: int = 1,
    ):
        self.topology = (
            topology
            if isinstance(topology, Topology)
            else Topology.from_edges(topology)
        )
        self.host, self.port = host, port
        self.convergence_eps = float(convergence_eps)
        self.telemetry = telemetry
        self.debug = debug
        self.weight_mode = weight_mode
        if weight_mode not in ("metropolis", "sdp"):
            raise ValueError(f"unknown weight_mode {weight_mode!r}")
        self.W = self._solve_weights(self.topology)

        self._tokens = [str(t) for t in self.topology.tokens]
        self._index = {t: i for i, t in enumerate(self._tokens)}
        self._control: Dict[str, FramedStream] = {}
        self._listen_addr: Dict[str, Tuple[str, int]] = {}
        self._server: Optional[asyncio.AbstractServer] = None
        self._mux = StreamMultiplexer()
        self._serve_task: Optional[asyncio.Task] = None
        self._all_registered = asyncio.Event()
        self._stopped = asyncio.Event()

        # Round state — initialized here, unlike the reference (defect:
        # master.py:140 reads an attribute __init__ never sets).
        self._round_running = False
        self._round_id = 0
        self._round_weights: Dict[str, float] = {}
        self._converged: Dict[str, bool] = {}
        # iteration -> tokens that reported Converged AT that iteration.
        # The round ends on the first iteration EVERY participant
        # converged at — ANDing latest-arrival statuses instead (the
        # reference's implied rule) is racy: a transiently-zero
        # residual (symmetric initial values hit them) can leave every
        # agent's LATEST status Converged at different iterations and
        # end the round far from consensus.
        self._conv_at: Dict[int, set] = {}

        # Run-wide observability plane (docs/observability.md §Run-wide
        # plane): the aggregator merges per-agent obs.delta Telemetry
        # payloads; the flight recorder keeps per-agent event rings and
        # dumps a JSONL black box on abort / death / deadline expiry /
        # shutdown-with-reason.  round_deadline_s only OBSERVES (counts
        # + dumps when a round overstays) — deadline-based round
        # *termination* is the async runtime's job, not the plane's.
        self.aggregator = aggregator
        self.flight = flight
        if (aggregator is not None and flight is not None
                and aggregator.flight is None):
            aggregator.flight = flight  # merged events feed the rings
        # Online health sentinel (docs/observability.md §Health
        # sentinel): evaluated against the aggregator's merged registry
        # after every telemetry batch, so a stalled residual, a
        # staleness blow-up, or a wire error storm is detected DURING
        # the run — breaches emit health.* events and trigger
        # reason-tagged flight dumps.  Wired to the shared flight
        # recorder when the caller left the sentinel's own unset.
        self.sentinel = sentinel
        if (sentinel is not None and flight is not None
                and sentinel.flight is None):
            sentinel.flight = flight
        self.round_deadline_s = (
            None if round_deadline_s is None else float(round_deadline_s)
        )
        # Deadline ENFORCEMENT (docs/async_runtime.md §Deadline-enforced
        # rounds): promotes round_deadline_s from observe-only to
        # drop-rather-than-wait.  Formation phase: a round whose quorum
        # is still missing agents when the deadline fires starts WITHOUT
        # them — their edges get zero weight this round (the agents
        # renormalize on device/host, presence_weight_matrix semantics)
        # and their queued requests join the next round.  In-round: an
        # overstaying round is CUT with Done(deadline=True) — agents
        # return their current (partially converged) values.
        self.enforce_round_deadline = bool(enforce_round_deadline)
        if self.enforce_round_deadline and self.round_deadline_s is None:
            raise ValueError(
                "enforce_round_deadline=True needs round_deadline_s"
            )
        self._deadline_handle: Optional[asyncio.TimerHandle] = None
        self._round_participants: set = set()
        # Wall-clock arrival time of each agent's round request: the
        # straggler-attribution signal (the last arrival set the pace).
        self._round_arrivals: Dict[str, float] = {}
        self._round_t0 = 0.0
        self._round_wall_t0 = 0.0

        # Elastic recovery (beyond parity: the reference's only failure
        # handling is the shutdown broadcast, SURVEY.md §5).  With
        # elastic=True a dead agent does not tear the deployment down:
        # its token is marked down, any running round is aborted (Done
        # broadcast — agents keep their current values), and a fresh
        # process may re-register the same token to rejoin.
        #
        # regenerate=True (implies elastic) adds ELASTIC MEMBERSHIP
        # (docs/async_runtime.md §Membership generations): instead of
        # freezing the run until the dead token rejoins, the master
        # re-forms the topology over the LIVE members (induced original
        # edges, bridged back to connectivity if the death cut the
        # graph), re-solves the mixing weights, bumps the membership
        # generation, and broadcasts versioned NeighborhoodData — the
        # survivors keep making progress at N-1, and (re)joining agents
        # realign to the current generation.  Unknown tokens may JOIN a
        # running deployment (register with ConsensusAgent(rejoin=True)
        # so the joiner initiates every peer connection).
        self.regenerate = bool(regenerate)
        self.elastic = bool(elastic) or self.regenerate
        self._generation = 0
        # Original edge list over tokens: each generation's topology is
        # the induced subgraph over live members plus connectivity
        # bridges (new joiners attach via the bridge chain too).
        self._base_edges = [
            (self.topology.tokens[i], self.topology.tokens[j])
            for i, j in self.topology.edges
        ]
        # Tokens that (re)joined in the CURRENT generation: they dial all
        # their neighbors themselves, so everyone else sees port 0.
        self._dialing_in: set = set()
        self._down: set = set()

        # Quarantine bookkeeping (docs/robustness.md §Quarantine): async
        # runners report repeatedly-violating peers via Telemetry
        # payloads of kind QUARANTINE_PAYLOAD_KIND; when quorum DISTINCT
        # accusers agree on a token it is evicted (Shutdown + stream
        # closed), barred from re-registering, and — with regenerate=True
        # — excluded from the next membership generation.  quorum
        # defaults to 1: a single honest detector suffices because the
        # accusation is of objectively-checkable protocol violations, not
        # of value quality; raise it if byzantine agents might accuse
        # honest ones.
        self.quarantine_quorum = max(1, int(quarantine_quorum))
        self._accusations: Dict[str, set] = {}
        self._quarantined: set = set()

        # Observability: named logger + round/telemetry counters (the
        # gossip-round accounting the reference's _debug prints threw
        # away), mirrored into the default obs registry.
        self._log = logging.getLogger("dlt.comm.master")
        if debug:
            from distributed_learning_tpu_torch.utils.profiling import (
                enable_debug_logging,
            )

            enable_debug_logging()
        self.counters: Dict[str, float] = {}

    # ------------------------------------------------------------------ #
    def _debug(self, msg: str, *args):
        """Lazy-formatted debug line on the master's named logger."""
        self._log.debug(msg, *args)

    def _count(self, name: str, value: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + value
        get_registry().inc(f"comm.master.{name}", value)

    def wire_stats(self) -> Dict[str, int]:
        """Whole-frame byte/frame totals over the master's live control
        streams — the control-plane counterpart of
        ``ConsensusAgent.wire_stats()``.  The master never carries gossip
        values, so these totals are pure coordination overhead; the
        fused-wire loopback test pins that per-leaf -> fused data-plane
        framing changes leave them untouched."""
        streams = list(self._control.values())
        return {
            "bytes_sent": sum(s.bytes_sent for s in streams),
            "bytes_received": sum(s.bytes_received for s in streams),
            "frames_sent": sum(s.frames_sent for s in streams),
            "frames_received": sum(s.frames_received for s in streams),
        }

    @property
    def address(self) -> Tuple[str, int]:
        assert self._server is not None, "master not started"
        return self._server.sockets[0].getsockname()[:2]

    @property
    def generation(self) -> int:
        """Current membership generation (0 = the seed deployment)."""
        return self._generation

    # ------------------------------------------------------------------ #
    # Elastic membership: topology/weight regeneration                   #
    # ------------------------------------------------------------------ #
    def _solve_weights(self, topology: Topology) -> np.ndarray:
        if topology.n_agents == 1:
            return np.ones((1, 1), dtype=np.float64)
        if self.weight_mode == "sdp":
            # Fastest-mixing weights (parity: _solve_fastest_convergence,
            # master.py:262-266 -> fast_averaging.py:4-32), re-solved for
            # every membership generation's graph.
            W, _ = solve_fastest_mixing(topology)
            return W
        return topology.metropolis_weights()

    def _form_topology(self, live: List[str]) -> Topology:
        """This generation's graph: the induced subgraph of the original
        topology over the live members, bridged back to connectivity.

        A death can cut the graph (a chain loses its middle) and a
        joiner may have no original edges at all; components are linked
        by a chain of bridges between their smallest tokens, so every
        generation's graph is connected and fastest-mixing weights
        exist."""
        live_set = set(live)
        edges = [
            (u, v) for (u, v) in self._base_edges
            if u in live_set and v in live_set
        ]
        if len(live) == 1:
            return Topology(n_agents=1, edges=(), tokens=(live[0],))
        # Union-find over live tokens to find components.
        parent = {t: t for t in live}

        def find(t):
            while parent[t] != t:
                parent[t] = parent[parent[t]]
                t = parent[t]
            return t

        for u, v in edges:
            parent[find(u)] = find(v)
        reps = sorted({find(t) for t in live})
        if len(reps) > 1:
            comps = {r: [] for r in reps}
            for t in live:
                comps[find(t)].append(t)
            anchors = [min(comps[r]) for r in reps]
            bridges = list(zip(anchors, anchors[1:]))
            edges.extend(bridges)
            self._debug("topology bridges added: %s", bridges)
        return Topology.from_edges(sorted(edges))

    async def _regenerate(self, cause: str, token: str) -> None:
        """Re-form the topology over the live membership, re-solve W,
        bump the generation, and broadcast versioned NeighborhoodData to
        every live agent (docs/async_runtime.md §Membership
        generations)."""
        live = sorted(self._control)
        if not live:
            return
        self._generation += 1
        self._dialing_in = {token} if cause != "death" else set()
        self.topology = self._form_topology(live)
        # Generation order follows the regenerated topology's token
        # order so W rows index consistently.
        self._tokens = [str(t) for t in self.topology.tokens]
        self._index = {t: i for i, t in enumerate(self._tokens)}
        self.W = self._solve_weights(self.topology)
        self._count("generations")
        self._debug(
            "membership generation %s (%s %s): members=%s",
            self._generation, cause, token, self._tokens,
        )
        if self.flight is not None:
            self.flight.note(
                "<master>", "generation", generation=self._generation,
                cause=cause, token=token, members=list(self._tokens),
            )
        for t in self._tokens:
            await self._send_neighborhood(t)

    async def start(self) -> Tuple[str, int]:
        """Start listening and serving; returns the bound (host, port)."""
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        self._serve_task = asyncio.create_task(self._serve())
        return self.address

    async def _handle_connection(self, reader, writer):
        stream = FramedStream(reader, writer)
        try:
            msg = await stream.recv()
        except (ConnectionError, asyncio.IncompleteReadError):
            stream.close()
            return
        if not isinstance(msg, P.Register):
            await stream.send(P.ErrorException(message="expected Register"))
            stream.close()
            return
        token = msg.token
        if token in self._quarantined:
            # A quarantined token stays out until an operator clears it:
            # letting it re-register would hand the violator a fresh
            # violation budget every time it reconnects.
            self._count("quarantine_rejections")
            await stream.send(
                P.ErrorException(message=f"token {token!r} is quarantined")
            )
            stream.close()
            return
        joining = False
        if token not in self._index:
            # Elastic membership: an unknown token may JOIN a running
            # deployment (the next generation's topology attaches it).
            # Pre-initialization the member set is the constructor's.
            if not (self.regenerate and self._all_registered.is_set()):
                await stream.send(
                    P.ErrorException(message=f"unknown agent token {token!r}")
                )
                stream.close()
                return
            joining = True
        if token in self._control:
            await stream.send(
                P.ErrorException(message=f"token {token!r} already registered")
            )
            stream.close()
            return
        # A token that died BEFORE the deployment initialized re-registers
        # as a plain registration (its neighbors have no stale streams yet);
        # after initialization it is a rejoin.
        rejoining = (
            self.elastic
            and token in self._down
            and self._all_registered.is_set()
        )
        self._down.discard(token)
        self._control[token] = stream
        self._listen_addr[token] = (msg.host, msg.port)
        self._count("registrations")
        if self.flight is not None:
            self.flight.note(
                "<master>",
                "joined" if joining else (
                    "rejoined" if rejoining else "registered"
                ),
                token=token,
            )
        self._debug("registered %s @ %s:%s", token, msg.host, msg.port)
        await stream.send(
            P.Ok(
                info="joined" if joining else (
                    "rejoined" if rejoining else "registered"
                )
            )
        )
        # Into the mux immediately: deaths are then observable in every
        # phase, including the registration window, and the serve loop's
        # parked wait is woken for the new stream (elastic rejoin would
        # otherwise leave its round request unread until unrelated traffic
        # arrived).
        self._mux.add(token, stream)
        if (joining or rejoining) and self.regenerate:
            # Elastic membership: the member set changed — re-form the
            # topology, re-solve W, bump the generation, broadcast the
            # new epoch to EVERY live agent (the (re)joiner included).
            await self._regenerate(
                "join" if joining else "rejoin", token
            )
            self._count("rejoins" if rejoining else "joins")
            await self._maybe_start_round()
            return
        if rejoining:
            # Resend this agent's neighborhood; the rejoiner initiates all
            # its peer connections itself, so nobody else needs its new
            # address.
            await self._send_neighborhood(token)
            self._count("rejoins")
            self._debug("%s rejoined", token)
            return
        if len(self._control) == len(self._tokens):
            await self._initialize_agents()
            self._all_registered.set()

    async def _send_neighborhood(self, token: str) -> None:
        stream = self._control.get(token)
        if stream is None:
            # Agent died while initialization was in flight (the serve loop
            # pops dead tokens concurrently — it runs from startup, not from
            # all-registered).  Its rejoin re-requests the neighborhood, so
            # skipping here is safe; raising would kill the registration
            # handler and wedge the deployment.
            self._debug("skip neighborhood for %s: not connected", token)
            return
        i = self._index[token]
        nbs: List[P.Neighbor] = []
        for j in self.topology.neighbors(i):
            nb_token = self._tokens[j]
            host, port = self._listen_addr[nb_token]
            if nb_token in self._down or (
                nb_token in self._dialing_in and nb_token != token
            ):
                # Currently-down neighbor: its recorded address is stale.
                # port 0 tells a rejoiner not to dial — the neighbor's own
                # replacement will dial in when it re-registers.  This
                # generation's fresh (re)joiner is flagged the same way:
                # it initiates every one of its peer connections itself.
                host, port = "", 0
            nbs.append(
                P.Neighbor(
                    token=nb_token, host=host, port=port,
                    weight=float(self.W[i, j]),
                )
            )
        try:
            await stream.send(
                P.NeighborhoodData(
                    self_weight=float(self.W[i, i]),
                    convergence_eps=self.convergence_eps,
                    neighbors=nbs,
                    generation=self._generation,
                )
            )
        except (ConnectionError, OSError) as exc:
            # The death itself surfaces through the mux sentinel; here we
            # only keep the caller (registration handler or init loop) alive.
            self._debug("neighborhood send to %s failed: %s", token, exc)

    async def _initialize_agents(self) -> None:
        """Send every agent its neighborhood + mixing weights (parity:
        ``_initialize_agents`` + ``get_neighborhood_info_for_agent``,
        master.py:99-126, 227-243)."""
        for token in self._tokens:
            await self._send_neighborhood(token)
        self._debug("all agents initialized")

    # ------------------------------------------------------------------ #
    async def _serve(self) -> None:
        """Round lifecycle loop (parity: ``_serve``, master.py:128-203).

        Runs from startup (not from all-registered): control streams join
        the multiplexer at registration, so agent deaths are detected in
        every phase — the mux parks while the stream set is empty.
        """
        try:
            async for token, msg, _stream in self._mux:
                if msg is None:
                    if self.elastic:
                        # Agent died: mark it down, abort any running round
                        # (Done: agents keep their current values and may
                        # retry), keep serving so the token can rejoin.
                        dead = self._control.pop(token, None)
                        if dead is not None:
                            # Close our half of the accepted connection, or
                            # Server.wait_closed() (3.12+: waits for accepted
                            # conns) would hang at shutdown.
                            dead.close()
                        self._down.add(token)
                        self._round_weights.pop(token, None)
                        self._round_arrivals.pop(token, None)
                        aborted_round = None
                        if self._round_running:
                            self._round_running = False
                            self._cancel_deadline()
                            self._count("rounds_aborted")
                            aborted_round = self._round_id
                            await self._broadcast_round(
                                P.Done(round_id=self._round_id, aborted=True)
                            )
                            self._debug(
                                "round %s aborted: %s died",
                                self._round_id, token,
                            )
                        self._count("agents_down")
                        if self.flight is not None:
                            # One black box per fault: the abort dump
                            # subsumes the death that caused it.
                            self.flight.note(
                                "<master>", "agent_down", token=token,
                                round_id=aborted_round,
                            )
                            if aborted_round is not None:
                                self._flight_dump(
                                    "round_aborted",
                                    round_id=aborted_round, token=token,
                                )
                            else:
                                self._flight_dump("agent_down", token=token)
                        if self.regenerate and self._all_registered.is_set():
                            # Elastic membership: survivors keep going at
                            # N-1 under a fresh (topology, W) generation
                            # instead of stalling until the token rejoins.
                            await self._regenerate("death", token)
                            await self._maybe_start_round()
                        self._debug("agent %s down; awaiting rejoin", token)
                        continue
                    # Control connection lost.  No recovery protocol exists
                    # in non-elastic mode (parity: reference master's only
                    # failure handling is the shutdown broadcast): tear the
                    # deployment down.
                    raise RuntimeError(f"agent {token} disconnected")
                if isinstance(msg, P.NewRoundRequest):
                    await self._on_round_request(token, msg)
                elif isinstance(msg, (P.Converged, P.NotConverged)):
                    await self._on_status(token, msg)
                elif isinstance(msg, P.Telemetry):
                    self._count("telemetry_payloads")
                    if self._is_quarantine_report(msg.payload):
                        await self._on_quarantine_report(
                            msg.token or token, msg.payload
                        )
                    if self.aggregator is not None:
                        # The run-wide plane: obs.delta payloads merge
                        # into the run registry (+ flight rings); other
                        # payloads are recorded as plain telemetry.
                        self.aggregator.process(
                            msg.token or token, msg.payload
                        )
                        if self.sentinel is not None:
                            # Never-fatal, like _flight_dump: the health
                            # plane must not crash the control plane.
                            try:
                                self.sentinel.evaluate()
                            except Exception as exc:  # pragma: no cover
                                self._debug(
                                    "sentinel evaluate failed: %r", exc
                                )
                    if self.telemetry is not None:
                        self.telemetry.process(msg.token or token, msg.payload)
                elif isinstance(msg, P.ErrorException):
                    raise RuntimeError(f"agent {token}: {msg.message}")
                else:
                    self._debug(
                        "ignoring %s from %s", type(msg).__name__, token
                    )
        except asyncio.CancelledError:
            pass
        except Exception as e:  # parity: shutdown broadcast on master error
            self._debug("error: %r; broadcasting shutdown", e)
            if self.flight is not None:
                self._flight_dump("master_error", error=repr(e))
            await self._broadcast(P.Shutdown(reason=repr(e)))
        finally:
            self._stopped.set()

    # ------------------------------------------------------------------ #
    # Quarantine (docs/robustness.md §Quarantine)                        #
    # ------------------------------------------------------------------ #
    @staticmethod
    def _is_quarantine_report(payload) -> bool:
        from distributed_learning_tpu_torch.comm.async_runtime import (
            QUARANTINE_PAYLOAD_KIND,
        )

        return (
            isinstance(payload, dict)
            and payload.get("kind") == QUARANTINE_PAYLOAD_KIND
        )

    async def _on_quarantine_report(self, accuser: str, payload) -> None:
        """One runner's quarantine report: tally the DISTINCT accusers of
        the accused token; at quorum, evict it (Shutdown, stream closed,
        registration barred) and — under elastic membership — regenerate
        the topology without it."""
        accused = str(payload.get("accused", ""))
        self._count("quarantine_reports")
        if not accused or accused == accuser:
            return  # malformed or self-accusation: recorded, not acted on
        if self.flight is not None:
            self.flight.note(
                "<master>", "quarantine_report",
                accuser=accuser, accused=accused,
                violations=payload.get("violations"),
            )
        accusers = self._accusations.setdefault(accused, set())
        accusers.add(accuser)
        if accused in self._quarantined:
            return
        if len(accusers) < self.quarantine_quorum:
            return
        self._quarantined.add(accused)
        self._count("agents_quarantined")
        self._debug(
            "quarantining %s (accused by %s)", accused, sorted(accusers)
        )
        # The black box records the detection even when the accused is
        # not currently connected (it may be mid-rejoin).
        self._flight_dump(
            "quarantine", token=accused, accusers=sorted(accusers),
            violations=payload.get("violations"),
        )
        stream = self._control.pop(accused, None)
        self._mux.remove(accused)
        self._down.discard(accused)  # not coming back: barred below
        self._round_weights.pop(accused, None)
        self._round_arrivals.pop(accused, None)
        if stream is not None:
            try:
                await stream.send(P.Shutdown(reason="quarantined"))
            except (ConnectionError, OSError):
                pass
            stream.close()
        if self._round_running:
            self._round_running = False
            self._cancel_deadline()
            self._count("rounds_aborted")
            await self._broadcast_round(
                P.Done(round_id=self._round_id, aborted=True)
            )
        if self.regenerate and self._all_registered.is_set():
            await self._regenerate("quarantine", accused)
            await self._maybe_start_round()

    def _flight_dump(self, reason: str, **context) -> None:
        """Trigger a flight-recorder dump (counted, never fatal — the
        black box must not be able to crash the plane it records)."""
        if self.flight is None:
            return
        try:
            path = self.flight.trigger(reason, **context)
            self._count("flight_dumps")
            self._debug("flight recorder dumped %s (%s)", path, reason)
        except OSError as exc:  # pragma: no cover - disk-full etc.
            self._debug("flight dump failed: %s", exc)

    def _cancel_deadline(self) -> None:
        if self._deadline_handle is not None:
            self._deadline_handle.cancel()
            self._deadline_handle = None

    def _on_round_deadline(self, round_id: int) -> None:
        """call_later callback: the round overstayed round_deadline_s.

        Observe-only by default — the lock-step protocol keeps waiting;
        the count and the dump make the stall diagnosable instead of
        silent.  With ``enforce_round_deadline`` the round is CUT:
        Done(deadline=True) goes to the participants, who return their
        current (partially converged) values — drop rather than wait."""
        self._deadline_handle = None
        if self._round_running and self._round_id == round_id:
            self._count("round_deadlines_expired")
            missing = sorted(
                t for t, ok in self._converged.items() if not ok
            )
            self._flight_dump(
                "round_deadline", round_id=round_id,
                deadline_s=self.round_deadline_s, waiting_on=missing,
            )
            if self.enforce_round_deadline:
                asyncio.ensure_future(self._deadline_cut(round_id))

    async def _deadline_cut(self, round_id: int) -> None:
        if not (self._round_running and self._round_id == round_id):
            return
        self._round_running = False
        self._count("rounds_deadline_cut")
        if self.aggregator is not None:
            self.aggregator.note_round_done(
                round_id,
                time.perf_counter() - self._round_t0,
                wall_t0=self._round_wall_t0,
            )
        await self._broadcast_round(P.Done(round_id=round_id, deadline=True))
        self._debug("round %s cut at the deadline", round_id)
        await self._maybe_start_round()

    def _on_formation_deadline(self) -> None:
        """call_later callback of the drop-rather-than-wait FORMATION
        deadline: the quorum has been incomplete for round_deadline_s —
        start the round with whoever showed up; the missing agents' edges
        get zero weight this round (NewRoundNotification.dropped) and
        their late requests queue for the next round."""
        self._deadline_handle = None
        if self._round_running or not self._round_weights:
            return
        asyncio.ensure_future(self._formation_deadline_start())

    async def _formation_deadline_start(self) -> None:
        if self._round_running:
            return
        present = sorted(
            t for t in self._round_weights
            if t in self._index and t in self._control
        )
        if not present:
            return
        self._count("round_formation_deadlines")
        if self.flight is not None:
            self.flight.note(
                "<master>", "formation_deadline",
                waiting_on=sorted(set(self._tokens) - set(present)),
            )
        await self._start_round(present)

    async def _on_round_request(self, token: str, msg: P.NewRoundRequest):
        if self._round_running:
            if self.enforce_round_deadline:
                # Drop-rather-than-wait: a straggler that missed this
                # round queues for the next one instead of erroring the
                # deployment.
                self._round_weights[token] = msg.weight
                self._round_arrivals[token] = time.time()
                self._count("round_requests_deferred")
                return
            # Parity intent of the "round already running" guard
            # (master.py:140-144), minus the crash.
            await self._control[token].send(
                P.ErrorException(message="round already running")
            )
            return
        self._round_weights[token] = msg.weight
        # Straggler signal: who kept the round waiting.  Wall clock on
        # purpose — arrivals are compared against agent-side wall
        # anchors on the merged timeline.
        self._round_arrivals[token] = time.time()
        await self._maybe_start_round()

    async def _maybe_start_round(self) -> None:
        """Start a round if the pending quorum allows it: complete quorum
        starts immediately; with deadline enforcement an incomplete one
        arms the formation deadline."""
        if self._round_running:
            return
        # Requests from members a later generation removed (death, or a
        # regenerated topology) no longer count toward any quorum.
        for t in list(self._round_weights):
            if t not in self._index or t not in self._control:
                self._round_weights.pop(t, None)
                self._round_arrivals.pop(t, None)
        if not self._round_weights:
            return
        if len(self._round_weights) == len(self._tokens):
            self._cancel_deadline()
            await self._start_round(sorted(self._round_weights))
        elif (
            self.enforce_round_deadline and self._deadline_handle is None
        ):
            self._deadline_handle = asyncio.get_event_loop().call_later(
                self.round_deadline_s, self._on_formation_deadline
            )

    async def _start_round(self, participants: List[str]) -> None:
        self._round_id += 1
        self._round_running = True
        self._round_participants = set(participants)
        dropped = sorted(set(self._tokens) - self._round_participants)
        self._converged = {t: False for t in participants}
        self._conv_at = {}
        mean_w = float(
            np.mean([self._round_weights[t] for t in participants])
        )
        arrivals = {
            t: self._round_arrivals.pop(t)
            for t in participants if t in self._round_arrivals
        }
        for t in participants:
            self._round_weights.pop(t, None)
        self._count("rounds_started")
        if dropped:
            self._count("round_agents_dropped", len(dropped))
        self._round_wall_t0 = time.time()
        self._round_t0 = time.perf_counter()
        if self.aggregator is not None:
            self.aggregator.note_round_arrivals(self._round_id, arrivals)
        if self.round_deadline_s:
            self._cancel_deadline()
            self._deadline_handle = (
                asyncio.get_event_loop().call_later(
                    self.round_deadline_s,
                    self._on_round_deadline, self._round_id,
                )
            )
        await self._broadcast_round(
            P.NewRoundNotification(
                round_id=self._round_id, mean_weight=mean_w,
                generation=self._generation, dropped=dropped,
            )
        )
        self._debug(
            "round %s started, mean_w=%s%s", self._round_id, mean_w,
            f", dropped={dropped}" if dropped else "",
        )

    async def _on_status(self, token: str, msg):
        if msg.round_id != self._round_id or not self._round_running:
            return  # stale report from a finished round
        if token not in self._converged:
            return  # not a participant of this round
        # Latest-status view: the deadline dump's "waiting_on" picture.
        self._converged[token] = isinstance(msg, P.Converged)
        if isinstance(msg, P.Converged):
            at = self._conv_at.setdefault(msg.iteration, set())
            at.add(token)
        # Done iff some single iteration saw EVERY participant converge
        # (once truly converged, agents report Converged every
        # iteration, so the first common iteration always arrives).
        if isinstance(msg, P.Converged) and (
            self._conv_at[msg.iteration] >= self._round_participants
        ):
            self._round_running = False
            self._cancel_deadline()
            self._count("rounds_done")
            if self.aggregator is not None:
                self.aggregator.note_round_done(
                    self._round_id,
                    time.perf_counter() - self._round_t0,
                    wall_t0=self._round_wall_t0,
                )
            await self._broadcast_round(P.Done(round_id=self._round_id))
            self._debug("round %s done", self._round_id)
            await self._maybe_start_round()

    async def _broadcast(self, msg) -> None:
        for token, stream in list(self._control.items()):
            try:
                await stream.send(msg)
            except (ConnectionError, OSError):
                self._debug("broadcast to %s failed", token)

    async def _broadcast_round(self, msg) -> None:
        """Round-lifecycle broadcast: participants only — an agent
        dropped from the round must not mistake its notifications/Done
        for a round it will join later."""
        for token in sorted(self._round_participants):
            stream = self._control.get(token)
            if stream is None:
                continue
            try:
                await stream.send(msg)
            except (ConnectionError, OSError):
                self._debug("round broadcast to %s failed", token)

    # ------------------------------------------------------------------ #
    async def shutdown(self, reason: str = "") -> None:
        """Broadcast shutdown and stop (parity: master.py:48-61).  A
        shutdown WITH a reason is a fault path — it ships its black
        box."""
        self._cancel_deadline()
        if reason:
            self._flight_dump("shutdown", detail=reason)
        await self._broadcast(P.Shutdown(reason=reason))
        if self._serve_task is not None:
            self._serve_task.cancel()
            try:
                await self._serve_task
            except asyncio.CancelledError:
                pass
        self._mux.close()
        # Close accepted control streams BEFORE wait_closed: since 3.12,
        # Server.wait_closed also waits for accepted connections to drop.
        for stream in self._control.values():
            stream.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def wait_all_registered(self, timeout: float = 30.0) -> None:
        await asyncio.wait_for(self._all_registered.wait(), timeout)
