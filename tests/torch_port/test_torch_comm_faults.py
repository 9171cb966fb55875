"""Deterministic fault injection of the port (``comm/faults.py``) + the
wire defenses it drives end-to-end: a mirror of ``tests/test_faults.py``
with torch tensors as the runners' values, plus the cross checks against
the JAX package: the same seed gives the reference's decision stream,
byte mutations, faulty frames and retry-jitter sequence.  Each asyncio
test runs under its own ``asyncio.wait_for`` limit (20 s at most).

Three claims pinned here:

* **Determinism** — a :class:`FaultPlan` is a pure function of
  ``(seed, frame index)``: the same seed replays the identical fault
  schedule, in any evaluation order.
* **Layered rejection** — every injected corruption is rejected BEFORE
  any payload reaches a consumer: post-crc byte flips fail the frame
  checksum (``FrameError``, stream evicted), pre-crc truncation arrives
  checksum-clean and fails the codec's validate-before-scatter checks
  (``CodecError``, frame dropped + counted, stream KEPT — the framing
  consumed the body before decode, so alignment survives).
* **Detection** — protocol-field lies (byzantine mutation) trip the
  async runtime's wire validation: repeat offenders are quarantined by
  their neighbors, the master tallies accusations, evicts the peer, and
  regenerates the topology without it (counters + flight dump recorded).

Also here: the FramedStream adversarial-retry satellite — injected
transient errnos drive the send-retry loop (``comm.agent.retries``),
and a rejoin after death drives ``comm.agent.reconnects``.
"""

import asyncio
import errno
import glob
import os

import numpy as np
import pytest
import torch

from distributed_learning_tpu.comm import faults as r_faults
from distributed_learning_tpu.comm import framing as r_framing
from distributed_learning_tpu.comm import protocol as r_P
from distributed_learning_tpu_torch.comm import (
    AsyncGossipRunner,
    ConsensusAgent,
    ConsensusMaster,
    FaultPlan,
    FaultyStream,
    inject_neighbor_faults,
    lying_fields_mutator,
    poison_value_mutator,
)
from distributed_learning_tpu_torch.comm import protocol as P
from distributed_learning_tpu_torch.comm.framing import (
    FramedStream,
    FrameError,
    FrameTimeout,
)
from distributed_learning_tpu_torch.comm.multiplexer import StreamMultiplexer
from distributed_learning_tpu_torch.comm.tensor_codec import CodecError
from distributed_learning_tpu_torch.obs import (
    FlightRecorder,
    MetricsRegistry,
    use_registry,
)

TRIANGLE = [("A", "B"), ("B", "C"), ("C", "A")]


# --------------------------------------------------------------------- #
# FaultPlan: seeded, replayable schedule                                #
# --------------------------------------------------------------------- #
def test_fault_plan_schedule_is_seed_deterministic():
    kw = dict(
        drop_p=0.1, corrupt_p=0.1, truncate_p=0.1, dup_p=0.1,
        reorder_p=0.1, byzantine_p=0.1, delay_p=0.3, delay_max_s=0.01,
    )
    a = FaultPlan(42, **kw).schedule(300)
    b = FaultPlan(42, **kw).schedule(300)
    assert a == b  # identical replay across plan instances
    # Order independence: decide(i) out of order matches the schedule.
    plan = FaultPlan(42, **kw)
    for i in (250, 3, 77, 0, 299):
        assert plan.decide(i) == a[i]
    # A different seed deals a different schedule.
    c = FaultPlan(43, **kw).schedule(300)
    assert a != c
    # Every kind actually occurs at these rates over 300 frames.
    kinds = {d.kind for d in a}
    assert {"drop", "corrupt", "truncate", "dup", "reorder",
            "byzantine"} <= kinds
    assert any(d.delay_s > 0 for d in a)
    # Deterministic byte mutations too.
    body = bytes(range(64))
    assert plan.corrupt_bytes(5, body) == plan.corrupt_bytes(5, body)
    assert plan.truncate_bytes(5, body) == plan.truncate_bytes(5, body)
    assert plan.corrupt_bytes(5, body) != body
    assert 1 <= len(plan.truncate_bytes(5, body)) < len(body)


def test_fault_plan_validates_probabilities():
    with pytest.raises(ValueError, match="must be in"):
        FaultPlan(0, drop_p=1.5)
    with pytest.raises(ValueError, match="sum"):
        FaultPlan(0, drop_p=0.6, corrupt_p=0.6)
    with pytest.raises(ValueError, match="delay_p"):
        FaultPlan(0, delay_p=-0.1)


def test_fault_plan_crash_at_overrides():
    plan = FaultPlan(0, drop_p=0.5, crash_at=3)
    sched = plan.schedule(6)
    assert all(d.kind != "crash" for d in sched[:3])
    assert all(d.kind == "crash" for d in sched[3:])


def test_byzantine_mutators():
    val = P.AsyncValue(
        round_id=7, staleness=1, value=np.ones(4, np.float32)
    )
    # Field lies rotate through the three violation arms.
    assert lying_fields_mutator(0, val).round_id == 2 ** 40
    assert lying_fields_mutator(1, val).round_id == -1
    assert lying_fields_mutator(2, val).staleness == -7
    ok = P.Ok()
    assert lying_fields_mutator(0, ok) is ok  # non-AsyncValue untouched
    # Value poison keeps fields legal but scales the payload.
    poisoned = poison_value_mutator(scale=100.0)(0, val)
    assert poisoned.round_id == 7 and poisoned.staleness == 1
    np.testing.assert_array_equal(
        np.asarray(poisoned.value), np.full(4, 100.0, np.float32)
    )


# --------------------------------------------------------------------- #
# Wire loopback: the two rejection layers + delivery faults             #
# --------------------------------------------------------------------- #
async def _tcp_pair():
    server_streams = []

    async def on_conn(reader, writer):
        server_streams.append(FramedStream(reader, writer))

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    client = FramedStream(reader, writer)
    while not server_streams:  # the server's side of the connection
        await asyncio.sleep(0.001)
    (srv,) = server_streams
    return server, client, srv


def test_corrupt_fails_crc_truncate_fails_codec_stream_survives():
    async def main():
        # Post-crc byte flip -> FrameError (a ConnectionError).
        server, client, srv = await _tcp_pair()
        faulty = FaultPlan(0, corrupt_p=1.0).wrap(client)
        await faulty.send(P.Telemetry(token="t", payload={"k": 1}))
        with pytest.raises(FrameError):
            await srv.recv(timeout=5.0)
        assert faulty.counters == {"corrupt": 1}
        client.close(); srv.close(); server.close()

        # Pre-crc truncation -> checksum-clean frame, CodecError at
        # decode — and the stream stays ALIGNED: the next clean frame
        # (sent via the unwrapped inner stream) arrives intact.
        server, client, srv = await _tcp_pair()
        faulty = FaultPlan(1, truncate_p=1.0).wrap(client)
        await faulty.send(
            P.AsyncValue(round_id=1, staleness=0,
                         value=np.arange(8, dtype=np.float32))
        )
        with pytest.raises(CodecError):
            await srv.recv(timeout=5.0)
        await faulty.inner.send(P.Telemetry(token="t", payload={"k": 2}))
        msg = await srv.recv(timeout=5.0)
        assert isinstance(msg, P.Telemetry) and msg.payload == {"k": 2}
        client.close(); srv.close(); server.close()
        await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 20))


def test_multiplexer_counts_codec_rejection_and_keeps_stream():
    """The service-point contract: a truncated (checksum-clean) frame is
    dropped with ``comm.frames_rejected`` bumped, and the SAME stream's
    next frame is still delivered — no eviction, no desync."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            server, client, srv = await _tcp_pair()
            mux = StreamMultiplexer({"peer": srv})
            faulty = FaultPlan(2, truncate_p=1.0).wrap(client)
            await faulty.send(
                P.AsyncValue(round_id=1, staleness=0,
                             value=np.arange(32, dtype=np.float32))
            )
            await faulty.inner.send(
                P.Telemetry(token="t", payload={"ok": True})
            )
            token, msg, stream = await asyncio.wait_for(
                mux.__anext__(), 10.0
            )
            # The rejected frame was consumed silently; the first YIELD
            # is the clean follow-up on the still-registered stream.
            assert token == "peer" and isinstance(msg, P.Telemetry)
            assert reg.counters.get("comm.frames_rejected") == 1
            assert "peer" in mux.tokens()
            mux.close()
            client.close(); srv.close(); server.close()
            await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 20))


def test_drop_dup_reorder_delivery_semantics():
    async def main():
        # Drop: nothing arrives (FrameTimeout, stream usable after).
        server, client, srv = await _tcp_pair()
        faulty = FaultPlan(3, drop_p=1.0).wrap(client)
        await faulty.send(P.Ok(info="gone"))
        with pytest.raises(FrameTimeout):
            await srv.recv(timeout=0.1)
        await faulty.inner.send(P.Ok(info="kept"))
        assert (await srv.recv(timeout=5.0)).info == "kept"
        client.close(); srv.close(); server.close()

        # Dup: one send, two identical frames.
        server, client, srv = await _tcp_pair()
        faulty = FaultPlan(4, dup_p=1.0).wrap(client)
        await faulty.send(P.Ok(info="twice"))
        first = await srv.recv(timeout=5.0)
        second = await srv.recv(timeout=5.0)
        assert first.info == second.info == "twice"
        client.close(); srv.close(); server.close()

        # Reorder: frame 0 held, frame 1 jumps the queue.
        server, client, srv = await _tcp_pair()
        faulty = FaultPlan(5, reorder_p=1.0).wrap(client)
        await faulty.send(P.Ok(info="first"))
        await faulty.send(P.Ok(info="second"))
        assert (await srv.recv(timeout=5.0)).info == "second"
        assert (await srv.recv(timeout=5.0)).info == "first"
        client.close(); srv.close(); server.close()
        await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 20))


def test_fault_decisions_emit_attributed_registry_events():
    """Every injected-fault decision lands in the
    registry as a ``comm.fault`` event carrying (kind, peer, frame
    index, round) plus the per-edge fault counter — so the per-edge
    observatory and the flight ring can attribute injected chaos."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            server, client, srv = await _tcp_pair()
            faulty = FaultPlan(0, corrupt_p=1.0).wrap(
                client, peer="B", edge="A->B"
            )
            await faulty.send(
                P.AsyncValue(round_id=9, staleness=0,
                             value=np.ones(4, np.float32))
            )
            with pytest.raises(FrameError):
                await srv.recv(timeout=5.0)
            client.close(); srv.close(); server.close()
            await server.wait_closed()

        (ev,) = [e for e in reg.recent_events()
                 if e.get("name") == "comm.fault"]
        assert ev["fault"] == "corrupt"
        assert ev["peer"] == "B"
        assert ev["frame_index"] == 0
        assert ev["round"] == 9
        assert ev["edge"] == "A->B"
        # Bare + per-edge counters both tick.
        assert reg.counters["comm.faults.corrupt"] == 1
        assert reg.counters["comm.faults.corrupt/A->B"] == 1

    asyncio.run(asyncio.wait_for(main(), 20))


def test_inject_neighbor_faults_labels_the_directed_edge():
    """``inject_neighbor_faults`` wires peer/edge attribution from the
    agent's own token — the deployed-path guarantee the loopback
    quarantine test's counters build on."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            master = ConsensusMaster(TRIANGLE, convergence_eps=1e-7)
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port) for t in "ABC"}
            await asyncio.gather(*(a.start() for a in agents.values()))

            wrapped = inject_neighbor_faults(
                agents["A"], "B", FaultPlan(1, drop_p=1.0)
            )
            assert wrapped.peer == "B" and wrapped.edge == "A->B"
            await agents["A"]._neighbors["B"].send(
                P.AsyncValue(round_id=3, staleness=0,
                             value=np.zeros(2, np.float32))
            )
            (ev,) = [e for e in reg.recent_events()
                     if e.get("name") == "comm.fault"]
            assert ev["fault"] == "drop" and ev["edge"] == "A->B"
            assert ev["peer"] == "B" and ev["round"] == 3
            assert reg.counters["comm.faults.drop/A->B"] == 1

            await master.shutdown()
            for a in agents.values():
                await a.close(drain=0.1)

    asyncio.run(asyncio.wait_for(main(), 20))


def test_crash_tears_down_transport_abruptly():
    async def main():
        server, client, srv = await _tcp_pair()
        faulty = FaultPlan(6, crash_at=0).wrap(client)
        with pytest.raises(ConnectionResetError):
            await faulty.send(P.Ok())
        with pytest.raises((ConnectionError, asyncio.IncompleteReadError)):
            await srv.recv(timeout=5.0)
        srv.close(); server.close()
        await server.wait_closed()

    asyncio.run(asyncio.wait_for(main(), 20))


# --------------------------------------------------------------------- #
# FramedStream adversarial retry / reconnect counters                   #
# --------------------------------------------------------------------- #
def test_agent_stream_retries_under_injected_transient_errnos():
    """Transient errnos injected into a DEPLOYED agent's neighbor
    stream drive the send-retry loop and land in the agent's counter
    (``comm.agent.retries``), and the push still completes."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            master = ConsensusMaster(TRIANGLE, convergence_eps=1e-7)
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port) for t in "ABC"}
            await asyncio.gather(*(a.start() for a in agents.values()))

            stream = agents["A"]._neighbors["B"]
            real_drain = stream.writer.drain
            failures = [2]

            async def flaky_drain():
                if failures[0] > 0:
                    failures[0] -= 1
                    raise OSError(errno.EAGAIN, "injected")
                await real_drain()

            stream.writer.drain = flaky_drain
            before = agents["A"].counters.get("retries", 0)
            await stream.send(P.Ok(info="through"))
            assert agents["A"].counters.get("retries", 0) - before == 2
            assert reg.counters.get("comm.agent.retries", 0) >= 2
            assert failures[0] == 0  # retried exactly past the faults

            await master.shutdown()
            for a in agents.values():
                await a.close(drain=0.1)

    asyncio.run(asyncio.wait_for(main(), 20))


def test_retry_backoff_jitter_is_seed_deterministic():
    """The send-retry backoff jitter is a pure function of
    ``(retry_seed, attempt)`` — the FaultPlan counter-keyed rng idiom:
    same seed replays the identical backoff schedule (in any call
    order), different seeds decorrelate, and ``retry_jitter_frac=0``
    keeps the exact legacy powers-of-two schedule."""

    async def main():
        def stream(**kw):
            return FramedStream(
                asyncio.StreamReader(), writer=None, send_retries=3,
                retry_base_s=0.02, **kw,
            )

        legacy = stream()
        assert [legacy._retry_delay_s(k) for k in range(4)] == [
            0.02, 0.04, 0.08, 0.16
        ]

        a = stream(retry_jitter_frac=0.5, retry_seed=11)
        b = stream(retry_jitter_frac=0.5, retry_seed=11)
        c = stream(retry_jitter_frac=0.5, retry_seed=12)
        sched_a = [a._retry_delay_s(k) for k in range(4)]
        # Evaluation order must not matter (counter-keyed, no shared rng).
        sched_b = [b._retry_delay_s(k) for k in reversed(range(4))][::-1]
        assert sched_a == sched_b
        assert sched_a != [c._retry_delay_s(k) for k in range(4)]
        for k, delay in enumerate(sched_a):
            base = 0.02 * (2 ** k)
            assert base <= delay <= base * 1.5

    asyncio.run(main())


def test_retry_backoff_jitter_replays_through_the_send_loop():
    """End to end: two streams with the same ``retry_seed`` sleep the
    identical jittered backoff schedule through the REAL send-retry
    loop (transient errnos injected at drain); a third seed diverges."""

    async def run(seed):
        reader = asyncio.StreamReader()
        failures = [2]

        class _W:
            def write(self, data):
                pass

            async def drain(self):
                if failures[0] > 0:
                    failures[0] -= 1
                    raise OSError(errno.EAGAIN, "injected")

            def get_extra_info(self, name, default=None):
                return default

        s = FramedStream(
            reader, _W(), send_retries=3, retry_base_s=0.001,
            retry_jitter_frac=1.0, retry_seed=seed,
        )
        slept = []
        real_sleep = asyncio.sleep

        async def spy_sleep(delay, *a, **k):
            slept.append(delay)
            await real_sleep(0)

        asyncio.sleep, _saved = spy_sleep, asyncio.sleep
        try:
            await s.send(P.Ok(info="x"))
        finally:
            asyncio.sleep = _saved
        return slept

    first = asyncio.run(run(21))
    second = asyncio.run(run(21))
    third = asyncio.run(run(22))
    assert first and first == second
    assert first != third


def test_reconnects_counter_after_neighbor_death_and_rejoin():
    """A fault-injected crash kills B; a replacement rejoins and dials
    back in — the survivor's ``comm.agent.reconnects`` counter records
    the healed edge."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            master = ConsensusMaster(
                TRIANGLE, convergence_eps=1e-7, elastic=True
            )
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port) for t in "ABC"}
            await asyncio.gather(*(a.start() for a in agents.values()))

            # B's outgoing edge to A crashes on the next push, tearing
            # its transport; then B's process dies entirely.
            inject_neighbor_faults(agents["B"], "A", FaultPlan(7, crash_at=0))
            with pytest.raises(ConnectionResetError):
                await agents["B"]._neighbors["A"].send(P.Ok())
            await agents["B"].close()
            while "B" not in master._down:  # the master observed the death
                await asyncio.sleep(0.002)

            b2 = ConsensusAgent("B", host, port, rejoin=True)
            await b2.start()
            agents["B"] = b2
            await agents["A"].wait_neighbors(timeout=20.0)
            assert agents["A"].counters.get("reconnects", 0) >= 1
            assert reg.counters.get("comm.agent.reconnects", 0) >= 1

            await master.shutdown()
            for a in agents.values():
                await a.close(drain=0.1)

    asyncio.run(asyncio.wait_for(main(), 20))


# --------------------------------------------------------------------- #
# Quarantine: lying peer detected, evicted, topology regenerated        #
# --------------------------------------------------------------------- #
def test_lying_peer_is_quarantined_and_evicted(tmp_path):
    """The detection pipeline end-to-end over real TCP: C's pushes carry
    field lies -> both neighbors hit the violation threshold and
    quarantine C (drop + counters) -> the master collects the
    accusations, evicts C, dumps the flight recorder, and regenerates
    the membership without it."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            flight = FlightRecorder(str(tmp_path))
            master = ConsensusMaster(
                TRIANGLE, convergence_eps=1e-7, regenerate=True,
                flight=flight,
            )
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port) for t in "ABC"}
            await asyncio.gather(*(a.start() for a in agents.values()))

            runners = {
                t: AsyncGossipRunner(
                    agents[t], staleness_bound=1, deadline_s=0.3,
                    quarantine_after=3,
                )
                for t in "ABC"
            }
            wA = inject_neighbor_faults(
                agents["C"], "A", FaultPlan(0, byzantine_p=1.0)
            )
            inject_neighbor_faults(
                agents["C"], "B", FaultPlan(1, byzantine_p=1.0)
            )

            rng = np.random.default_rng(0)
            xs = {t: torch.from_numpy(rng.normal(size=8).astype(np.float32)) for t in "ABC"}
            live = ["A", "B", "C"]
            for _ in range(8):
                outs = await asyncio.gather(
                    *(runners[t].run_async_round(xs[t]) for t in live),
                    return_exceptions=True,
                )
                for t, o in zip(list(live), outs):
                    if isinstance(o, Exception):
                        live.remove(t)  # C: shutdown / aborted round
                    else:
                        xs[t] = o
                await asyncio.sleep(0.05)
                if master.counters.get("agents_quarantined"):
                    break

            # Neighbors detected and cut the liar locally...
            assert "C" in runners["A"].quarantined
            assert "C" in runners["B"].quarantined
            assert agents["A"].counters.get("async_field_violations", 0) >= 3
            assert agents["A"].counters.get("async_quarantines", 0) == 1
            # ...the fault log shows the lies that triggered it...
            assert wA.counters.get("byzantine", 0) >= 3
            # ...and the master evicted + regenerated without C.
            assert master.counters.get("quarantine_reports", 0) >= 2
            assert master.counters.get("agents_quarantined", 0) == 1
            assert master.counters.get("generations", 0) >= 1
            dumps = glob.glob(os.path.join(str(tmp_path), "*quarantine*"))
            assert dumps, "flight recorder dump on quarantine is mandatory"
            # Registry mirrors (the obs satellite's counter names).
            assert reg.counters.get("comm.agent.async_quarantines", 0) >= 2
            assert reg.counters.get("comm.master.agents_quarantined") == 1

            await master.shutdown()
            for a in agents.values():
                await a.close(drain=0.1)

    asyncio.run(asyncio.wait_for(main(), 20))


def test_quarantined_token_cannot_reregister():
    """Eviction is durable: a process re-presenting the quarantined
    token is refused at registration (counter: quarantine_rejections)."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            master = ConsensusMaster(
                TRIANGLE, convergence_eps=1e-7, regenerate=True
            )
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port) for t in "ABC"}
            await asyncio.gather(*(a.start() for a in agents.values()))
            runners = {
                t: AsyncGossipRunner(
                    agents[t], staleness_bound=1, deadline_s=0.3,
                    quarantine_after=2,
                )
                for t in "AB"
            }
            inject_neighbor_faults(
                agents["C"], "A", FaultPlan(0, byzantine_p=1.0)
            )
            inject_neighbor_faults(
                agents["C"], "B", FaultPlan(1, byzantine_p=1.0)
            )
            # C pushes lies directly (no round needed on its side).
            from distributed_learning_tpu_torch.comm.async_runtime import (
                AsyncGossipRunner as _R,
            )
            liar = _R(agents["C"], staleness_bound=1)
            rng = np.random.default_rng(0)
            xs = {t: torch.from_numpy(rng.normal(size=8).astype(np.float32)) for t in "ABC"}
            for _ in range(10):
                try:
                    await liar._push(xs["C"].numpy())
                except (ConnectionError, KeyError, RuntimeError):
                    break
                await asyncio.gather(
                    *(runners[t].run_async_round(xs[t]) for t in "AB"),
                    return_exceptions=True,
                )
                await asyncio.sleep(0.02)
                if master.counters.get("agents_quarantined"):
                    break
            assert master.counters.get("agents_quarantined", 0) == 1

            # The evicted token is barred from re-registering.
            c2 = ConsensusAgent("C", host, port, rejoin=True)
            with pytest.raises(Exception):
                await asyncio.wait_for(c2.start(), 10.0)
            assert master.counters.get("quarantine_rejections", 0) >= 1
            await c2.close(drain=0.05)

            await master.shutdown()
            for a in agents.values():
                await a.close(drain=0.1)

    asyncio.run(asyncio.wait_for(main(), 20))


# --------------------------------------------------------------------- #
# Combined schedules on one stream                                      #
# --------------------------------------------------------------------- #
def test_combined_reorder_dup_delay_schedule_replays_bit_identical():
    """A plan mixing reorder + dup + delay on ONE stream is still a
    pure function of (seed, frame index): the delivered frame sequence,
    the per-kind stream counters, and the per-edge registry counters
    replay identically run-to-run, and a different seed deals a
    different schedule.  (The single-kind delivery semantics are pinned
    above; this pins their composition — a reorder hold-back must not
    perturb the dup/delay decisions of later frames.)"""

    KW = dict(reorder_p=0.3, dup_p=0.3, delay_p=0.4, delay_max_s=0.01)
    N = 24

    async def one_run(seed):
        reg = MetricsRegistry()
        with use_registry(reg):
            server, client, srv = await _tcp_pair()
            faulty = FaultPlan(seed, **KW).wrap(
                client, peer="B", edge="A->B"
            )
            for i in range(N):
                await faulty.send(P.Ok(info=f"m{i}"))
            received = []
            try:
                while True:
                    msg = await srv.recv(timeout=0.3)
                    received.append(msg.info)
            except (FrameTimeout, FrameError):
                pass
            stream_counters = dict(faulty.counters)
            edge_counters = {
                k: v for k, v in reg.counters.items()
                if k.startswith("comm.faults.")
            }
            client.close(); srv.close(); server.close()
            await server.wait_closed()
            return received, stream_counters, edge_counters

    async def main():
        r1 = await one_run(11)
        r2 = await one_run(11)
        r3 = await one_run(12)
        return r1, r2, r3

    (seq1, sc1, ec1), (seq2, sc2, ec2), (seq3, sc3, ec3) = asyncio.run(
        asyncio.wait_for(main(), 20)
    )
    # Identical replay: same delivery order, same counters, bit for bit.
    assert seq1 == seq2
    assert sc1 == sc2 and ec1 == ec2
    # All three kinds actually engaged on this one stream...
    assert sc1.get("reorder", 0) >= 1
    assert sc1.get("dup", 0) >= 1
    assert sc1.get("delay", 0) >= 1
    # ...with matching per-edge attribution for each engaged kind.
    for kind in ("reorder", "dup", "delay"):
        assert ec1.get(f"comm.faults.{kind}/A->B") == sc1[kind]
    # Nothing was lost: dup adds frames, reorder only permutes (modulo
    # one possible trailing hold-back), so every m<i> appears.
    assert len(seq1) >= N - 1 + sc1.get("dup", 0) - 1
    assert set(seq1) >= {f"m{i}" for i in range(N - 1)}
    # A different seed deals a visibly different schedule.
    assert (seq3, sc3) != (seq1, sc1)


# --------------------------------------------------------------------- #
# The same seed, the reference's faults                                 #
# --------------------------------------------------------------------- #
PLANS = [
    dict(drop_p=0.1, corrupt_p=0.1, truncate_p=0.1, dup_p=0.1, reorder_p=0.1,
         byzantine_p=0.1, delay_p=0.3, delay_max_s=0.01),
    dict(drop_p=0.2, dup_p=0.2, reorder_p=0.2),
    dict(byzantine_p=1.0, crash_at=40),
]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
@pytest.mark.parametrize("kw", PLANS)
def test_fault_plan_decisions_and_byte_mutations_equal_the_reference(kw, seed):
    port, ref = FaultPlan(seed, **kw), r_faults.FaultPlan(seed, **kw)
    assert port.schedule(300) == [tuple(d) for d in ref.schedule(300)]
    body = bytes(range(200))
    for i in (0, 1, 17, 299):
        assert port.corrupt_bytes(i, body) == ref.corrupt_bytes(i, body)
        assert port.truncate_bytes(i, body) == ref.truncate_bytes(i, body)


@pytest.mark.parametrize("kind", ["none", "corrupt", "truncate", "byzantine"])
def test_faulty_frames_equal_the_reference(kind):
    """A frame the port's FaultyStream writes under each decision is the
    reference's, byte for byte (the crc from the port's native engine)."""
    seed, p = 5, {"corrupt": "corrupt_p", "truncate": "truncate_p",
                  "byzantine": "byzantine_p"}.get(kind)
    kw = {p: 1.0} if p else {}
    value = np.linspace(-1.0, 1.0, 33, dtype=np.float32)
    port = FaultyStream(None, FaultPlan(seed, **kw))
    ref = r_faults.FaultyStream(None, r_faults.FaultPlan(seed, **kw))
    for i in range(4):
        d = port.plan.decide(i)
        assert tuple(d) == tuple(ref.plan.decide(i)) and d.kind == kind
        msg_p = P.AsyncValue(round_id=3 + i, generation=1, staleness=1, value=value)
        msg_r = r_P.AsyncValue(round_id=3 + i, generation=1, staleness=1, value=value)
        if kind == "byzantine":
            msg_p, msg_r = port.plan.mutate(i, msg_p), ref.plan.mutate(i, msg_r)
        assert port._encode(msg_p, d, i) == ref._encode(msg_r, d, i)


def test_retry_jitter_sequences_equal_the_reference():
    for seed in (0, 11, 12, 99):
        kw = dict(send_retries=3, retry_base_s=0.02, retry_jitter_frac=0.5, retry_seed=seed)
        port = FramedStream(None, None, **kw)
        ref = r_framing.FramedStream(None, None, **kw)
        assert [port._retry_delay_s(k) for k in range(6)] == [
            ref._retry_delay_s(k) for k in range(6)]
