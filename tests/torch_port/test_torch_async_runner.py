"""The port's asynchronous gossip runtime (``comm/async_runtime.py``,
``AsyncGossipRunner``) and the deadline and membership paths of its
master, on the CPU over loopback TCP: a mirror of the wire and control
parts of ``tests/test_async_runtime.py`` (its lines 218-843) with torch
tensors as values, plus the cross-package oracle: port runners at
tau = 0, alone or beside JAX runners in one deployment, equal the JAX
package's lock-step ``run_once`` / ``run_choco_once`` sequences bit for
bit.  Each asyncio test runs under its own 20 s ``asyncio.wait_for``
limit; orderings wait on deployment state, not on fixed sleeps.
"""

import asyncio
import errno
import glob
import os

import numpy as np
import pytest
import torch

from distributed_learning_tpu.comm import AsyncGossipRunner as RRunner
from distributed_learning_tpu.comm import ConsensusAgent as RAgent
from distributed_learning_tpu.comm import ConsensusMaster as RMaster
from distributed_learning_tpu_torch.comm import AsyncGossipRunner, ConsensusAgent, ConsensusMaster
from distributed_learning_tpu_torch.comm import protocol as P
from distributed_learning_tpu_torch.comm.framing import FramedStream, FrameTimeout
from distributed_learning_tpu_torch.obs import FlightRecorder, MetricsRegistry, use_registry

TRIANGLE = [("A", "B"), ("B", "C"), ("C", "A")]
RING4 = [("1", "2"), ("2", "3"), ("3", "4"), ("4", "1")]
LIMIT_S = 20


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


async def _until(cond, limit_s: float = 10.0) -> None:
    loop = asyncio.get_running_loop()
    deadline = loop.time() + limit_s
    while not cond():
        if loop.time() > deadline:
            raise TimeoutError("condition never held")
        await asyncio.sleep(0.002)


def _topk(v):
    k = max(1, v.size // 2)
    out = np.zeros_like(v)
    idx = np.argsort(np.abs(v))[-k:]
    out[idx] = v[idx]
    return out


# --------------------------------------------------------------------- #
# FramedStream: retries and frame-boundary timeouts                     #
# --------------------------------------------------------------------- #
def test_framed_stream_send_retries_transient_errors():
    class FlakyWriter:
        def __init__(self, failures):
            self.failures = failures
            self.chunks = []

        def write(self, data):
            self.chunks.append(data)

        async def drain(self):
            if self.failures:
                self.failures -= 1
                self.chunks.pop()
                raise OSError(errno.EAGAIN, "try again")

        def close(self):
            pass

    async def main():
        retries = []
        w = FlakyWriter(failures=2)
        s = FramedStream(None, w, send_retries=3, retry_base_s=0.001,
                         on_retry=lambda: retries.append(1))
        await s.send(P.Ok(info="hi"))
        assert len(retries) == 2 and s.frames_sent == 1 and len(w.chunks) == 1

        class DeadWriter(FlakyWriter):
            async def drain(self):
                raise ConnectionResetError(errno.ECONNRESET, "peer gone")

        s2 = FramedStream(None, DeadWriter(0), send_retries=3, on_retry=lambda: retries.append(1))
        with pytest.raises(ConnectionError):
            await s2.send(P.Ok())
        assert len(retries) == 2
        s3 = FramedStream(None, FlakyWriter(failures=5), send_retries=2, retry_base_s=0.001)
        with pytest.raises(OSError):
            await s3.send(P.Ok())

    run(main())


def test_framed_stream_recv_timeout_is_frame_boundary_safe():
    async def main():
        server_streams = []

        async def on_conn(reader, writer):
            server_streams.append(FramedStream(reader, writer))

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        client = FramedStream(reader, writer)
        await _until(lambda: server_streams)
        (srv,) = server_streams
        with pytest.raises(FrameTimeout):
            await client.recv(timeout=0.05)
        assert not isinstance(FrameTimeout("x"), ConnectionError)
        await srv.send(P.Telemetry(token="t", payload={"k": 1}))
        msg = await client.recv(timeout=1.0)
        assert isinstance(msg, P.Telemetry) and msg.payload == {"k": 1}
        client.close()
        srv.close()
        server.close()
        await server.wait_closed()

    run(main())


# --------------------------------------------------------------------- #
# Runner: tau = 0 against the lock-step path                            #
# --------------------------------------------------------------------- #
async def _deploy(edges=TRIANGLE, tokens="ABC", kinds=None, master="port", **kw):
    """A deployment whose agents are the port's (``p``) or the JAX
    package's (``j``), per token."""
    M = ConsensusMaster if master == "port" else RMaster
    m = M(edges, convergence_eps=1e-7, **kw)
    host, port = await m.start()
    kinds = kinds or "p" * len(tokens)
    agents = {t: (ConsensusAgent if k == "p" else RAgent)(t, host, port)
              for t, k in zip(tokens, kinds)}
    await asyncio.gather(*(a.start() for a in agents.values()))
    return m, agents


async def _teardown(master, agents):
    await master.shutdown()
    await asyncio.gather(*(a.close(drain=0.1) for a in agents.values()))


def _val(agent, x):
    return t32(x) if isinstance(agent, ConsensusAgent) else x


def _host(y):
    return y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


async def _rounds(agents, op, n=5, seed=0):
    rng = np.random.default_rng(seed)
    xs = {t: rng.normal(size=8).astype(np.float32) for t in agents}
    for _ in range(n):
        outs = await asyncio.gather(*(op(t, _val(agents[t], xs[t])) for t in agents))
        xs = {t: _host(o) for t, o in zip(agents, outs)}
    return xs


@pytest.mark.parametrize("choco", [False, True])
@pytest.mark.parametrize("kinds", ["ppp", "jpp"])
def test_async_runner_tau0_bit_identical_to_lockstep(choco, kinds):
    """Async rounds at tau = 0 (no deadline, static membership) equal the
    JAX package's lock-step ``run_once`` / ``run_choco_once`` sequence bit
    for bit: an all-JAX lock-step run against port runners (``ppp``) and
    against a JAX runner beside two port runners (``jpp``)."""

    async def lockstep():
        master, agents = await _deploy(kinds="jjj", master="jax")
        if choco:
            xs = await _rounds(agents, lambda t, x: agents[t].run_choco_once(x, _topk, gamma=0.4))
        else:
            xs = await _rounds(agents, lambda t, x: agents[t].run_once(x))
        await _teardown(master, agents)
        return xs

    async def async_mode():
        master, agents = await _deploy(kinds=kinds)
        runners = {t: (AsyncGossipRunner if isinstance(a, ConsensusAgent) else RRunner)(
            a, staleness_bound=0) for t, a in agents.items()}
        if choco:
            xs = await _rounds(agents, lambda t, x: runners[t].run_async_choco(x, _topk, gamma=0.4))
        else:
            xs = await _rounds(agents, lambda t, x: runners[t].run_async_round(x))
        await _teardown(master, agents)
        return xs

    async def main():
        ref, got = await lockstep(), await async_mode()
        for t in "ABC":
            assert np.array_equal(ref[t], got[t]), t

    run(main())


def test_async_round_keeps_the_tensor_dtype_and_shape():
    async def main():
        master, agents = await _deploy()
        runners = {t: AsyncGossipRunner(a) for t, a in agents.items()}
        vals = {t: torch.full((2, 3), float(i)).to(torch.bfloat16) for i, t in enumerate("ABC")}
        outs = await asyncio.gather(*(runners[t].run_async_round(vals[t]) for t in "ABC"))
        for o in outs:
            assert o.dtype == torch.bfloat16 and o.shape == (2, 3)
            torch.testing.assert_close(o.float(), torch.full((2, 3), 1.0), atol=1e-2, rtol=0)
        await _teardown(master, agents)

    run(main())


def test_async_runner_straggler_drops_pokes_and_observes():
    """Agent 4 is held back until the others finished 6 rounds: within
    tau = 1 nothing from it ever arrives, so every fast round waits out
    its deadline, drops it and pokes it; once it runs, it mixes stale
    values and the staleness series lands in the registry."""

    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            master, agents = await _deploy(RING4, tokens="1234")
            runners = {t: AsyncGossipRunner(agents[t], staleness_bound=1, deadline_s=0.05)
                       for t in "1234"}
            rng = np.random.default_rng(1)
            vals = {t: t32(rng.normal(size=16)) for t in "1234"}
            released = asyncio.Event()

            async def fast(t):
                x = vals[t]
                for _ in range(6):
                    x = await runners[t].run_async_round(x)
                return x

            async def slow(t):
                await released.wait()
                x = vals[t]
                for _ in range(2):
                    x = await runners[t].run_async_round(x)
                return x

            slow_task = asyncio.ensure_future(slow("4"))
            fast_out = await asyncio.gather(*(fast(t) for t in "123"))
            released.set()
            slow_out = await slow_task
            counters = dict(reg.counters)
            staleness = [v for _, v in reg.series.get("comm.agent.staleness", ())]
            await _teardown(master, agents)
        assert runners["1"].round == 6 and runners["4"].round == 2
        assert all(torch.isfinite(o).all() for o in (*fast_out, slow_out))
        assert counters.get("comm.agent.async_stale_dropped", 0) >= 2 * 6
        assert counters.get("comm.agent.pokes_sent", 0) >= 2
        assert counters.get("comm.agent.async_deadline_drops", 0) >= 2
        assert counters.get("comm.agent.async_rounds", 0) == 3 * 6 + 2
        assert staleness and max(staleness) >= 1

    run(main())


# --------------------------------------------------------------------- #
# Control plane: deadline-enforced rounds                               #
# --------------------------------------------------------------------- #
def test_enforced_formation_deadline_drops_missing_agent():
    async def main():
        master, agents = await _deploy(round_deadline_s=0.25, enforce_round_deadline=True)
        vals = {"A": torch.full((3,), 3.0), "B": torch.full((3,), 9.0),
                "C": torch.full((3,), 100.0)}

        async def late_c():
            # C asks only after the formation deadline started the round without it.
            await _until(lambda: master.counters.get("round_formation_deadlines", 0) >= 1)
            return await agents["C"].run_round(vals["C"], 1.0)

        ra, rb, rc = await asyncio.gather(agents["A"].run_round(vals["A"], 1.0),
                                          agents["B"].run_round(vals["B"], 1.0), late_c())
        torch.testing.assert_close(ra, torch.full((3,), 6.0), atol=1e-3, rtol=0)
        torch.testing.assert_close(rb, torch.full((3,), 6.0), atol=1e-3, rtol=0)
        assert torch.isfinite(rc).all()
        assert master.counters.get("round_agents_dropped", 0) >= 1
        await _teardown(master, agents)

    run(main())


def test_enforced_mid_round_deadline_cuts_the_round():
    class SlowIterAgent(ConsensusAgent):
        async def _gossip_iteration(self, y):
            await asyncio.sleep(0.05)
            return await super()._gossip_iteration(y)

    async def main():
        master = ConsensusMaster([("A", "B"), ("B", "C")], convergence_eps=1e-30,
                                 round_deadline_s=0.3, enforce_round_deadline=True)
        host, port = await master.start()
        agents = {t: SlowIterAgent(t, host, port) for t in "ABC"}
        await asyncio.gather(*(a.start() for a in agents.values()))
        outs = await asyncio.gather(*(agents[t].run_round(torch.full((2,), float(i)), 1.0)
                                      for i, t in enumerate("ABC")))
        for out in outs:
            assert torch.isfinite(out).all() and 0.0 <= out.min() and out.max() <= 2.0
        assert master.counters.get("rounds_deadline_cut", 0) == 1
        assert master.counters.get("round_deadlines_expired", 0) >= 1
        await _teardown(master, agents)

    run(main())


# --------------------------------------------------------------------- #
# Elastic membership generations                                        #
# --------------------------------------------------------------------- #
def test_elastic_membership_death_regen_rejoin_join(tmp_path):
    async def heal_round(token, agent, value, weight=1.0):
        for _ in range(5):
            try:
                return await agent.run_round(value, weight)
            except ConnectionError:
                await agent.wait_neighbors(timeout=10.0)
        raise AssertionError(f"{token} could not complete the round")

    async def main():
        flight = FlightRecorder(str(tmp_path))
        master = ConsensusMaster(RING4, convergence_eps=1e-7, weight_mode="sdp",
                                 regenerate=True, flight=flight)
        host, port = await master.start()
        agents = {t: ConsensusAgent(t, host, port) for t in "1234"}
        await asyncio.gather(*(a.start() for a in agents.values()))
        vals = {t: torch.full((3,), float(t)) for t in "1234"}
        outs = await asyncio.gather(*(agents[t].run_round(vals[t], 1.0) for t in "1234"))
        for out in outs:
            torch.testing.assert_close(out, torch.full((3,), 2.5), atol=1e-3, rtol=0)
        assert master.generation == 0

        await agents["2"].close(drain=0)
        await _until(lambda: master.generation >= 1)
        assert sorted(master._tokens) == ["1", "3", "4"]
        np.testing.assert_allclose(master.W.sum(axis=1), 1.0, atol=1e-8)
        assert glob.glob(os.path.join(str(tmp_path), "flight-*"))
        outs = await asyncio.gather(*(heal_round(t, agents[t], vals[t]) for t in "134"))
        for out in outs:
            torch.testing.assert_close(out, torch.full((3,), 8.0 / 3.0), atol=1e-3, rtol=0)
        assert all(agents[t].generation == 1 for t in "134")

        b2 = ConsensusAgent("2", host, port, rejoin=True)
        start_task = asyncio.ensure_future(b2.start())
        await _until(lambda: master.generation >= 2)
        await asyncio.gather(*(agents[t].wait_neighbors(10.0) for t in "134"))
        await start_task
        agents["2"] = b2
        outs = await asyncio.gather(*(heal_round(t, agents[t], vals[t]) for t in "1234"))
        for out in outs:
            torch.testing.assert_close(out, torch.full((3,), 2.5), atol=1e-3, rtol=0)
        assert all(agents[t].generation == 2 for t in "1234")

        j = ConsensusAgent("5", host, port, rejoin=True)
        start_task = asyncio.ensure_future(j.start())
        await _until(lambda: master.generation >= 3)
        await asyncio.gather(*(agents[t].wait_neighbors(10.0) for t in "1234"))
        await start_task
        agents["5"] = j
        assert "5" in master._tokens
        np.testing.assert_allclose(master.W.sum(axis=1), 1.0, atol=1e-8)
        vals["5"] = torch.full((3,), 10.0)
        outs = await asyncio.gather(*(heal_round(t, agents[t], vals[t]) for t in "12345"))
        for out in outs:
            torch.testing.assert_close(out, torch.full((3,), 4.0), atol=1e-3, rtol=0)
        await _teardown(master, agents)

    run(main())


# --------------------------------------------------------------------- #
# Zero-copy receive path: scratch pool and fused CHOCO consume          #
# --------------------------------------------------------------------- #
def test_scratch_buf_stale_size_misses_never_corrupts():
    runner = AsyncGossipRunner(ConsensusAgent("X", "127.0.0.1", 1))
    reg = MetricsRegistry()
    with use_registry(reg):
        fit = np.empty(16, np.float32)
        assert runner._scratch_buf("p", fit, 16) is fit
        stale = runner._scratch_buf("p", fit, 8)
        assert stale is not fit and stale.size == 8
        assert runner._scratch_buf("p", None, 8).size == 8
    counters = reg.snapshot()["counters"]
    assert counters["comm.wire.scratch_hits"] == 1
    assert counters["comm.wire.scratch_misses"] == 2
    assert counters["comm.wire.scratch_bytes"] == 4 * (16 + 8 + 8)


def test_membership_realignment_evicts_scratch_pool():
    async def main():
        reg = MetricsRegistry()
        with use_registry(reg):
            master = ConsensusMaster(RING4, convergence_eps=1e-7, regenerate=True)
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port, bf16_wire=True) for t in "1234"}
            await asyncio.gather(*(a.start() for a in agents.values()))
            runners = {t: AsyncGossipRunner(agents[t], staleness_bound=1, deadline_s=0.25)
                       for t in "1234"}
            rng = np.random.default_rng(3)
            xs = {t: t32(rng.normal(size=32)) for t in "1234"}
            for _ in range(6):
                outs = await asyncio.gather(*(runners[t].run_async_round(xs[t]) for t in "1234"))
                xs = dict(zip("1234", outs))
            warm = reg.snapshot()["counters"]
            assert warm["comm.wire.scratch_misses"] >= 1 and warm["comm.wire.scratch_hits"] >= 1
            assert any(k.startswith("comm.wire.scratch_misses/") and "->" in k for k in warm)

            # A death: the regenerated membership's broadcast evicts the pool.
            await agents["2"].close(drain=0)
            await _until(lambda: master.generation >= 1)
            for t in "134":
                for _ in range(30):
                    if agents[t].generation == 1:
                        break
                    xs[t] = await runners[t].run_async_round(xs[t])
                assert agents[t].generation == 1, t
                assert "2" not in runners[t]._scratch and "2" not in agents[t]._weights
            for _ in range(3):
                outs = await asyncio.gather(*(runners[t].run_async_round(xs[t]) for t in "134"))
                for out in outs:
                    assert torch.isfinite(out).all() and out.shape == (32,)
                xs.update(zip("134", outs))
            after = reg.snapshot()["counters"]
            assert after["comm.wire.scratch_misses"] > warm["comm.wire.scratch_misses"]
            await master.shutdown()
            await asyncio.gather(*(agents[t].close(drain=0.1) for t in "134"))

    run(main())


@pytest.mark.parametrize("overlap", [False, True])
def test_async_choco_fused_wire_bit_identical_to_sparse_wire(overlap):
    def topk(v):
        k = max(1, v.size // 4)
        out = np.zeros_like(v)
        idx = np.argsort(np.abs(v))[-k:]
        out[idx] = v[idx]
        return out

    async def run_mode(fused):
        reg = MetricsRegistry()
        with use_registry(reg):
            master = ConsensusMaster(TRIANGLE, convergence_eps=1e-7)
            host, port = await master.start()
            agents = {t: ConsensusAgent(t, host, port, sparse_wire=True) for t in "ABC"}
            await asyncio.gather(*(a.start() for a in agents.values()))
            runners = {t: AsyncGossipRunner(agents[t], staleness_bound=0, overlap=overlap)
                       for t in "ABC"}
            rng = np.random.default_rng(7)
            xs = {t: t32(rng.normal(size=24)) for t in "ABC"}
            buckets = (("float32", ((0, 24),)),) if fused else None
            for _ in range(4):
                outs = await asyncio.gather(*(runners[t].run_async_choco(
                    xs[t], topk, gamma=0.4, buckets=buckets) for t in "ABC"))
                xs = dict(zip("ABC", outs))
            spans = dict(reg.snapshot().get("spans", {}))
            await _teardown(master, agents)
        return xs, spans

    async def main():
        ref, ref_spans = await run_mode(fused=False)
        got, got_spans = await run_mode(fused=True)
        for t in "ABC":
            assert torch.equal(ref[t], got[t]), t
        assert "comm.wire.decode.apply" in got_spans
        assert "comm.wire.decode.apply" not in ref_spans

    run(main())


def test_close_does_not_wait_on_frames_a_closing_peer_never_reads():
    """Two agents push 16 MB values at each other (``begin_round`` with
    no ``finish_round``: nobody reads) and then close at once: each
    transport still holds unsent bytes for a peer that stopped reading.
    Flushing them never ends, and the accepted connection would hold
    ``Server.wait_closed`` forever; close drops them and returns."""

    async def main():
        master, agents = await _deploy([("A", "B")], tokens="AB")
        runners = {t: AsyncGossipRunner(a) for t, a in agents.items()}
        big = torch.ones(4_000_000)
        for _ in range(2):
            await asyncio.gather(*(r.begin_round(big) for r in runners.values()))
        # The pushes have filled the socket buffers: bytes wait in both transports.
        await _until(lambda: all(s.writer.transport.get_write_buffer_size() > 0
                                 for a in agents.values() for s in a._neighbors.values()))
        await asyncio.wait_for(asyncio.gather(*(a.close(drain=0) for a in agents.values())), 10)
        await master.shutdown()

    run(main())
