"""Elastic recovery in the port's TCP backend (mirror of
``tests/test_comm_elastic.py`` with torch tensors as values): an agent
dies, a replacement with the same token rejoins, and consensus rounds
continue.  Each test runs under its own 20 s ``asyncio.wait_for`` limit.

Beyond parity: the reference's only failure handling is the shutdown
broadcast (SURVEY.md §5 "failure detection / elastic recovery: none");
here the master survives agent death (``elastic=True``), aborts the
in-flight round, and lets a fresh process re-register the token
(``ConsensusAgent(rejoin=True)``), which re-dials its neighbors and
re-aligns gossip tags through the master's global round ids.
"""

import asyncio

import numpy as np
import pytest
import torch

from distributed_learning_tpu_torch.comm.agent import ConsensusAgent
from distributed_learning_tpu_torch.comm.master import ConsensusMaster

LIMIT_S = 20


async def _until(cond, limit_s: float = 5.0) -> None:
    """Wait for a state of the deployment instead of for a fixed time."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + limit_s
    while not cond():
        if loop.time() > deadline:
            raise TimeoutError("condition never held")
        await asyncio.sleep(0.002)

TRIANGLE = [("A", "B"), ("B", "C"), ("C", "A")]


async def _deploy_elastic(eps=1e-7):
    master = ConsensusMaster(TRIANGLE, convergence_eps=eps, elastic=True)
    host, port = await master.start()
    agents = {
        t: ConsensusAgent(t, host, port) for t in ("A", "B", "C")
    }
    await asyncio.gather(*(a.start() for a in agents.values()))
    return master, agents


def test_agent_rejoin_between_rounds():
    async def main():
        master, agents = await _deploy_elastic()
        host, port = master.address
        vals = {
            "A": torch.tensor([3.0, 0.0]),
            "B": torch.tensor([0.0, 6.0]),
            "C": torch.tensor([9.0, 9.0]),
        }
        outs = await asyncio.gather(
            *(a.run_round(vals[t], 1.0) for t, a in agents.items())
        )
        for out in outs:
            np.testing.assert_allclose(out, [4.0, 5.0], atol=1e-3)

        # B dies; a replacement process rejoins with B's token.
        await agents["B"].close()
        await _until(lambda: "B" in master._down)  # the master observed the death
        b2 = ConsensusAgent("B", host, port, rejoin=True)
        await b2.start()
        agents["B"] = b2

        async def round2(token, agent):
            # Survivors may first hit the dead stream from the old B;
            # heal (wait for the rejoiner to dial back in) and retry.
            for _ in range(3):
                try:
                    return await agent.run_round(outs[0] * 0 + vals[token], 1.0)
                except ConnectionError:
                    await agent.wait_neighbors(timeout=20.0)
            raise AssertionError(f"{token} could not complete round 2")

        outs2 = await asyncio.gather(
            *(round2(t, a) for t, a in agents.items())
        )
        for out in outs2:
            np.testing.assert_allclose(out, [4.0, 5.0], atol=1e-3)

        await master.shutdown()
        for a in agents.values():
            await a.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_mid_round_death_aborts_round_and_recovers():
    async def main():
        master, agents = await _deploy_elastic(eps=1e-12)
        host, port = master.address
        vals = {
            "A": torch.full((4,), 1.0),
            "B": torch.full((4,), 2.0),
            "C": torch.full((4,), 3.0),
        }

        async def doomed():
            # B dies mid-round: run a couple of iterations then vanish.
            try:
                await asyncio.wait_for(
                    agents["B"].run_round(vals["B"], 1.0), 0.15
                )
            except (asyncio.TimeoutError, ConnectionError):
                pass
            await agents["B"].close()

        async def survivor(token):
            try:
                return await agents[token].run_round(vals[token], 1.0)
            except ConnectionError:
                return None  # neighbor died mid-gossip; value kept by caller

        _, ra, rc = await asyncio.gather(
            doomed(), survivor("A"), survivor("C")
        )
        # Round was aborted (master broadcast Done) or failed on the dead
        # stream; either way both survivors returned (no deadlock).

        b2 = ConsensusAgent("B", host, port, rejoin=True)
        await b2.start()
        agents["B"] = b2

        async def retry(token, agent):
            for _ in range(3):
                try:
                    return await agent.run_round(vals[token], 1.0)
                except ConnectionError:
                    await agent.wait_neighbors(timeout=20.0)
            raise AssertionError(f"{token} could not complete recovery round")

        outs = await asyncio.gather(
            *(retry(t, a) for t, a in agents.items())
        )
        for out in outs:
            np.testing.assert_allclose(out, 2.0, atol=1e-3)

        await master.shutdown()
        for a in agents.values():
            await a.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_double_death_and_rejoin_in_any_order():
    """Two agents die; replacements rejoin sequentially.  The first
    rejoiner must NOT dial the other dead agent's stale address (the
    master marks down neighbors with port 0)."""

    async def main():
        master, agents = await _deploy_elastic()
        host, port = master.address
        vals = {
            "A": torch.full((3,), 1.0),
            "B": torch.full((3,), 2.0),
            "C": torch.full((3,), 6.0),
        }
        await asyncio.gather(
            *(a.run_round(vals[t], 1.0) for t, a in agents.items())
        )
        await agents["B"].close()
        await agents["C"].close()
        await _until(lambda: {"B", "C"} <= master._down)

        b2 = ConsensusAgent("B", host, port, rejoin=True)
        await b2.start()  # C is down: must skip dialing its stale address
        agents["B"] = b2
        c2 = ConsensusAgent("C", host, port, rejoin=True)
        await c2.start()  # dials both A and the rejoined B
        agents["C"] = c2
        await asyncio.gather(
            agents["A"].wait_neighbors(20.0), b2.wait_neighbors(20.0)
        )

        async def retry(token, agent):
            for _ in range(3):
                try:
                    return await agent.run_round(vals[token], 1.0)
                except ConnectionError:
                    await agent.wait_neighbors(timeout=20.0)
            raise AssertionError(token)

        outs = await asyncio.gather(*(retry(t, a) for t, a in agents.items()))
        for out in outs:
            np.testing.assert_allclose(out, 3.0, atol=1e-3)
        await master.shutdown()
        for a in agents.values():
            await a.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_rejoin_races_death_detection():
    """A replacement that registers before the master noticed the death
    retries until the token frees up (no sleep between close and rejoin)."""

    async def main():
        master, agents = await _deploy_elastic()
        host, port = master.address
        vals = {
            "A": torch.full((2,), 0.0),
            "B": torch.full((2,), 3.0),
            "C": torch.full((2,), 6.0),
        }
        await asyncio.gather(
            *(a.run_round(vals[t], 1.0) for t, a in agents.items())
        )
        await agents["B"].close()
        b2 = ConsensusAgent("B", host, port, rejoin=True)
        await b2.start()  # no sleep: may hit "already registered" and retry
        agents["B"] = b2

        async def retry(token, agent):
            for _ in range(3):
                try:
                    return await agent.run_round(vals[token], 1.0)
                except ConnectionError:
                    await agent.wait_neighbors(timeout=20.0)
            raise AssertionError(token)

        outs = await asyncio.gather(*(retry(t, a) for t, a in agents.items()))
        for out in outs:
            np.testing.assert_allclose(out, 3.0, atol=1e-3)
        await master.shutdown()
        for a in agents.values():
            await a.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_death_during_registration_window():
    """An agent that registers and dies BEFORE the deployment initializes
    is replaced by a plain re-registration; the deployment then proceeds."""

    async def main():
        master = ConsensusMaster(TRIANGLE, convergence_eps=1e-7, elastic=True)
        host, port = await master.start()
        a = ConsensusAgent("A", host, port)
        b = ConsensusAgent("B", host, port)

        # Registration exchanges happen, then B dies (no C yet, so these
        # start() calls block awaiting NeighborhoodData).
        ta = asyncio.ensure_future(a.start())
        tb = asyncio.ensure_future(b.start())
        await _until(lambda: len(master._control) == 2)  # A and B registered
        await b.close()  # dies pre-initialization
        tb.cancel()
        await _until(lambda: "B" in master._down)  # master observes the death

        b2 = ConsensusAgent("B", host, port)  # plain registration suffices
        tb2 = asyncio.ensure_future(b2.start())
        c = ConsensusAgent("C", host, port)
        await asyncio.gather(ta, tb2, c.start())

        vals = {"A": 0.0, "B": 3.0, "C": 6.0}
        agents = {"A": a, "B": b2, "C": c}
        outs = await asyncio.gather(
            *(
                ag.run_round(torch.full((2,), vals[t]), 1.0)
                for t, ag in agents.items()
            )
        )
        for out in outs:
            np.testing.assert_allclose(out, 3.0, atol=1e-3)
        await master.shutdown()
        for ag in agents.values():
            await ag.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_non_elastic_master_still_fails_loudly():
    async def main():
        master = ConsensusMaster(TRIANGLE, elastic=False)
        host, port = await master.start()
        agents = {t: ConsensusAgent(t, host, port) for t in ("A", "B", "C")}
        await asyncio.gather(*(a.start() for a in agents.values()))
        await agents["B"].close()
        # The non-elastic master tears the deployment down on agent death
        # (reference-parity behavior): its serve loop stops.
        await asyncio.wait_for(master._stopped.wait(), 10)
        for t in ("A", "C"):
            await agents[t].close()
        await master.shutdown()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_choco_invalidated_by_rejoin_then_coordinated_reset():
    """CHOCO estimates are replicated state; a rejoined neighbor starts at
    zero while survivors' copies are non-zero.  The next run_choco_once
    must fail LOUDLY (silent continuation would converge to the wrong
    point), and a coordinated reset_choco() on every agent restarts the
    compressed stream cleanly."""

    def topk50(v):
        k = max(1, v.size // 2)
        out = np.zeros_like(v)
        idx = np.argsort(np.abs(v))[-k:]
        out[idx] = v[idx]
        return out

    async def main():
        master, agents = await _deploy_elastic()
        host, port = master.address
        rng = np.random.default_rng(0)
        vals = {t: torch.from_numpy(rng.normal(size=8).astype(np.float32)) for t in "ABC"}
        xs = dict(vals)
        for _ in range(5):
            outs = await asyncio.gather(
                *(a.run_choco_once(xs[t], topk50, gamma=0.4)
                  for t, a in agents.items())
            )
            xs = dict(zip(agents, outs))

        # B dies and a replacement rejoins.
        await agents["B"].close()
        await _until(lambda: "B" in master._down)
        b2 = ConsensusAgent("B", host, port, rejoin=True)
        await b2.start()
        agents["B"] = b2
        await agents["A"].wait_neighbors(timeout=20.0)
        await agents["C"].wait_neighbors(timeout=20.0)

        # Survivors must refuse to continue the compressed stream (the
        # tag-alignment guard trips first; estimate invalidation backs it
        # up if a master round runs without reset_choco).
        with pytest.raises(RuntimeError, match="re-align|invalidated"):
            await agents["A"].run_choco_once(xs["A"], topk50, gamma=0.4)

        # A master round re-aligns the TAGS but the estimates are still
        # stale: the second guard layer must now surface the invalidation
        # specifically, prescribing reset_choco().
        mean = torch.stack([xs[t] for t in "ABC"]).mean(0)
        outs = await asyncio.gather(
            *(a.run_round(xs[t], 1.0) for t, a in agents.items())
        )
        with pytest.raises(RuntimeError, match="invalidated"):
            await agents["A"].run_choco_once(outs[0], topk50, gamma=0.4)
        # Coordinated restart: reset everywhere; the compressed stream
        # then resumes and stays at the consensus point.
        for a in agents.values():
            a.reset_choco()
        xs = dict(zip(agents, outs))
        for t in "ABC":
            np.testing.assert_allclose(xs[t], mean, atol=1e-3)
        for _ in range(10):
            outs = await asyncio.gather(
                *(a.run_choco_once(xs[t], topk50, gamma=0.4)
                  for t, a in agents.items())
            )
            xs = dict(zip(agents, outs))
        for t in "ABC":
            np.testing.assert_allclose(xs[t], mean, atol=1e-3)

        await master.shutdown()
        for a in agents.values():
            await a.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))


def test_rejoiner_masterless_collective_fails_loudly_until_realigned():
    """A fresh rejoiner's op tags are behind the survivors'; a masterless
    run_once/run_choco_once would deadlock — it must raise instead, and
    work again after one master round re-aligns the tags."""

    async def main():
        master, agents = await _deploy_elastic()
        host, port = master.address
        vals = {t: torch.full((2,), float(i))
                for i, t in enumerate("ABC")}
        await asyncio.gather(
            *(a.run_round(vals[t], 1.0) for t, a in agents.items())
        )
        await agents["B"].close()
        await _until(lambda: "B" in master._down)
        b2 = ConsensusAgent("B", host, port, rejoin=True)
        await b2.start()
        agents["B"] = b2

        with pytest.raises(RuntimeError, match="re-align"):
            await b2.run_once(vals["B"])
        with pytest.raises(RuntimeError, match="re-align"):
            await b2.run_choco_once(vals["B"], lambda v: v)

        async def heal_round(token, agent):
            for _ in range(3):
                try:
                    return await agent.run_round(vals[token], 1.0)
                except ConnectionError:
                    await agent.wait_neighbors(timeout=20.0)
            raise AssertionError(f"{token} could not complete the round")

        outs = await asyncio.gather(
            *(heal_round(t, a) for t, a in agents.items())
        )
        for out in outs:
            np.testing.assert_allclose(out, [1.0, 1.0], atol=1e-3)
        # Tags re-aligned: masterless collectives work again.
        outs2 = await asyncio.gather(
            *(a.run_once(vals[t]) for t, a in agents.items())
        )
        assert all(torch.isfinite(o).all() for o in outs2)

        await master.shutdown()
        for a in agents.values():
            await a.close()

    asyncio.run(asyncio.wait_for(main(), LIMIT_S))
