"""The port's comm runtime (``distributed_learning_tpu_torch.comm``:
``ConsensusMaster``, ``ConsensusAgent``) against the JAX package's, on the
CPU over loopback TCP.

The strongest oracle is the mixed deployment: in one event loop a JAX
master with 2 port and 2 JAX agents, and a port master with JAX agents,
run the same sequence of operations (``run_once``, ``run_choco_tree``
fused top-k, a converging ``run_round``, a fixed-iteration ``run_round``)
as an all-JAX deployment from the same values.  Results agree within
2e-6 absolute (the reference's mixing oracles' limit; fixed-iteration
operations agree bit for bit), round ids, op ids, generations and the
master's convergence iteration are equal, and every value frame
(``ValueResponse*``, keyed by directed edge, op id and iteration) is
byte-equal.  The rest mirrors the TCP tests of ``tests/test_comm.py`` with
torch tensors as values.  Every asyncio test runs under its own
``asyncio.wait_for`` limit.
"""

import asyncio

import ml_dtypes
import numpy as np
import pytest
import torch

from distributed_learning_tpu.comm import ConsensusAgent as RAgent
from distributed_learning_tpu.comm import ConsensusMaster as RMaster
from distributed_learning_tpu.comm import framing as r_framing
from distributed_learning_tpu.comm import protocol as r_P
from distributed_learning_tpu.comm import top_k_compressor as r_top_k
from distributed_learning_tpu_torch.comm import ConsensusAgent, ConsensusMaster, ShutdownError
from distributed_learning_tpu_torch.comm import framing as p_framing
from distributed_learning_tpu_torch.comm import protocol as p_P
from distributed_learning_tpu_torch.comm import top_k_compressor
from distributed_learning_tpu_torch.comm.pytree_codec import tree_to_flat
from distributed_learning_tpu_torch.utils.telemetry import RecordingTelemetry

MIX_ATOL = 2e-6  # tests/test_consensus.py's mixing limit
LIMIT_S = 20  # each test's asyncio.wait_for limit
RING4 = [("1", "2"), ("2", "3"), ("3", "4"), ("4", "1")]
TRIANGLE = [("1", "2"), ("2", "3"), ("3", "1")]
_VALUE_FRAMES = ("ValueResponse", "ValueResponseSparse", "ValueResponseFusedSparse")


def run(coro, limit=LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit))


def t32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


class FrameLog:
    """Records the packed bytes of every value frame either package's
    ``FramedStream`` sends, keyed by (directed edge, op id, iteration)."""

    def __init__(self, monkeypatch):
        self.frames = {}
        for framing, P in ((r_framing, r_P), (p_framing, p_P)):
            orig = framing.FramedStream.send

            async def send(stream, msg, _orig=orig, _P=P):
                if type(msg).__name__ in _VALUE_FRAMES:
                    key = (stream.edge, msg.round_id, msg.iteration)
                    body = _P.pack_message(msg)
                    assert self.frames.setdefault(key, body) == body
                await _orig(stream, msg)

            monkeypatch.setattr(framing.FramedStream, "send", send)

    def take(self) -> dict:
        out, self.frames = self.frames, {}
        return out


# ---------------------------------------------------------------------- #
# Mixed JAX / port deployments                                           #
# ---------------------------------------------------------------------- #
WIRES = {"f32": {}, "bf16": {"bf16_wire": True}, "int8": {"int8_wire": True}}
MIXES = {
    # master kind, agent kind per token of RING4
    "jax_master_2_port_2_jax": ("jax", "pjpj"),
    "port_master_jax_agents": ("port", "jjjj"),
    "port_master_port_agents": ("port", "pppp"),
}


def _tree(seed: int, kind: str):
    r = np.random.default_rng(seed)
    w, h, b = (r.normal(size=s).astype(np.float32) for s in ((8, 4), (6,), (3,)))
    if kind == "j":
        return {"w": w, "h": h.astype(ml_dtypes.bfloat16), "b": b}
    return {"w": t32(w), "h": t32(h).to(torch.bfloat16), "b": t32(b)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x, np.float32)


async def _scenario(master_kind: str, agent_kinds: str, wire: dict) -> dict:
    """One deployment on RING4 through a fixed sequence of operations;
    returns every result as float32 numpy plus the protocol state."""
    M = RMaster if master_kind == "jax" else ConsensusMaster
    master = M(RING4, convergence_eps=1e-7)
    host, port = await master.start()
    tokens = [t for t, _ in RING4]
    agents = [(RAgent if k == "j" else ConsensusAgent)(t, host, port, sparse_wire=True, **wire)
              for t, k in zip(tokens, agent_kinds)]
    await asyncio.gather(*(a.start() for a in agents))
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=12).astype(np.float32) for _ in agents]

    def val(i, x):
        return x if agent_kinds[i] == "j" else t32(x)

    def comp(i):
        return (r_top_k if agent_kinds[i] == "j" else top_k_compressor)(0.3)

    out = {}
    ys = xs
    for step in ("once_1", "once_2"):
        ys = [_np(y) for y in await asyncio.gather(
            *(a.run_once(val(i, y)) for i, (a, y) in enumerate(zip(agents, ys))))]
        out[step] = ys
    trees = [_tree(10 + i, k) for i, k in enumerate(agent_kinds)]
    for step in ("choco_tree_1", "choco_tree_2"):
        trees = await asyncio.gather(*(a.run_choco_tree(t, comp(i), gamma=0.4)
                                       for i, (a, t) in enumerate(zip(agents, trees))))
        out[step] = [_np(t) for t in trees]
    weights = [1.0, 2.0, 3.0, 4.0]
    out["round_converged"] = [_np(y) for y in await asyncio.gather(
        *(a.run_round(val(i, x), weights[i]) for i, (a, x) in enumerate(zip(agents, xs))))]
    parts = set(master._round_participants)
    out["done_iteration"] = min(i for i, s in master._conv_at.items() if s >= parts)
    out["round_fixed_3"] = [_np(y) for y in await asyncio.gather(
        *(a.run_round(val(i, x), 1.0, max_iterations=3) for i, (a, x) in enumerate(zip(agents, xs))))]
    out["state"] = [(a._round_id, a._op_id, a.generation, a.counters.get("rounds_run"),
                     a.counters.get("run_once"), a.counters.get("choco_tree_rounds"))
                    for a in agents]
    out["master"] = (master._round_id, master.generation, master.counters.get("rounds_started"),
                     master.counters.get("rounds_done"))
    await master.shutdown()
    await asyncio.gather(*(a.close(drain=0.1) for a in agents))
    return out


def _close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _close(got[k], want[k])
    else:
        np.testing.assert_allclose(got, want, atol=MIX_ATOL, rtol=0)


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("mix", list(MIXES))
def test_mixed_deployment_equals_the_all_jax_run(mix, wire, monkeypatch):
    log = FrameLog(monkeypatch)
    master_kind, kinds = MIXES[mix]
    ref = run(_scenario("jax", "jjjj", WIRES[wire]))
    ref_frames = log.take()
    got = run(_scenario(master_kind, kinds, WIRES[wire]))
    got_frames = log.take()
    assert got["state"] == ref["state"]
    assert got["master"] == ref["master"]
    assert got["done_iteration"] == ref["done_iteration"]
    for step in ("once_1", "once_2", "choco_tree_1", "choco_tree_2", "round_converged",
                 "round_fixed_3"):
        for g, w in zip(got[step], ref[step]):
            _close(g, w)
    # The fixed-count operations are deterministic: bit for bit.
    for step in ("once_2", "choco_tree_2", "round_fixed_3"):
        for g, w in zip(got[step], ref[step]):
            if isinstance(w, dict):
                assert all(np.array_equal(g[k], w[k]) for k in w)
            else:
                assert np.array_equal(g, w)
    # Frames byte-equal; a converging round may run different numbers of
    # iterations past the master's done iteration, so those are left out.
    conv_op = (ref["master"][0] - 1) << 20

    def settled(frames):
        return {k: v for k, v in frames.items()
                if not (k[1] == conv_op and k[2] > ref["done_iteration"])}

    assert settled(got_frames).keys() == settled(ref_frames).keys()
    assert len(settled(ref_frames)) > 0
    for key in settled(ref_frames):
        assert got_frames[key] == ref_frames[key], key


# ---------------------------------------------------------------------- #
# The TCP tests of tests/test_comm.py, with tensors                      #
# ---------------------------------------------------------------------- #
async def _deploy(edges, tokens, **kw):
    master = ConsensusMaster(edges, telemetry=kw.pop("telemetry", None),
                             weight_mode=kw.pop("weight_mode", "metropolis"),
                             convergence_eps=kw.pop("convergence_eps", 1e-6))
    host, port = await master.start()
    agents = [ConsensusAgent(t, host, port, **kw) for t in tokens]
    await asyncio.gather(*(a.start() for a in agents))
    return master, agents


async def _teardown(master, agents):
    await master.shutdown()
    await asyncio.gather(*(a.close(drain=0.1) for a in agents))


def test_run_once_chain_and_the_tensor_boundary():
    """Chain 1-2-3 with basis vectors: one run_once is W @ X; each result
    keeps its input's dtype and shape (a bf16 (1, 3) value comes back bf16)."""

    async def main():
        master, agents = await _deploy([("1", "2"), ("2", "3")], ["1", "2", "3"])
        vals = [torch.eye(3)[i].reshape(1, 3).clone() for i in range(3)]
        vals[2] = vals[2].to(torch.bfloat16)
        outs = await asyncio.gather(*(a.run_once(v) for a, v in zip(agents, vals)))
        expect = master.W @ np.eye(3)
        for i, o in enumerate(outs):
            assert o.shape == (1, 3) and o.dtype == vals[i].dtype and o.device.type == "cpu"
            np.testing.assert_allclose(o.float().numpy()[0], expect[i], atol=1e-2 if i == 2 else 1e-6)
        with pytest.raises(TypeError, match="torch tensors"):
            await agents[0].run_once(np.ones(3, np.float32))
        await _teardown(master, agents)

    run(main())


def test_lockstep_exchange_stays_live_with_frames_above_the_socket_buffers():
    """16 MB value frames on a 4-agent ring, far above loopback's socket
    buffers: the reference's inline response send deadlocks here (each
    agent parked in ``drain()`` answering the other), the port's detached
    sends complete ``run_once`` and a 2-iteration ``run_round``, equal to
    W @ X and W^2 @ X."""

    async def main():
        master, agents = await _deploy(RING4, [t for t, _ in RING4])
        xs = [torch.full((4_000_000,), float(i)) for i in range(4)]
        W = torch.as_tensor(master.W, dtype=torch.float64)
        ones = await asyncio.gather(*(a.run_once(x) for a, x in zip(agents, xs)))
        means = (W @ torch.arange(4.0, dtype=torch.float64)).float()
        for o, m in zip(ones, means):
            assert o.shape == (4_000_000,) and torch.all(torch.abs(o - m) <= 1e-6)
        twos = await asyncio.gather(*(a.run_round(x, 1.0, max_iterations=2)
                                      for a, x in zip(agents, xs)))
        means = (W @ W @ torch.arange(4.0, dtype=torch.float64)).float()
        for o, m in zip(twos, means):
            assert torch.all(torch.abs(o - m) <= 1e-6)
        await _teardown(master, agents)

    run(main())


def test_run_round_reaches_weighted_mean():
    async def main():
        tokens = ["1", "2", "3"]
        master, agents = await _deploy(TRIANGLE, tokens, convergence_eps=1e-7)
        weights = {"1": 1.0, "2": 2.0, "3": 3.0}
        vals = {t: 10.0 * torch.eye(3)[i] for i, t in enumerate(tokens)}
        outs = await asyncio.gather(*(a.run_round(vals[a.token], weights[a.token]) for a in agents))
        expect = sum(weights[t] * vals[t] for t in tokens) / sum(weights.values())
        for out in outs:
            torch.testing.assert_close(out, expect, atol=1e-3, rtol=0)
        await _teardown(master, agents)

    run(main())


def test_multiple_rounds_and_telemetry():
    async def main():
        telemetry = RecordingTelemetry()
        master, agents = await _deploy([("a", "b")], ["a", "b"], telemetry=telemetry,
                                       convergence_eps=1e-8)
        x = {"a": torch.zeros(2), "b": torch.ones(2)}
        for _ in range(3):
            outs = await asyncio.gather(*(a.run_round(x[a.token], 1.0) for a in agents))
            x = {a.token: outs[i] for i, a in enumerate(agents)}
        for out in outs:
            torch.testing.assert_close(out, torch.full((2,), 0.5), atol=1e-3, rtol=0)
        await agents[0].send_telemetry({"acc": 0.9})
        for _ in range(200):
            if telemetry.records:
                break
            await asyncio.sleep(0.01)
        assert telemetry.records[0][0] == "a" and telemetry.records[0][1]["acc"] == 0.9
        await _teardown(master, agents)

    run(main())


def test_bf16_wire_round_and_sdp_weights():
    async def main():
        tokens = ["1", "2", "3", "4"]
        master, agents = await _deploy(RING4, tokens, bf16_wire=True, convergence_eps=1e-3)
        outs = await asyncio.gather(*(a.run_round(torch.full((8,), float(i)), 1.0)
                                      for i, a in enumerate(agents)))
        for out in outs:
            torch.testing.assert_close(out, torch.full((8,), 1.5), atol=0.05, rtol=0)
        await _teardown(master, agents)
        # weight_mode="sdp": the chain's optimal weights are 1/2 an edge.
        master, agents = await _deploy([("1", "2"), ("2", "3")], tokens[:3], weight_mode="sdp")
        i, j = master._index["1"], master._index["2"]
        assert abs(master.W[i, j] - 0.5) < 1e-2
        outs = await asyncio.gather(*(a.run_once(torch.eye(3)[k]) for k, a in enumerate(agents)))
        torch.testing.assert_close(torch.stack(outs).sum(0), torch.ones(3), atol=1e-5, rtol=0)
        await _teardown(master, agents)

    run(main())


def test_rejects_unknown_token_and_dead_peer_raises():
    async def main():
        master = ConsensusMaster([("1", "2")])
        host, port = await master.start()
        rogue = ConsensusAgent("zz", host, port)
        with pytest.raises(ConnectionError, match="unknown agent token"):
            await rogue.start(timeout=5)
        await rogue.close()
        await master.shutdown()
        master, agents = await _deploy([("1", "2")], ["1", "2"])
        await agents[1].close()
        with pytest.raises((ConnectionError, ShutdownError)):
            await asyncio.wait_for(agents[0].run_once(torch.ones(2)), 10)
        await master.shutdown()
        await agents[0].close()

    run(main())


def test_run_once_after_run_round_stays_synchronized():
    async def main():
        master, agents = await _deploy(TRIANGLE, ["1", "2", "3"])
        await asyncio.gather(*(a.run_round(torch.full((4,), float(i)), 1.0)
                               for i, a in enumerate(agents)))
        outs = await asyncio.gather(*(a.run_once(torch.eye(3)[i]) for i, a in enumerate(agents)))
        expect = master.W @ np.eye(3)
        for i, o in enumerate(outs):
            np.testing.assert_allclose(o.numpy(), expect[i], atol=1e-6)
        await _teardown(master, agents)

    run(main())


def _topk(frac):
    def f(v):
        k = max(1, int(v.size * frac))
        out = np.zeros_like(v)
        idx = np.argsort(np.abs(v))[-k:]
        out[idx] = v[idx]
        return out
    return f


@pytest.mark.parametrize("wire", [{}, {"bf16_wire": True}, {"int8_wire": True}])
def test_choco_rounds_converge_with_sparse_wire(wire):
    async def main():
        master, agents = await _deploy(TRIANGLE, ["1", "2", "3"], sparse_wire=True, **wire)
        rng = np.random.default_rng(0)
        vals = [t32(rng.normal(size=16)) for _ in range(3)]
        mean = torch.stack(vals).mean(0)
        xs = list(vals)
        for _ in range(60):
            xs = list(await asyncio.gather(*(a.run_choco_once(xs[i], _topk(0.25), gamma=0.4)
                                             for i, a in enumerate(agents))))
        atol = {0: 1e-3}.get(len(wire), 5e-2)
        for x in xs:
            torch.testing.assert_close(x, mean, atol=atol, rtol=0)
        with pytest.raises(ValueError, match="shape"):
            await agents[0].run_choco_once(torch.ones(8), lambda v: v)
        assert agents[0].counters.get("sparse_frames", 0) > 0
        await _teardown(master, agents)

    run(main())


def test_choco_tree_fused_halves_frames_and_guards_its_spec():
    comp = top_k_compressor(0.5)

    async def once(fused, budget="per-leaf", rounds=30):
        master, agents = await _deploy(TRIANGLE, ["1", "2", "3"], sparse_wire=True)
        trees = [_tree(i, "p") for i in range(3)]
        mean = np.mean([tree_to_flat(t)[0] for t in trees], axis=0)
        base = sum(a.wire_stats()["frames_sent"] for a in agents)
        xs = list(trees)
        for _ in range(rounds):
            xs = list(await asyncio.gather(*(a.run_choco_tree(xs[i], comp, gamma=0.4,
                                                              fused=fused, budget=budget)
                                             for i, a in enumerate(agents))))
        for t in xs:
            assert t["h"].dtype == torch.bfloat16 and t["w"].shape == (8, 4)
            np.testing.assert_allclose(tree_to_flat(t)[0], mean, atol=3e-2)
        frames = (sum(a.wire_stats()["frames_sent"] for a in agents) - base) / rounds
        counters = dict(agents[0].counters)
        if budget == "global":
            with pytest.raises(ValueError, match="structure"):
                await agents[0].run_choco_tree({"other": torch.ones(4)}, comp)
            with pytest.raises(ValueError, match="budget"):
                await agents[0].run_choco_tree(xs[0], comp, budget="per-bucket")
        m_frames = master.wire_stats()["frames_sent"]
        await _teardown(master, agents)
        return frames, counters, m_frames

    async def main():
        f_fused, c_fused, m_fused = await once(True)
        f_leaf, c_leaf, m_leaf = await once(False)
        assert f_fused * 2 <= f_leaf
        assert c_fused["fused_frames"] > 0 and c_fused["choco_tree_rounds"] == 30
        assert c_leaf.get("fused_frames", 0) == 0 and c_leaf["choco_tree_leaf_rounds"] == 90
        assert m_fused == m_leaf
        await once(True, budget="global", rounds=40)

    run(main())
