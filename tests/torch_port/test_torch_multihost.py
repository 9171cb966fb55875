"""``parallel/multihost.py`` of the port: the ring order on stand-in
devices (as ``tests/test_multihost.py`` holds the reference's), the
backend rule, and four gloo CPU ranks (spawned once) that join the group
from the environment, build the hybrid agent mesh, refuse a rank without
a card or a mesh of the wrong size, and gossip to the global mean with
eps stopping (the reference's ``test_four_process_gossip``), equal to
the JAX engine on ``make_agent_mesh(4)`` within 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from distributed_learning_tpu.parallel import Topology
from distributed_learning_tpu.parallel.consensus import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.consensus import make_agent_mesh
from distributed_learning_tpu_torch.parallel import multihost
from sharded_ranks import Ranks


class _FakeDev:
    def __init__(self, process_index, slice_index, id_):
        self.process_index, self.slice_index, self.id = process_index, slice_index, id_


def _cross_edges(order):
    key = lambda d: (d.process_index, getattr(d, "slice_index", 0) or 0)  # noqa: E731
    n = len(order)
    return sum(1 for i in range(n) if key(order[i]) != key(order[(i + 1) % n]))


@pytest.mark.parametrize("procs,per,slices", [(2, 4, True), (4, 2, True), (2, 4, False)])
def test_ring_order_keeps_hosts_and_slices_contiguous(procs, per, slices):
    devs = [_FakeDev(p, p if slices else None, p * per + i) for p in range(procs)
            for i in range(per)]
    rng = np.random.default_rng(procs)
    order = multihost.order_devices_for_ring([devs[i] for i in rng.permutation(len(devs))])
    assert [d.id for d in order] == list(range(procs * per))
    assert _cross_edges(order) == procs


def test_ring_order_reads_rank_devices():
    devs = [multihost.RankDevice(h, None, r) for r, h in ((3, 1), (0, 0), (2, 1), (1, 0))]
    assert [d.id for d in multihost.order_devices_for_ring(devs)] == [0, 1, 2, 3]


def test_default_backend_is_gloo_for_cpu_ranks():
    assert multihost.default_backend("cpu") == "gloo"
    assert multihost.default_backend(None, 4) == "gloo"  # no card on this host


@pytest.fixture(scope="module")
def world():
    n = 4
    inp = dict(W=Topology.ring(n).metropolis_weights(),
               W2=Topology.erdos_renyi(n, 0.6, seed=3).metropolis_weights(),
               x=np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32))
    return inp, Ranks("multihost", n, inp).results()


def test_ranks_join_from_the_environment_and_build_the_mesh(world):
    _, res = world
    for r, out in enumerate(res):
        assert out["backend"] == out["again"] == out["default_cpu"] == "gloo"  # idempotent
        assert out["ranks"] == (0, 1, 2, 3) and out["agent"] == r
        assert out["shape"] == {"agents": 4} and out["local"] == (r,)


def test_ranks_refuse_a_hidden_device_and_wrong_sizes(world):
    for out in world[1]:
        assert out["refused"]["no_card"].startswith("RuntimeError") and (
            "device='cpu'" in out["refused"]["no_card"])
        assert "need 5 ranks" in out["refused"]["size"]
        assert "one rank per agent" in out["refused"]["engine_size"]


def test_four_rank_gossip_reaches_the_mean_as_the_jax_mesh(world):
    inp, res = world
    mixed = np.concatenate([r["mixed"] for r in res])
    assert res[0]["res"] < 1e-5 and 0 < res[0]["rounds"] < 800
    np.testing.assert_allclose(mixed, np.tile(inp["x"].mean(0), (4, 1)), atol=1e-3)
    jeng = JEngine(inp["W"], mesh=make_agent_mesh(4))
    out, rounds, _ = jeng.mix_until(jeng.shard(jnp.asarray(inp["x"])), eps=1e-5, max_rounds=800)
    assert res[0]["rounds"] == int(rounds)
    np.testing.assert_allclose(mixed, np.asarray(out), atol=2e-6, rtol=0)
    np.testing.assert_allclose(np.concatenate([r["mix_with"] for r in res]),
                               np.asarray(jeng.mix_with(out, inp["W2"], 2, route="allgather")),
                               atol=2e-6, rtol=0)
