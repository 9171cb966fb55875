"""The port's sharded consensus engine (``ConsensusEngine(mesh=)``, one
agent a gloo rank on the CPU) against the JAX package's engine on
``make_agent_mesh(n)`` and its dense route, on the same seeded numpy
state.

Three worlds, each spawned once for its whole battery
(``sharded_ranks.py``): n 4 (every route: matchings, the per-call matrix
on the ring and the gathered row, eps stopping, Chebyshev, the exact
average, the deviations, the weighted round, sharded pairwise gossip,
the obs counters and a dropped-message control), n 6 with an
Erdos-Renyi matrix whose ring decomposition needs two relay hops, and
n 5, whose matchings leave an agent unmatched.  Tolerance 2e-6 on
float32 state (the reference's mixing tolerance, ``tests/test_consensus.py``),
one bfloat16 ulp (2^-7 relative) on the bfloat16 bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_learning_tpu.parallel import Topology
from distributed_learning_tpu.parallel.consensus import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.consensus import make_agent_mesh
from distributed_learning_tpu.parallel.schedule import chebyshev_omegas
from distributed_learning_tpu.parallel.topology import gamma as exact_gamma
from sharded_ranks import Ranks

TOL = 2e-6
BF16_RTOL = 2.0 ** -7
EPS = 1e-4


def _inputs(n, W2, seed=0, full=True):
    rng = np.random.default_rng(seed + n)
    W = Topology.ring(n).metropolis_weights()
    inp = dict(W=W, W2=W2, eps=np.float64(EPS),
               x_a=rng.normal(size=(n, 33)).astype(np.float32),
               x_b=rng.normal(size=(n, 7, 3)).astype(np.float32),
               x_c=rng.normal(size=(n, 6)).astype(np.float32))
    if full:
        inp.update(om=chebyshev_omegas(exact_gamma(W), 4).astype(np.float32),
                   om2=chebyshev_omegas(exact_gamma(W2), 4).astype(np.float32),
                   weights=np.arange(1, n + 1).astype(np.float32))
    return inp


def _state(inp, keys=("a", "b", "c")):
    return {k: (jnp.asarray(inp[f"x_{k}"]).astype(jnp.bfloat16) if k == "c"
                else jnp.asarray(inp[f"x_{k}"])) for k in keys}


def _rows(results, key):
    """A dict result of every rank, stacked in agent order."""
    return {k: np.concatenate([r[key][k] for r in results]) for k in results[0][key]}


def _close(got, want, what):
    for k, g in got.items():
        w = np.asarray(jnp.asarray(want[k]).astype(jnp.float32))
        if k == "c":
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_RTOL, err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"{what}.{k}")


# The small worlds (n, Erdos-Renyi seed): two relay hops at n 6, odd n 5.
SMALL = {"ring_two_hops_n6": (6, 4), "odd_n5": (5, 0)}


@pytest.fixture(scope="module")
def worlds():
    """Every world's ranks, started together once for the module."""
    n = 4
    W2 = Topology.erdos_renyi(n, 0.6, seed=1).metropolis_weights()
    inp = _inputs(n, W2)
    jeng = JEngine(inp["W"], mesh=make_agent_mesh(n))
    pool = jeng._random_maximal_matchings(np.argwhere(np.abs(np.triu(jeng.W, 1)) > 1e-12))
    key = jax.random.key(5)
    inp["draws"] = np.asarray([int(jax.random.randint(jax.random.fold_in(key, r), (), 0,
                                                      len(pool))) for r in range(6)])
    out = {"world4": (inp, Ranks("engine", n, inp), key)}
    for name, (m, seed) in SMALL.items():
        small = _inputs(m, Topology.erdos_renyi(m, 0.5, seed=seed).metropolis_weights(),
                        full=False)
        out[name] = (small, Ranks("engine", m, small))
    return out


@pytest.fixture(scope="module")
def world4(worlds):
    inp, ranks, key = worlds["world4"]
    return inp, ranks.results(), key


@pytest.mark.parametrize("sharded", [True, False], ids=["jax_mesh", "jax_dense"])
def test_routes_equal_the_jax_engine(world4, sharded):
    inp, res, key = world4
    n = 4
    jeng = JEngine(inp["W"], mesh=make_agent_mesh(n) if sharded else None)
    x = jeng.shard(_state(inp))
    xf = {k: v for k, v in x.items() if k != "c"}
    _close(_rows(res, "mix"), jeng.mix(x, 3), "mix")
    for route in ("ring", "allgather", "auto"):
        _close(_rows(res, f"mix_with_{route}"), jeng.mix_with(x, inp["W2"], 2, route=route),
               f"mix_with_{route}")
    s, t, r = jeng.mix_until(xf, eps=EPS)
    _close(_rows(res, "mix_until"), s, "mix_until")
    assert res[0]["mix_until_t"] == int(t) and res[0]["mix_until_res"] == pytest.approx(
        float(r), abs=TOL)
    s, t, r = jeng.mix_until_with(xf, inp["W2"], eps=EPS, route="ring")
    _close(_rows(res, "mix_until_with"), s, "mix_until_with")
    assert res[0]["mix_until_with_t"] == int(t)
    _close(_rows(res, "cheby"), jeng.mix_chebyshev(x, 4), "cheby")
    _close(_rows(res, "cheby_with"),
           jeng.mix_chebyshev_with(x, inp["W2"], inp["om2"], route="ring"), "cheby_with")
    _close(_rows(res, "gavg"), jeng.global_average(x), "global_average")
    for r in res:
        np.testing.assert_allclose(r["devs"], np.asarray(jeng.deviations(xf)), atol=TOL)
        assert r["maxdev"] == pytest.approx(float(jeng.max_deviation(xf)), abs=TOL)
        assert r["maxstd"] == pytest.approx(float(jeng.max_std(xf)), abs=TOL)
    _close(_rows(res, "run_round"), jeng.run_round(xf, inp["weights"]), "run_round")
    if sharded:  # the matching pool and its draws are the sharded model's
        assert res[0]["pool"] == jeng._random_maximal_matchings(
            np.argwhere(np.abs(np.triu(jeng.W, 1)) > 1e-12))
        _close(_rows(res, "pairwise"), jeng.mix_pairwise(x, key, len(inp["draws"])),
               "pairwise")


def test_gloo_ranks_and_the_obs_counters(world4):
    _, res, _ = world4
    assert [r["agent"] for r in res] == [0, 1, 2, 3]
    assert {r["backend"] for r in res} == {"gloo"}
    assert res[0]["k_hops"] == 2 and res[0]["route_auto"] == "allgather"  # 2 * 2 >= n - 1
    for r in res:  # three rounds, one message a bucket and matching
        assert r["rounds_run"] == 3
        assert r["bytes_mixed"] == 3 * r["matched"] * r["bucket_bytes"]


def test_a_dropped_message_fails_the_comparison(world4):
    """The control: agent 0 loses one matching's message in one round;
    its result leaves the tolerance, the clean round's does not."""
    inp, res, _ = world4
    want = JEngine(inp["W"], mesh=make_agent_mesh(4)).mix(_state(inp, ("a", "b")), 1)
    _close({k: v for k, v in _rows(res, "mix1").items() if k != "c"}, want, "mix1")
    with pytest.raises(AssertionError):
        _close({k: v for k, v in _rows(res, "dropped").items() if k != "c"}, want, "dropped")


@pytest.mark.parametrize("name", list(SMALL))
def test_ring_relays_and_unmatched_agents(worlds, name):
    """n 6: an Erdos-Renyi matrix with edges two ring steps apart, so the
    ring route relays twice (and ``auto`` takes it); n 5: a ring whose
    matchings each leave one agent out."""
    n = SMALL[name][0]
    inp, ranks = worlds[name]
    res = ranks.results()
    jeng = JEngine(inp["W"], mesh=make_agent_mesh(n))
    x = jeng.shard(_state(inp))
    xf = {k: v for k, v in x.items() if k != "c"}
    if n == 6:
        assert res[0]["k_hops"] == 2 and res[0]["route_auto"] == "ring"  # 2 * 2 < n - 1
    else:
        assert jeng.schedule.num_rounds == 3  # an odd ring: each matching leaves one out
    _close(_rows(res, "mix"), jeng.mix(x, 3), "mix")
    want = jeng.mix_with(x, inp["W2"], 2, route="ring")
    for route in ("ring", "allgather", "auto"):
        _close(_rows(res, f"mix_with_{route}"), want, f"mix_with_{route}")
    s, t, _ = jeng.mix_until_with(xf, inp["W2"], eps=EPS, route="ring")
    _close(_rows(res, "mix_until_with"), s, "mix_until_with")
    assert res[0]["mix_until_with_t"] == int(t)
