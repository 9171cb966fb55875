"""The sharded async, robust and async-robust rounds
(``ConsensusEngine(mesh=)``'s ``mix_async``, ``mix_robust`` and
``mix_async_robust``, one agent a gloo rank on the CPU) against the JAX
package's ``mesh=`` routes on ``make_agent_mesh(4)`` and the port's dense
route, on ``tests/test_robust.py``'s mixed-dtype state (float32 "w" and
"b" beside a bfloat16 "h").  The 4 ranks are spawned once for the module
(``sharded_ranks.py``).

Limits: float32 within 2e-6 (the reference's mixing tolerance); the
bfloat16 leaf within one bfloat16 ulp at the state's unit scale (2^-7,
relative and absolute, as ``test_torch_sharded_engine.py``): the mesh
routes accumulate each partner term in the leaf's dtype, as the
reference's mesh route does, while the dense route does one float32
GEMM, and the two round differently by up to one ulp of the terms (the
reference's own ``test_sharded_robust_matches_dense`` sees that ulp);
the masses within 1e-5 relative; ages and round counters exactly.  At
the neutral knobs (``radius=inf``, ``trim=0``) each robust round is the
plain round bit for bit, with mass 0.0.

The async-robust rounds are held against the JAX package's dense route
and the port's: the reference's ``mesh=`` program of them does not trace
under the installed JAX (its mass carry enters the ``fori_loop``
unvarying and leaves varying over ``agents``, which shard_map's vma
check rejects), a fault of the reference that ROADMAP.md records.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.consensus import make_agent_mesh
from distributed_learning_tpu_torch.parallel import ConsensusEngine
from sharded_ranks import (
    ASYNC,
    ASYNC_ROBUST,
    ASYNC_ROBUST_KNOBS,
    NEUTRAL,
    ROBUST,
    Ranks,
    _matrix,
    _mixed_state,
)

N = 4
TOL = 2e-6
BF16_RTOL = 2.0 ** -7
MASS_RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    x0 = _mixed_state(N)
    # The ranks run while the first test compiles the JAX side.
    return x0, Ranks("async_robust", N, {f"x_{k}": v for k, v in x0.items()})


def _jax_state(x0):
    return {k: jnp.asarray(v).astype(jnp.bfloat16 if k == "h" else jnp.float32)
            for k, v in x0.items()}


def _torch_state(x0):
    return {k: torch.tensor(v).to(torch.bfloat16 if k == "h" else torch.float32)
            for k, v in x0.items()}


def _rows(res, key):
    return {k: np.concatenate([r[key][k] for r in res]) for k in res[0][key]}


def _close(got, want, what):
    for k, g in got.items():
        w = want[k]
        w = (w.to(torch.float32).numpy() if isinstance(w, torch.Tensor)
             else np.asarray(jnp.asarray(w).astype(jnp.float32)))
        if k == "h":
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=BF16_RTOL,
                                       err_msg=f"{what}.{k}")
        else:
            np.testing.assert_allclose(g, w, atol=TOL, rtol=0, err_msg=f"{what}.{k}")


def _engines(m):
    W = _matrix(m)
    return JEngine(W, mesh=make_agent_mesh(N)), ConsensusEngine(W, device="cpu")


@pytest.mark.parametrize("name", list(ASYNC))
def test_async_rounds_equal_the_jax_mesh_route_and_the_dense_route(world, name):
    """Three rounds, then two more with the carry threaded through."""
    x0, ranks = world
    periods, tau = ASYNC[name]
    jeng, deng = _engines("ring")
    jx, jst = jeng.mix_async(jeng.shard(_jax_state(x0)), tau=tau, periods=periods, times=3)
    jx2, jst2 = jeng.mix_async(jx, jst, tau=tau, periods=periods, times=2)
    res = ranks.results()
    dx, dst = deng.mix_async(_torch_state(x0), tau=tau, periods=periods, times=3)
    dx2, dst2 = deng.mix_async(dx, dst, tau=tau, periods=periods, times=2)
    for want, tag in ((jx, "jax"), (dx, "dense")):
        _close(_rows(res, f"{name}_x"), want, f"{name} {tag}")
    for want, st, tag in ((jx2, jst2, "jax"), (dx2, dst2, "dense")):
        _close(_rows(res, f"{name}_x2"), want, f"{name} x2 {tag}")
        _close(_rows(res, f"{name}_pub"), st.pub, f"{name} pub {tag}")
        for r in res:  # the ages and the round counter are replicated
            np.testing.assert_array_equal(r[f"{name}_age"], np.asarray(st.age))
            assert r[f"{name}_rnd"] == int(st.rnd) == 5


def _cases(x0):
    """(tag, state, rounds): one round on the mixed state, three on its
    float32 leaves.  A clip scale reads every bucket, so the bfloat16
    leaf's ulp (the mesh and the dense route round it differently) would
    reach the float32 leaves through the next round's scale: the
    reference's own mesh and dense routes differ by 3e-4 there after two
    rounds."""
    x32 = {k: v for k, v in x0.items() if k != "h"}
    return (("1", x0, 1), ("3", x32, 3))


@pytest.mark.parametrize("name", list(ROBUST))
def test_robust_rounds_equal_the_jax_mesh_route_and_the_dense_route(world, name):
    x0, res = world[0], world[1].results()
    m, spec = ROBUST[name]
    jeng, deng = _engines(m)
    for tag, x, times in _cases(x0):
        jx, jmass = jeng.mix_robust(jeng.shard(_jax_state(x)), spec, times=times)
        dx, dmass = deng.mix_robust(_torch_state(x), spec, times=times)
        _close(_rows(res, f"{name}_x{tag}"), jx, f"{name} x{tag} jax")
        _close(_rows(res, f"{name}_x{tag}"), dx, f"{name} x{tag} dense")
        for r in res:  # every rank reads the total over the agents
            for want in (float(jmass), float(dmass)):
                assert r[f"{name}_mass{tag}"] == pytest.approx(want, rel=MASS_RTOL, abs=1e-12)


@pytest.mark.parametrize("name", list(NEUTRAL))
def test_neutral_knobs_are_the_plain_round_bit_for_bit(world, name):
    """On every rank the robust rounds at ``radius=inf`` / ``trim=0``
    equal the sharded plain rounds bit for bit, and redirect nothing."""
    res = world[1].results()
    for r in res:
        assert r[f"{name}_is_plain"] and r[f"{name}_mass1"] == 0.0
    # A defense with bite is not the plain round (the check can fail).
    assert not all(r["clip_is_plain"] for r in res)


@pytest.mark.parametrize("name", list(ASYNC_ROBUST))
def test_async_robust_rounds_equal_the_jax_dense_route_and_the_port_dense_route(world, name):
    x0, res = world[0], world[1].results()
    m, spec = ASYNC_ROBUST[name]
    periods, tau = ASYNC_ROBUST_KNOBS
    jeng, deng = JEngine(_matrix(m)), ConsensusEngine(_matrix(m), device="cpu")
    for tag, x, times in _cases(x0):
        jx, jst, jmass = jeng.mix_async_robust(_jax_state(x), spec=spec, tau=tau,
                                               periods=periods, times=times)
        dx, dst, dmass = deng.mix_async_robust(_torch_state(x), spec=spec, tau=tau,
                                               periods=periods, times=times)
        for want, st, mass, ref in ((jx, jst, jmass, "jax"), (dx, dst, dmass, "dense")):
            _close(_rows(res, f"{name}_x{tag}"), want, f"{name} x{tag} {ref}")
            _close(_rows(res, f"{name}_pub{tag}"), st.pub, f"{name} pub{tag} {ref}")
            for r in res:
                assert r[f"{name}_mass{tag}"] == pytest.approx(float(mass), rel=MASS_RTOL,
                                                               abs=1e-12)


def test_async_robust_at_the_neutral_knobs_is_mix_async_bit_for_bit(world):
    res = world[1].results()
    for r in res:
        assert r["async_neutral_bitwise"] and r["async_neutral_mass"] == 0.0
