"""DSGT, EXTRA and push-sum of the port with ``mesh=`` (one agent a gloo
rank on the CPU, spawned once for the module) against the JAX package's
engines on ``make_agent_mesh(4)``: the label-skewed Titanic logreg of
``test_torch_tracking_extra.py`` (Metropolis ring, 60 steps) and a
directed 4-cycle with a chord each way for push-sum.

Tolerances: DSGT and EXTRA state and residual trace within 1e-5 (the
port's dense tracking tests' limit, float32 sums in another order over
contracting steps); push-sum estimates within 1e-5 (the reference's
``test_sharded_matches_dense_fixed_rounds``); the tracking invariant and
the push-sum totals within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_learning_tpu.data.titanic import load_titanic, split_data
from distributed_learning_tpu.models import logreg as jlogreg
from distributed_learning_tpu.parallel import ExtraEngine as JExtra
from distributed_learning_tpu.parallel import GradientTrackingEngine as JTracking
from distributed_learning_tpu.parallel import PushSumEngine as JPushSum
from distributed_learning_tpu.parallel import Topology
from distributed_learning_tpu.parallel.consensus import make_agent_mesh
from distributed_learning_tpu.parallel.pushsum import push_sum_matrix
from sharded_ranks import Ranks

N, TAU, ALPHA, STEPS = 4, 1e-2, 0.5, 60
TOL = 1e-5


def _titanic():
    X_tr, y_tr, _, _ = load_titanic()
    order = np.argsort(y_tr)
    shards = split_data(X_tr[order], y_tr[order], N)
    m = min(len(shards[i][0]) for i in range(N))
    X = np.stack([shards[i][0][:m] for i in range(N)]).astype(np.float32)
    y = np.stack([shards[i][1][:m] for i in range(N)]).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def world():
    X, y = _titanic()
    P = push_sum_matrix([(i, (i + 1) % N) for i in range(N)] + [(0, 2), (2, 1)], N)
    inp = dict(X=X, y=y, tau=np.float64(TAU), alpha=np.float64(ALPHA), steps=np.int64(STEPS),
               W=Topology.ring(N).metropolis_weights(), P=P,
               v=np.random.default_rng(3).normal(size=(N, 5)).astype(np.float32),
               ps_w=np.arange(1.0, N + 1.0).astype(np.float32), ps_times=np.int64(7),
               ps_eps=np.float64(1e-6))
    ranks = Ranks("tracking", N, inp)
    XJ, YJ = jnp.asarray(X), jnp.asarray(y)

    def grad(w, i, step):
        return jax.grad(jlogreg.loss_fn)(w, XJ[i], YJ[i], TAU)

    return inp, ranks.results(), grad


def _stacked(res, key):
    return np.concatenate([r[key] for r in res])


def test_dsgt_with_mesh_equals_the_jax_mesh_route(world):
    inp, res, grad = world
    eng = JTracking(inp["W"], grad, learning_rate=ALPHA, mesh=make_agent_mesh(N))
    st, trace = eng.run(eng.init(jnp.zeros((N, inp["X"].shape[-1]), jnp.float32)), STEPS)
    for f in ("x", "y", "g"):
        np.testing.assert_allclose(_stacked(res, f"dsgt_{f}"), np.asarray(getattr(st, f)),
                                   atol=TOL, rtol=0, err_msg=f)
    for r in res:  # the trace is the all-reduced residual: the same on every rank
        np.testing.assert_allclose(r["dsgt_trace"], np.asarray(trace), atol=TOL, rtol=0)
        assert r["dsgt_gap"] <= TOL


@pytest.mark.parametrize("every", [8, 2])
def test_extra_with_mesh_and_its_fused_guard_equal_the_jax_mesh_route(world, every):
    inp, res, grad = world
    eng = JExtra(inp["W"], grad, learning_rate=ALPHA, project_every=every,
                 mesh=make_agent_mesh(N))
    st, trace = eng.run(eng.init(jnp.zeros((N, inp["X"].shape[-1]), jnp.float32)), STEPS)
    for f in ("x", "c", "d", "r", "g_prev"):
        np.testing.assert_allclose(_stacked(res, f"extra{every}_{f}"),
                                   np.asarray(getattr(st, f)), atol=TOL, rtol=0, err_msg=f)
    np.testing.assert_allclose(res[0][f"extra{every}_trace"], np.asarray(trace), atol=TOL,
                               rtol=0)


def test_push_sum_with_mesh_equals_the_jax_mesh_route_and_keeps_its_totals(world):
    inp, res, _ = world
    eng = JPushSum(inp["P"], mesh=make_agent_mesh(N))
    assert eng._use_fwd and eng._use_bwd  # the chords make both ring directions live
    v = eng.shard(jnp.asarray(inp["v"]))
    want = eng.mix(v, int(inp["ps_times"]), weights=inp["ps_w"])
    np.testing.assert_allclose(_stacked(res, "ps_mix"), np.asarray(want), atol=TOL, rtol=0)
    est, t, r = eng.mix_until(v, eps=1e-6, weights=inp["ps_w"])
    np.testing.assert_allclose(_stacked(res, "ps_until"), np.asarray(est), atol=TOL, rtol=0)
    assert res[0]["ps_t"] == int(t) and res[0]["ps_res"] < 1e-6
    for rk in res:  # totals: sum(x w) and sum(w) kept across the ranks
        assert float(rk["ps_num_total"]) <= TOL
        assert rk["ps_den_total"] == pytest.approx(float(inp["ps_w"].sum()), abs=TOL)
