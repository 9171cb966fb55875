"""Gradient tracking (DSGT) and EXTRA of the PyTorch port against the JAX
package's engines, on the label-skewed synthetic Titanic logreg of
``examples/dsgt_titanic.py`` (4 agents, Metropolis ring) and the
heterogeneous quadratic suite of ``examples/gradient_tracking.py``.

Both oracle forms are held: the reference's per-agent oracle (looped) and
the stacked oracle (one call for every agent).  Tolerances: state and
residual trace within 1e-5 after 200 steps (float32 GEMMs and
reductions summed in another order, over 200 contracting steps); the
tracking invariant within 1e-5; EXTRA's float32 optimality gap on the
quadratic suite within 1e-5 (the reference's measured floor is ~2.4e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.data.titanic import load_titanic, split_data
from distributed_learning_tpu.models import logreg as jlogreg
from distributed_learning_tpu.parallel import ExtraEngine as JExtra
from distributed_learning_tpu.parallel import GradientTrackingEngine as JTracking
from distributed_learning_tpu_torch.models import logreg as tlogreg
from distributed_learning_tpu_torch.parallel import (
    ExtraEngine,
    GradientTrackingEngine,
    Topology,
)
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

N, TAU, ALPHA, STEPS = 4, 1e-2, 0.5, 200
TOL = 1e-5


def _titanic():
    """Label-sorted contiguous shards, trimmed to the shortest."""
    X_tr, y_tr, _, _ = load_titanic()
    order = np.argsort(y_tr)
    shards = split_data(X_tr[order], y_tr[order], N)
    m = min(len(shards[i][0]) for i in range(N))
    X = np.stack([shards[i][0][:m] for i in range(N)]).astype(np.float32)
    y = np.stack([shards[i][1][:m] for i in range(N)]).astype(np.float32)
    return X, y


X_NP, Y_NP = _titanic()
DIM = X_NP.shape[-1]
RING = Topology.ring(N).metropolis_weights()
XJ, YJ = jnp.asarray(X_NP), jnp.asarray(Y_NP)
XT, YT = torch.from_numpy(X_NP), torch.from_numpy(Y_NP)


def jax_grad(w, i, step):
    return jax.grad(jlogreg.loss_fn)(w, XJ[i], YJ[i], TAU)


def _autograd(w, X, y):
    with torch.enable_grad():
        w = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(tlogreg.loss_fn(w, X, y, TAU).sum(), w)
    return g


def port_grad(w, i, step):
    return _autograd(w, XT[i], YT[i])


def port_grads_stacked(w, step):
    return _autograd(w, XT, YT)


def _port_engine(cls, stacked, **kw):
    if stacked:
        return cls(RING, port_grads_stacked, stacked_grads=True, device="cpu", **kw)
    return cls(RING, port_grad, device="cpu", **kw)


def _assert_states(ours, theirs, fields):
    for f in fields:
        np.testing.assert_allclose(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)),
                                   atol=TOL, rtol=0, err_msg=f)
    assert ours.step == int(theirs.step)


_LR = {
    "constant": (ALPHA, ALPHA),
    "scheduled": (lambda step: 0.5 / math.sqrt(1.0 + step),
                  lambda step: 0.5 / jnp.sqrt(1.0 + step)),
}


@pytest.mark.parametrize("stacked", [False, True], ids=["per_agent", "stacked"])
@pytest.mark.parametrize("lr", list(_LR), ids=list(_LR))
def test_dsgt_titanic_matches_jax(lr, stacked):
    ours_lr, jax_lr = _LR[lr]
    eng = _port_engine(GradientTrackingEngine, stacked, learning_rate=ours_lr)
    jeng = JTracking(RING, jax_grad, learning_rate=jax_lr)
    x0 = np.zeros((N, DIM), np.float32)
    s0, j0 = eng.init(torch.from_numpy(x0)), jeng.init(jnp.asarray(x0))
    _assert_states(s0, j0, ("x", "y", "g"))
    state, trace = eng.run(s0, STEPS)
    jstate, jtrace = jeng.run(j0, STEPS)
    _assert_states(state, jstate, ("x", "y", "g"))
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), atol=TOL, rtol=0)
    assert eng.tracker_sum_gap(state) <= TOL
    assert float(trace[-1]) < float(trace[0])
    # run leaves its input state as it was
    np.testing.assert_array_equal(s0.x.numpy(), x0)


@pytest.mark.parametrize("stacked", [False, True], ids=["per_agent", "stacked"])
@pytest.mark.parametrize("project_every", [8, 2])
def test_extra_titanic_matches_jax(project_every, stacked):
    eng = _port_engine(ExtraEngine, stacked, learning_rate=ALPHA, project_every=project_every)
    jeng = JExtra(RING, jax_grad, learning_rate=ALPHA, project_every=project_every)
    x0 = np.zeros((N, DIM), np.float32)
    s0, j0 = eng.init(torch.from_numpy(x0)), jeng.init(jnp.asarray(x0))
    _assert_states(s0, j0, ("x", "c", "d", "r", "g_prev"))
    state, trace = eng.run(s0, STEPS)
    jstate, jtrace = jeng.run(j0, STEPS)
    _assert_states(state, jstate, ("x", "c", "d", "r", "g_prev"))
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), atol=TOL, rtol=0)


def test_dsgt_dict_state_with_schedule_matches_jax():
    """A ``{name: tensor}`` state and a scheduled step (the reference's
    pytree test): every tensor of the state against the JAX engine."""
    rng = np.random.default_rng(7)
    A = rng.normal(size=(N, 5, 5)).astype(np.float32)
    A = np.einsum("nij,nkj->nik", A, A) + np.eye(5, dtype=np.float32)[None]
    b = rng.normal(size=(N, 5)).astype(np.float32)
    At, bt, Aj, bj = torch.from_numpy(A), torch.from_numpy(b), jnp.asarray(A), jnp.asarray(b)
    W = Topology.complete(N).metropolis_weights()
    eng = GradientTrackingEngine(
        W, lambda p, i, s: {"w": At[i] @ p["w"] - bt[i], "c": p["c"]},
        learning_rate=lambda step: 1e-2 / math.sqrt(1.0 + step), device="cpu")
    jeng = JTracking(W, lambda p, i, s: {"w": Aj[i] @ p["w"] - bj[i], "c": p["c"]},
                     learning_rate=lambda step: 1e-2 / jnp.sqrt(1.0 + step))
    x0 = {"w": np.zeros((N, 5), np.float32), "c": np.ones((N, 1), np.float32)}
    state, trace = eng.run(eng.init({k: torch.from_numpy(v) for k, v in x0.items()}), 100)
    jstate, jtrace = jeng.run(jeng.init({k: jnp.asarray(v) for k, v in x0.items()}), 100)
    for f in ("x", "y", "g"):
        for k in x0:
            np.testing.assert_allclose(getattr(state, f)[k].numpy(),
                                       np.asarray(getattr(jstate, f)[k]), atol=TOL, rtol=0)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), atol=TOL, rtol=0)


def _quadratics(n=8, dim=6, seed=0):
    """The reference's heterogeneous quadratic suite: f_i(x) = 0.5 x'A_i x
    - b_i'x; the global optimum solves (sum A_i) x = sum b_i."""
    rng = np.random.default_rng(seed)
    As, bs = [], []
    for i in range(n):
        M = rng.normal(size=(dim, dim))
        As.append(M @ M.T + (0.5 + i) * np.eye(dim))
        bs.append(10.0 * rng.normal(size=(dim,)))
    x_star = np.linalg.solve(np.sum(As, 0), np.sum(bs, 0))
    return np.stack(As).astype(np.float32), np.stack(bs).astype(np.float32), x_star


def test_extra_quadratic_suite_reaches_the_f32_floor():
    """EXTRA's float32 optimality gap on the quadratic suite: within 1e-5
    after 4000 steps (the difference form with Kahan accumulation and the
    guards; the textbook form floors near 1e-3), and a floor, not a
    drift: 4000 more steps do not move it past max(2x, 1e-5)."""
    A, b, x_star = _quadratics()
    n, dim = b.shape
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    eng = ExtraEngine(Topology.ring(n).metropolis_weights(),
                      lambda x, step: torch.einsum("nij,nj->ni", At, x) - bt,
                      learning_rate=5e-3, stacked_grads=True, device="cpu")
    state, trace = eng.run(eng.init(torch.zeros(n, dim)), 4000)
    gap_4k = np.abs(state.x.double().numpy() - x_star[None]).max()
    assert gap_4k <= 1e-5, gap_4k
    assert float(trace[-1]) < 1e-4
    state, _ = eng.run(state, 4000)
    gap_8k = np.abs(state.x.double().numpy() - x_star[None]).max()
    assert gap_8k < max(2.0 * gap_4k, 1e-5), (gap_4k, gap_8k)


def test_dsgt_quadratic_suite_matches_jax_and_reaches_the_optimum():
    A, b, x_star = _quadratics()
    n, dim = b.shape
    At, bt, Aj, bj = torch.from_numpy(A), torch.from_numpy(b), jnp.asarray(A), jnp.asarray(b)
    W = Topology.ring(n).metropolis_weights()
    eng = GradientTrackingEngine(W, lambda x, i, s: At[i] @ x - bt[i], learning_rate=4e-3,
                                 device="cpu")
    jeng = JTracking(W, lambda x, i, s: Aj[i] @ x - bj[i], learning_rate=4e-3)
    state, trace = eng.run(eng.init(torch.zeros(n, dim)), 300)
    jstate, jtrace = jeng.run(jeng.init(jnp.zeros((n, dim), jnp.float32)), 300)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(trace.numpy(), np.asarray(jtrace), atol=1e-4, rtol=1e-5)
    assert eng.tracker_sum_gap(state) <= 1e-3  # |b| ~ 10: float32 round-off of sums ~1e2
    stacked = GradientTrackingEngine(
        W, lambda x, s: torch.einsum("nij,nj->ni", At, x) - bt, learning_rate=4e-3,
        stacked_grads=True, device="cpu")
    s2, _ = stacked.run(stacked.init(torch.zeros(n, dim)), 3000)
    assert np.abs(s2.x.double().numpy() - x_star[None]).max() < 1e-3


def test_extra_rejects_a_schedule_and_a_bad_cadence():
    with pytest.raises(TypeError, match="constant learning_rate"):
        ExtraEngine(RING, port_grad, learning_rate=lambda s: 0.1, device="cpu")
    with pytest.raises(ValueError, match="project_every"):
        ExtraEngine(RING, port_grad, project_every=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GradientTrackingEngine(RING, port_grad)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExtraEngine(RING, port_grad)
