"""Push-sum on directed graphs and randomized pairwise gossip of the
PyTorch port against the JAX package, on identical numpy state.

Pairwise gossip draws its edges from ``jax.random`` in the reference,
which a ``torch.Generator`` cannot replay; the test replays the
reference's draws (``randint(fold_in(key, r), (), 0, E)`` per round) and
feeds them to ``ConsensusEngine.mix_pairwise_edges``.  Tolerances: 2e-6
on float32 state (the ``tests/test_consensus.py`` bar), round counts
equal, and the mean kept to 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel.consensus import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.fast_averaging import solve_fastest_mixing as j_solve
from distributed_learning_tpu.parallel.pushsum import PushSumEngine as JPushSum
from distributed_learning_tpu.parallel.pushsum import push_sum_matrix as j_matrix
from distributed_learning_tpu.parallel.topology import Topology as JTopology
from distributed_learning_tpu_torch.parallel import (
    ConsensusEngine,
    PushSumEngine,
    Topology,
    push_sum_matrix,
)

ATOL = 2e-6


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 5)).astype(np.float32)}


def _ours(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def _theirs(state):
    return {k: jnp.asarray(v) for k, v in state.items()}


def _close(ours, theirs, atol=ATOL):
    for k in theirs:
        np.testing.assert_allclose(np.asarray(ours[k]), np.asarray(theirs[k]), atol=atol, rtol=0)


def _jax_draws(key, rounds, n_edges):
    return np.array([int(jax.random.randint(jax.random.fold_in(key, r), (), 0, n_edges))
                     for r in range(rounds)])


# (name, mixing matrix): Metropolis weights, and fastest-mixing weights,
# which may be negative (an edge is |W_ij| > 1e-12).
_MATRICES = [
    ("ring6", Topology.ring(6).metropolis_weights()),
    ("grid2d_2x3_sdp", j_solve(JTopology.grid2d(2, 3))[0]),
    ("star5", Topology.star(5).metropolis_weights()),
]


@pytest.mark.parametrize("W", [m[1] for m in _MATRICES], ids=[m[0] for m in _MATRICES])
def test_pairwise_on_fed_edges_matches_jax_and_keeps_the_mean(W):
    n, rounds = W.shape[0], 40
    state = _state(n, seed=n)
    eng, jeng = ConsensusEngine(W, device="cpu"), JEngine(W)
    edges = eng.pairwise_edges()
    np.testing.assert_array_equal(edges, np.argwhere(np.abs(np.triu(W, 1)) > 1e-12))
    key = jax.random.PRNGKey(3)
    draws = _jax_draws(key, rounds, len(edges))
    ours = eng.mix_pairwise_edges(_ours(state), torch.from_numpy(draws))
    theirs = jeng.mix_pairwise(_theirs(state), key, rounds)
    _close(ours, theirs)
    for k, v in state.items():
        np.testing.assert_allclose(ours[k].mean(0).numpy(), v.mean(0), atol=1e-6, rtol=0)
    # the input is left as it was
    np.testing.assert_array_equal(_ours(state)["w"].numpy(), state["w"])


def test_pairwise_with_a_generator_is_reproducible_and_contracts():
    W = Topology.ring(8).metropolis_weights()
    eng = ConsensusEngine(W, device="cpu")
    state = _ours(_state(8, seed=1))
    a = eng.mix_pairwise(state, torch.Generator().manual_seed(5), 400)
    b = eng.mix_pairwise(state, torch.Generator().manual_seed(5), 400)
    for k in state:
        assert torch.equal(a[k], b[k])
        torch.testing.assert_close(a[k].mean(0), state[k].mean(0), atol=1e-6, rtol=0)
    assert float(eng.max_deviation(a)) < 0.05 * float(eng.max_deviation(state))
    lone = ConsensusEngine(np.eye(3), device="cpu")
    assert lone.mix_pairwise(state, torch.Generator(), 3) is state


@pytest.mark.parametrize("graph", [{0: [1], 1: [2], 2: [3], 3: [4], 4: [0]},
                                   [(0, 1), (1, 2), (2, 0), (0, 2)],
                                   {0: [1, 2], 1: [2], 2: [0], 3: [0]}])
def test_push_sum_matrix_equals_jax(graph):
    np.testing.assert_array_equal(push_sum_matrix(graph), j_matrix(graph))


DIRECTED_RING = push_sum_matrix({i: [(i + 1) % 5] for i in range(5)})
SKEWED = push_sum_matrix({0: [1, 2, 3], 1: [2], 2: [3], 3: [4], 4: [0]})


@pytest.mark.parametrize("weights", [None, [1.0, 2.0, 0.5, 4.0, 3.0]], ids=["plain", "weighted"])
@pytest.mark.parametrize("P", [DIRECTED_RING, SKEWED], ids=["directed_ring", "skewed"])
def test_push_sum_mix_and_mix_until_match_jax(P, weights):
    state = _state(5, seed=2)
    ours, theirs = PushSumEngine(P, device="cpu"), JPushSum(P)
    for times in (1, 7):
        _close(ours.mix(_ours(state), times, weights=weights),
               theirs.mix(_theirs(state), times, weights=weights))
    est, t, res = ours.mix_until(_ours(state), eps=1e-4, weights=weights)
    jest, jt, jres = theirs.mix_until(_theirs(state), eps=1e-4, weights=weights)
    _close(est, jest)
    assert t == int(jt) and abs(res - float(jres)) <= ATOL and res < 1e-4
    w = np.ones(5) if weights is None else np.asarray(weights)
    for k, v in state.items():  # every agent holds the weighted average
        want = np.tensordot(w / w.sum(), v, 1)
        np.testing.assert_allclose(est[k].numpy(), np.broadcast_to(want, v.shape), atol=1e-3)


def test_push_sum_keeps_the_totals_and_takes_bare_tensors():
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(5, 6)).astype(np.float32))
    eng = PushSumEngine(SKEWED, device="cpu")
    num, den = eng.lift(x, [1.0, 2.0, 3.0, 4.0, 5.0])
    s_num, s_den = num["float32"].sum(0).clone(), float(den.sum())
    den = eng.rounds_(num, den, 9)
    torch.testing.assert_close(num["float32"].sum(0), s_num, atol=1e-5, rtol=1e-5)
    assert abs(float(den.sum()) - s_den) < 1e-5
    out = eng.mix(x, 3)
    assert isinstance(out, torch.Tensor) and out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(JPushSum(SKEWED).mix(jnp.asarray(
        x.numpy()), 3)), atol=ATOL, rtol=0)


def test_push_sum_rejections_match_jax():
    for bad in (np.array([[0.5, 0.5], [0.6, 0.5]]), np.array([[1.5, 0.0], [-0.5, 1.0]]),
                np.ones((2, 3))):
        with pytest.raises(ValueError) as ours:
            PushSumEngine(bad, device="cpu")
        with pytest.raises(ValueError) as theirs:
            JPushSum(bad)
        assert str(ours.value).split(";")[0].split(",")[0] == \
            str(theirs.value).split(";")[0].split(",")[0]
    eng = PushSumEngine(DIRECTED_RING, device="cpu")
    for w in ([1, 1, 0, 1, 1], [1, 1, np.nan, 1, 1], [1, 1, 1]):
        with pytest.raises(ValueError, match="weights"):
            eng.mix(torch.zeros(5, 2), weights=w)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PushSumEngine(DIRECTED_RING)
