"""The graph layer of the PyTorch port against the JAX package: every
``Topology`` constructor and analytic, the fastest-mixing solver, the
matching schedule, ``max_std``, ``run_round``, ``Mixer``, the stacking
helpers, the engines' default device and ``CallbackTelemetry``.

Tolerances: the host-side numpy modules are copies, so edges, tokens and
schedules must be equal and every analytic within 1e-12; device mixing
routes within 2e-6 on float32 state (the ``tests/test_consensus.py``
bar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.ops import mixing as jops
from distributed_learning_tpu.parallel.consensus import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.consensus import Mixer as JMixer
from distributed_learning_tpu.parallel.fast_averaging import (
    find_optimal_weights as j_find,
    solve_fastest_mixing as j_solve,
)
from distributed_learning_tpu.parallel.schedule import MatchingSchedule as JSchedule
from distributed_learning_tpu.parallel.topology import Topology as JTopology
from distributed_learning_tpu.parallel.topology import is_connected as j_connected
from distributed_learning_tpu.parallel.topology import spectral_gap as j_gap
from distributed_learning_tpu.utils.telemetry import CallbackTelemetry as JCallback
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel import (
    ChocoGossipEngine,
    ConsensusEngine,
    MatchingSchedule,
    Mixer,
    Topology,
    find_optimal_weights,
    is_connected,
    solve_fastest_mixing,
    spectral_gap,
    top_k,
)
from distributed_learning_tpu_torch.utils import CallbackTelemetry

ATOL = 2e-6
EXACT = 1e-12

# (name, constructor call taking either package's Topology class)
_CONSTRUCTORS = [
    ("ring6", lambda T: T.ring(6)),
    ("chain5", lambda T: T.chain(5)),
    ("complete5", lambda T: T.complete(5)),
    ("star6", lambda T: T.star(6)),
    ("grid2d_3x4", lambda T: T.grid2d(3, 4)),
    ("torus2d_3x4", lambda T: T.torus2d(3, 4)),
    ("hypercube3", lambda T: T.hypercube(3)),
    *[(f"watts_strogatz_s{s}", lambda T, s=s: T.watts_strogatz(12, 4, 0.5, seed=s))
      for s in (0, 1, 7)],
    *[(f"random_regular_s{s}", lambda T, s=s: T.random_regular(3, 10, seed=s))
      for s in (0, 3, 11)],
    *[(f"erdos_renyi_s{s}", lambda T, s=s: T.erdos_renyi(9, 0.4, seed=s))
      for s in (0, 2, 5)],
    ("tokens", lambda T: T.from_edges([("a", "b"), ("b", "c"), ("c", "a"), ("c", "d")])),
]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=0, atol=EXACT)


@pytest.mark.parametrize("build", [c[1] for c in _CONSTRUCTORS],
                         ids=[c[0] for c in _CONSTRUCTORS])
def test_constructors_and_analytics_match_jax(build):
    ours, theirs = build(Topology), build(JTopology)
    assert (ours.n_agents, ours.edges, ours.tokens) == (
        theirs.n_agents, theirs.edges, theirs.tokens)
    assert ours.n_edges == theirs.n_edges and ours.max_degree == theirs.max_degree
    assert ours.token_index() == theirs.token_index()
    assert ours.neighbor_dict() == theirs.neighbor_dict()
    for i in range(ours.n_agents):
        assert ours.neighbors(i) == theirs.neighbors(i)
    for name in ("adjacency", "degrees", "incidence", "laplacian", "laplacian_eigenvalues",
                 "perron", "metropolis_weights"):
        _close(getattr(ours, name)(), getattr(theirs, name)())
    for name in ("algebraic_connectivity", "uniform_epsilon", "convergence_speed"):
        _close(getattr(ours, name)(), getattr(theirs, name)())
    assert ours.connected() == theirs.connected() is True
    _close(ours.perron(0.1), theirs.perron(0.1))
    w = np.random.default_rng(ours.n_edges).uniform(0.05, 0.2, ours.n_edges)
    _close(ours.mixing_matrix(w), theirs.mixing_matrix(w))
    assert ours.describe() == theirs.describe()
    W = ours.metropolis_weights()
    _close(spectral_gap(W), j_gap(W))
    assert is_connected(list(ours.edges), ours.n_agents) == j_connected(
        list(theirs.edges), theirs.n_agents)


def test_is_connected_and_rejections_match_jax():
    for edges, n in (([(0, 1), (2, 3)], None), ([(0, 1), (1, 2)], None), ([], 1),
                     ([(0, 1)], 3)):
        assert is_connected(edges, n) == j_connected(edges, n)
    with pytest.raises(ValueError, match="degree \\* n must be even"):
        Topology.random_regular(3, 5)
    with pytest.raises(ValueError, match="edge weights"):
        Topology.ring(4).mixing_matrix([0.1, 0.2])


def test_find_optimal_weights_golden_and_equal_to_jax():
    """The notebook's 5-edge example: weights (1/3, 1/3, 1/2, 1/3, 1/3),
    gamma 2/3.  The smoothed first-order solver (the reference's, ported
    operation for operation) lands 4.2e-6 above 2/3 with weights within
    7.6e-5; the port equals the JAX package's result to 1e-12."""
    edges = [(0, 1), (0, 2), (0, 3), (1, 4), (4, 2)]
    res = find_optimal_weights(edges)
    w, g = res
    jw, jg = j_find(edges)
    _close(w, jw)
    _close(g, jg)
    np.testing.assert_allclose(w, [1 / 3, 1 / 3, 1 / 2, 1 / 3, 1 / 3], atol=1e-4)
    assert abs(g - 2 / 3) < 1e-5
    assert res.weights is w and res.gamma == g


# The graphs of examples/fast_averaging_gallery.py.
_GALLERY = [
    ("ring8", lambda T: T.ring(8)),
    ("grid2d_3x3", lambda T: T.grid2d(3, 3)),
    ("hypercube4", lambda T: T.hypercube(4)),
    ("watts_strogatz_25", lambda T: T.watts_strogatz(25, 4, 0.3)),
    ("torus2d_3x4", lambda T: T.torus2d(3, 4)),
    ("random_regular_3_12", lambda T: T.random_regular(3, 12)),
]


@pytest.mark.parametrize("build", [c[1] for c in _GALLERY], ids=[c[0] for c in _GALLERY])
def test_solve_fastest_mixing_gallery_equals_jax(build):
    W, g = solve_fastest_mixing(build(Topology))
    jW, jg = j_solve(build(JTopology))
    _close(W, jW)
    _close(g, jg)
    assert 0.0 <= g < 1.0


def test_fastest_mixing_complete_graph_is_exact_average():
    w, g = find_optimal_weights([(i, j) for i in range(4) for j in range(i + 1, 4)])
    jw, jg = j_find([(i, j) for i in range(4) for j in range(i + 1, 4)])
    _close(w, jw)
    assert g < 1e-3


@pytest.mark.parametrize("build", [c[1] for c in _CONSTRUCTORS[:10]],
                         ids=[c[0] for c in _CONSTRUCTORS[:10]])
def test_matching_schedule_equals_jax(build):
    topo, jtopo = build(Topology), build(JTopology)
    for ours, theirs in ((MatchingSchedule.from_topology(topo),
                          JSchedule.from_topology(jtopo)),
                         (MatchingSchedule.from_matrix(topo.metropolis_weights()),
                          JSchedule.from_matrix(jtopo.metropolis_weights()))):
        assert ours.matchings == theirs.matchings
        assert ours.num_rounds == theirs.num_rounds and ours.n == theirs.n
        np.testing.assert_array_equal(ours.self_weights, theirs.self_weights)
        np.testing.assert_array_equal(ours.weights, theirs.weights)
        np.testing.assert_array_equal(ours.as_matrix(), theirs.as_matrix())
        np.testing.assert_array_equal(ours.as_matrix(), topo.metropolis_weights())
    w = np.linspace(0.05, 0.15, topo.n_edges)
    np.testing.assert_array_equal(MatchingSchedule.from_topology(topo, w).as_matrix(),
                                  JSchedule.from_topology(jtopo, w).as_matrix())


def _stacked(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "b": rng.normal(size=(n, 7)).astype(np.float32)}


def _ours(state):
    return {k: torch.from_numpy(v.copy()) for k, v in state.items()}


def test_max_std_is_the_population_std_of_jax():
    state = _stacked()
    ours = float(ops.max_std(_ours(state)))
    theirs = float(jops.max_std({k: jnp.asarray(v) for k, v in state.items()}))
    assert abs(ours - theirs) <= ATOL
    unbiased = max(float(torch.std(torch.from_numpy(v), dim=0).max()) for v in state.values())
    assert abs(unbiased / ours - np.sqrt(4 / 3)) < 1e-5  # what correction=1 would read
    eng = ConsensusEngine(Topology.ring(4).metropolis_weights(), device="cpu")
    assert abs(float(eng.max_std(_ours(state))) - theirs) <= ATOL


@pytest.mark.parametrize("weights", [[1.0, 1.0, 1.0, 1.0], [1.0, 2.0, 3.0, 10.0]])
def test_run_round_matches_jax(weights):
    W = Topology.ring(4).metropolis_weights()
    state = _stacked(seed=1)
    ours = ConsensusEngine(W, device="cpu").run_round(_ours(state), weights,
                                                      convergence_eps=1e-4)
    theirs = JEngine(W).run_round({k: jnp.asarray(v) for k, v in state.items()},
                                  np.asarray(weights, np.float32), convergence_eps=1e-4)
    for k in state:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), atol=ATOL, rtol=0)
    w = np.asarray(weights) / np.sum(weights)
    for k, v in state.items():  # the weighted average, on every agent
        np.testing.assert_allclose(ours[k].numpy(), np.broadcast_to(
            np.tensordot(w, v, 1), v.shape), atol=1e-3)
    with pytest.raises(ValueError, match="positive finite"):
        ConsensusEngine(W, device="cpu").run_round(_ours(state), [0.0, 0.0, 0.0, 0.0])


def test_weighted_lift_and_readout_match_jax():
    state = _stacked(seed=2)
    w = np.array([1.0, 2.0, 0.5, 4.0], np.float32)
    ours = ops.weighted_lift(_ours(state), torch.from_numpy(w))
    theirs = jops.weighted_lift({k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(w))
    back = ops.weighted_readout(ours, torch.from_numpy(w))
    jback = jops.weighted_readout(theirs, jnp.asarray(w))
    for k in state:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


def test_stack_and_unstack_trees():
    trees = [{"a": np.full((2,), i, np.float32), "b": np.ones((1, 3), np.float32) * i}
             for i in range(3)]
    stacked = ops.stack_trees(trees)
    jstacked = jops.stack_trees([{k: jnp.asarray(v) for k, v in t.items()} for t in trees])
    for k in ("a", "b"):
        np.testing.assert_array_equal(stacked[k].numpy(), np.asarray(jstacked[k]))
    back = ops.unstack_tree(stacked, 3)
    assert [float(t["b"][0, 1]) for t in back] == [0.0, 1.0, 2.0]
    assert ops.stack_trees([torch.ones(2), torch.zeros(2)]).shape == (2, 2)
    with pytest.raises(ValueError, match="leading agent axis of size 4"):
        ops.unstack_tree(stacked, 4)


NEIGHBORS = {
    "A": {"A": 0.5, "B": 0.25, "D": 0.25},
    "B": {"A": 0.25, "B": 0.5, "C": 0.25},
    "C": {"B": 0.25, "C": 0.5, "D": 0.25},
    "D": {"A": 0.25, "C": 0.25, "D": 0.5},
}


@pytest.mark.parametrize("eps", [None, 1e-3])
def test_mixer_matches_jax(eps):
    state = _stacked(seed=3)
    params = {t: {k: v[i] for k, v in state.items()} for i, t in enumerate("ABCD")}
    ours = Mixer({t: {k: torch.from_numpy(v.copy()) for k, v in p.items()}
                  for t, p in params.items()}, NEIGHBORS, device="cpu")
    theirs = JMixer({t: {k: jnp.asarray(v) for k, v in p.items()} for t, p in params.items()},
                    NEIGHBORS)
    assert ours.tokens == theirs.tokens
    assert ours.mix(2, eps) == theirs.mix(2, eps)
    mine, ref = ours.parameters(), theirs.parameters()
    for t in "ABCD":
        for k in state:
            np.testing.assert_allclose(mine[t][k].numpy(), np.asarray(ref[t][k]), atol=ATOL,
                                       rtol=0)
    devs, jdevs = ours.get_parameters_deviation(), theirs.get_parameters_deviation()
    assert devs.keys() == jdevs.keys()
    for t in devs:
        assert abs(devs[t] - jdevs[t]) <= 1e-5
    assert abs(ours.get_max_parameters_std() - theirs.get_max_parameters_std()) <= ATOL


def test_mixer_with_a_matrix_and_bare_tensors():
    W = Topology.ring(3).metropolis_weights()
    x = np.random.default_rng(4).normal(size=(3, 6)).astype(np.float32)
    ours = Mixer({i: torch.from_numpy(x[i].copy()) for i in range(3)}, W, device="cpu")
    theirs = JMixer({i: jnp.asarray(x[i]) for i in range(3)}, W)
    ours.mix(3)
    theirs.mix(3)
    np.testing.assert_allclose(ours.stacked_parameters().numpy(),
                               np.asarray(theirs.stacked_parameters()), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="expected 3 tokens"):
        Mixer({0: torch.zeros(2)}, W, tokens=["a"], device="cpu")
    with pytest.raises(ValueError, match="params missing"):
        Mixer({0: torch.zeros(2)}, W, device="cpu")
    single = Mixer({"solo": torch.ones(2)}, np.ones((1, 1)), tokens=["solo"], device="cpu")
    assert single.mix(5) == 0


def test_engines_default_to_the_card():
    """``ConsensusEngine(W)`` and ``ChocoGossipEngine(W, c)`` without a
    device take the card, and raise where there is none."""
    W = Topology.ring(4).metropolis_weights()
    if torch.cuda.is_available():
        assert ConsensusEngine(W).device.type == "cuda"
        assert ChocoGossipEngine(W, top_k(0.1)).device.type == "cuda"
        assert Mixer({i: torch.zeros(2) for i in range(4)}, W).device.type == "cuda"
    else:
        for make in (lambda: ConsensusEngine(W), lambda: ChocoGossipEngine(W, top_k(0.1)),
                     lambda: Mixer({i: torch.zeros(2) for i in range(4)}, W)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    assert ConsensusEngine(W, device="cpu").device == torch.device("cpu")


def test_callback_telemetry_matches_jax():
    seen, jseen = [], []
    ours, theirs = CallbackTelemetry(lambda t, p: seen.append((t, p))), JCallback(
        lambda t, p: jseen.append((t, p)))
    for tok, payload in (("a", {"loss": 1.0}), (3, [1, 2])):
        ours.process(tok, payload)
        theirs.process(tok, payload)
    assert seen == jseen == [("a", {"loss": 1.0}), (3, [1, 2])]
