"""Topology, mixing and the dense consensus engine of the PyTorch port
against the JAX package, on identical numpy state.  Tolerance: 2e-6 on
float32 state (the ``tests/test_consensus.py`` bar); a bfloat16 leaf may
differ by one bf16 rounding (relative 2**-8) of a float32 sum taken in
another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel.consensus import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.schedule import (
    validate_mixing_matrix as jax_validate,
)
from distributed_learning_tpu.parallel.topology import Topology as JTopology
from distributed_learning_tpu.parallel.topology import gamma as jax_gamma
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel import (
    ConsensusEngine,
    Topology,
    gamma,
    validate_mixing_matrix,
)

ATOL = 2e-6

# (name, the port's topology, the JAX package's topology)
_GRAPHS = [
    ("ring", Topology.ring(4), JTopology.ring(4)),
    ("ring7", Topology.ring(7), JTopology.ring(7)),
    ("star", Topology.from_edges([(0, i) for i in range(1, 5)]), JTopology.star(5)),
    ("chain", Topology.from_edges([(i, i + 1) for i in range(5)]), JTopology.chain(6)),
    ("complete", Topology.from_edges([(i, j) for i in range(4) for j in range(i + 1, 4)]),
     JTopology.complete(4)),
    ("edges", *(T.from_edges([("a", "b"), ("b", "c"), ("c", "a"), ("c", "d")])
                for T in (Topology, JTopology))),
]


@pytest.mark.parametrize("name,ours,theirs", _GRAPHS, ids=[g[0] for g in _GRAPHS])
def test_topology_and_metropolis_match_jax(name, ours, theirs):
    assert ours.edges == theirs.edges and ours.tokens == theirs.tokens
    W = ours.metropolis_weights()
    np.testing.assert_array_equal(W, theirs.metropolis_weights())
    assert gamma(W) == jax_gamma(W)
    np.testing.assert_array_equal(validate_mixing_matrix(W), jax_validate(W))


def test_neighbor_dict_matches_jax():
    d = {"A": {"A": 0.5, "B": 0.5}, "B": {"A": 0.5, "B": 0.25, "C": 0.25},
         "C": {"B": 0.25, "C": 0.75}}
    (t1, W1), (t2, W2) = Topology.from_neighbor_dict(d), JTopology.from_neighbor_dict(d)
    assert t1 == Topology(t2.n_agents, t2.edges, t2.tokens)
    np.testing.assert_array_equal(W1, W2)
    with pytest.raises(ValueError, match="symmetric"):
        validate_mixing_matrix(np.array([[0.5, 0.5], [0.2, 0.8]]))


def _state(n, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(n, 4, 3)).astype(np.float32),
        "b": rng.normal(size=(n, 3)).astype(np.float32),
        "h": rng.normal(size=(n, 5)).astype(np.float32),  # stored as bf16
    }


def _ours(state):
    out = {k: torch.tensor(v) for k, v in state.items()}
    out["h"] = out["h"].to(torch.bfloat16)
    return out


def _theirs(state):
    out = {k: jnp.asarray(v) for k, v in state.items()}
    out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _compare(ours, theirs):
    for key in ours:
        a = ours[key].to(torch.float32).numpy()
        b = np.asarray(theirs[key].astype(jnp.float32))
        if key == "h":
            np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=ATOL)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL)


@pytest.mark.parametrize("form", ["leaves", "buffers"])
@pytest.mark.parametrize("times", [1, 5])
def test_mix_matches_jax(form, times):
    """Per-leaf stacked state (raveled once per call) and fused buffers
    (mixed in place by ``mix_``) against the JAX engine's fused route."""
    W = Topology.ring(6).metropolis_weights()
    state = _state(6)
    theirs = JEngine(W).mix(_theirs(state), times=times)
    engine = ConsensusEngine(W)
    if form == "leaves":
        ours = _ours(state)
        before = {k: v.clone() for k, v in ours.items()}
        mixed = engine.mix(ours, times=times)
        for k in ours:  # the input is left as it was
            assert torch.equal(ours[k], before[k])
    else:
        buffers, layout = ops.flatten_stacked(_ours(state))
        engine.mix_(buffers, times=times)
        mixed = ops.unflatten_stacked(buffers, layout)
    _compare(mixed, theirs)


def test_mix_until_matches_jax():
    W = Topology.ring(5).metropolis_weights()
    state = _state(5, seed=1)
    state.pop("h")  # eps-stopping compares a residual: float32 state only
    ours, t, res = ConsensusEngine(W).mix_until(_ours_f32(state), eps=1e-3, min_times=2)
    theirs, jt, jres = JEngine(W).mix_until(
        {k: jnp.asarray(v) for k, v in state.items()}, eps=1e-3, min_times=2
    )
    assert t == int(jt)
    assert res == pytest.approx(float(jres), abs=ATOL)
    _compare(ours, theirs)


def _ours_f32(state):
    return {k: torch.tensor(v) for k, v in state.items()}


def test_deviations_match_jax():
    state = _state(4, seed=2)
    state.pop("h")
    eng, jeng = ConsensusEngine(Topology.ring(4).metropolis_weights()), JEngine(
        Topology.ring(4).metropolis_weights())
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    np.testing.assert_allclose(eng.deviations(_ours_f32(state)).numpy(),
                               np.asarray(jeng.deviations(jstate)), atol=ATOL)
    assert float(eng.max_deviation(_ours_f32(state))) == pytest.approx(
        float(jeng.max_deviation(jstate)), abs=ATOL)


def test_fused_layout_round_trips():
    state = _ours(_state(3, seed=4))
    buffers, layout = ops.flatten_stacked(state)
    assert sorted(buffers) == ["bfloat16", "float32"]
    assert buffers["float32"].shape == (3, 12 + 3)
    assert layout.buckets == (("bfloat16", 5), ("float32", 15))
    back = ops.unflatten_stacked(buffers, layout)
    for k in state:
        assert torch.equal(back[k], state[k])


def test_mix_restores_the_callers_tf32_setting():
    """Gossip GEMMs run with TF32 off and leave the process-wide flag as
    the caller set it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            ConsensusEngine(Topology.ring(3).metropolis_weights()).mix(
                _ours_f32(_state(3)), times=2)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
