"""The dense engine's routes that the superstep carries, against the JAX
package's engine on identical numpy state: Chebyshev weights (exactly
equal), Chebyshev-accelerated rounds with the engine's W and with a
per-call W, exact averaging (Gossip-PGA), rounds against a per-call
matrix, and eps stopping against one.  Each runs in place on fused
buffers.  Tolerance: 2e-6 on float32 state (``tests/test_consensus.py``'s
bar); a bfloat16 leaf may differ by one bf16 rounding (relative 2**-8)
of a float32 sum taken in another order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel.consensus import ConsensusEngine as JEngine
from distributed_learning_tpu.parallel.schedule import chebyshev_omegas as jax_omegas
from distributed_learning_tpu.parallel.topology import gamma as jax_gamma
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology, chebyshev_omegas

ATOL = 2e-6
RING6 = Topology.ring(6).metropolis_weights()
# A second graph on the same 6 agents: a ring with two chords.
CHORDS = Topology.from_edges([(i, (i + 1) % 6) for i in range(6)] + [(0, 3), (1, 4)]
                             ).metropolis_weights()


def _state(n=6, seed=0, bf16=True):
    rng = np.random.default_rng(seed)
    state = {"w": rng.normal(size=(n, 4, 3)).astype(np.float32),
             "b": rng.normal(size=(n, 3)).astype(np.float32)}
    if bf16:
        state["h"] = rng.normal(size=(n, 5)).astype(np.float32)
    return state


def _buffers(state):
    ours = {k: torch.tensor(v) for k, v in state.items()}
    if "h" in ours:
        ours["h"] = ours["h"].to(torch.bfloat16)
    return ops.flatten_stacked(ours)


def _theirs(state):
    out = {k: jnp.asarray(v) for k, v in state.items()}
    if "h" in out:
        out["h"] = out["h"].astype(jnp.bfloat16)
    return out


def _compare(buffers, layout, theirs):
    ours = ops.unflatten_stacked(buffers, layout)
    for key in ours:
        a = ours[key].to(torch.float32).numpy()
        b = np.asarray(theirs[key].astype(jnp.float32))
        rtol = 2.0 ** -8 if key == "h" else 0.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("g", [0.0, 0.3, 0.9, 0.999])
@pytest.mark.parametrize("k", [0, 1, 2, 7])
def test_chebyshev_omegas_equal_jax(g, k):
    np.testing.assert_array_equal(chebyshev_omegas(g, k), jax_omegas(g, k))


def test_chebyshev_omegas_reject_gamma_one():
    with pytest.raises(ValueError, match="gamma"):
        chebyshev_omegas(1.0, 3)


@pytest.mark.parametrize("times", [1, 2, 6])
def test_mix_chebyshev_matches_jax(times):
    state = _state()
    buffers, layout = _buffers(state)
    ConsensusEngine(RING6, device="cpu").mix_chebyshev_(buffers, times)
    _compare(buffers, layout, JEngine(RING6).mix_chebyshev(_theirs(state), times))


def test_mix_chebyshev_with_matches_jax():
    """A per-call matrix with its own gamma's weights, as a device tensor;
    a passed spare pair gives the same bits as spares drawn per call."""
    state = _state(seed=1)
    om = chebyshev_omegas(jax_gamma(CHORDS), 5)
    theirs = JEngine(RING6).mix_chebyshev_with(_theirs(state), CHORDS, om)
    engine = ConsensusEngine(RING6, device="cpu")
    buffers, layout = _buffers(state)
    engine.mix_chebyshev_(buffers, 5, W=torch.tensor(CHORDS, dtype=torch.float32),
                          omegas=torch.tensor(om, dtype=torch.float32))
    _compare(buffers, layout, theirs)
    again, _ = _buffers(state)
    engine.mix_chebyshev_(again, W=CHORDS, omegas=om, spare=engine.spare_for(again))
    for key in buffers:
        assert torch.equal(again[key], buffers[key])
    with pytest.raises(ValueError, match="omegas"):
        engine.mix_chebyshev_(again, 3, W=CHORDS)


def test_global_average_matches_jax():
    state = _state(seed=2)
    buffers, layout = _buffers(state)
    ConsensusEngine(RING6, device="cpu").global_average_(buffers)
    _compare(buffers, layout, JEngine(RING6).global_average(_theirs(state)))
    for buf in buffers.values():  # every agent holds the same values
        assert all(torch.equal(buf[0], row) for row in buf)


@pytest.mark.parametrize("times", [1, 4])
def test_mix_with_matches_jax(times):
    state = _state(seed=3)
    buffers, layout = _buffers(state)
    engine = ConsensusEngine(RING6, device="cpu")
    engine.mix_with_(buffers, CHORDS, times, spare=engine.spare_for(buffers, 1))
    _compare(buffers, layout, JEngine(RING6).mix_with(_theirs(state), CHORDS, times=times))
    with pytest.raises(ValueError, match="shape"):
        engine.mix_with_(buffers, np.eye(5), 1)


def test_mix_until_with_matches_jax():
    state = _state(seed=4, bf16=False)  # eps stopping compares a float32 residual
    buffers, layout = _buffers(state)
    t, res = ConsensusEngine(RING6, device="cpu").mix_until_with_(buffers, CHORDS, eps=1e-3, min_times=2)
    theirs, jt, jres = JEngine(RING6).mix_until_with(_theirs(state), CHORDS, eps=1e-3,
                                                     min_times=2)
    assert t == int(jt) > 2
    assert res == pytest.approx(float(jres), abs=ATOL)
    _compare(buffers, layout, theirs)


def test_max_deviation_into_a_device_scalar_matches_jax():
    """The residual a captured gossip program reports: written into a
    0-dim tensor, the same value as the JAX engine's max deviation."""
    state = _state(seed=5, bf16=False)
    buffers, _ = _buffers(state)
    out = torch.zeros(())
    ConsensusEngine(RING6, device="cpu").max_deviation_(buffers, out)
    want = float(JEngine(RING6).max_deviation(_theirs(state)))
    assert float(out) == pytest.approx(want, abs=ATOL)
    assert torch.equal(out, ops.max_deviation(buffers))
