"""``fused_dense_mix`` and ``fused_max_deviation`` of the port's
``ops/mixing.py`` against the JAX package's (``ops/mixing.py:236``,
``:252``) on the same stacked state, on the CPU: 2e-6, the mixing
tolerance of ``tests/test_consensus.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.ops import mixing as ref
from distributed_learning_tpu.parallel.topology import Topology
from distributed_learning_tpu_torch.ops import mixing as port

N, TOL = 4, 2e-6


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(N, 7)).astype(np.float32),
            "a": rng.normal(size=(N, 3, 5)).astype(np.float32),
            "c": rng.normal(size=(N, 2, 2, 3)).astype(np.float32)}


@pytest.mark.parametrize("times", [0, 1, 3])
def test_fused_dense_mix_matches_the_reference(times):
    W = Topology.ring(N).metropolis_weights().astype(np.float32)
    state = _state()
    want = ref.fused_dense_mix({k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(W),
                               times=times)
    got = port.fused_dense_mix({k: torch.from_numpy(v) for k, v in state.items()},
                               torch.from_numpy(W), times=times)
    assert list(got) == list(state)
    for k in state:
        assert tuple(got[k].shape) == state[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=TOL, rtol=0)


def test_fused_dense_mix_keeps_storage_dtypes_and_leaves_its_input():
    W = torch.from_numpy(Topology.complete(N).metropolis_weights().astype(np.float32))
    state = {"w": torch.randn(N, 6, generator=torch.Generator().manual_seed(1)),
             "h": torch.randn(N, 4, generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)}
    before = {k: v.clone() for k, v in state.items()}
    out = port.fused_dense_mix(state, W)
    assert {k: v.dtype for k, v in out.items()} == {"w": torch.float32, "h": torch.bfloat16}
    for k in state:
        assert torch.equal(state[k], before[k])
    # The complete graph's Metropolis round is the exact average.
    torch.testing.assert_close(out["w"], before["w"].mean(0, keepdim=True).expand(N, 6),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("fused", [True, False])
def test_fused_max_deviation_matches_the_reference(fused):
    state = _state(3)
    want = ref.fused_max_deviation({k: jnp.asarray(v) for k, v in state.items()}, fused=fused)
    got = port.fused_max_deviation({k: torch.from_numpy(v) for k, v in state.items()},
                                   fused=fused)
    assert got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=TOL, rtol=0)
