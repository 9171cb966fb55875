"""``TorchModelMixer`` of the PyTorch port against the JAX package's
``TorchModelMixer`` on the same four small ``torch.nn`` MLPs.

The port gossips the replicas on their own device; the reference takes
them through numpy into JAX.  Tolerances: parameters within 2e-6 (the
``tests/test_consensus.py`` bar), deviations within 1e-5 (a square root
of float32 sums taken in another order)."""

import copy

import numpy as np
import pytest
import torch

from distributed_learning_tpu.interop import TorchModelMixer as JTorchModelMixer
from distributed_learning_tpu_torch.interop import TorchModelMixer
from distributed_learning_tpu_torch.parallel import Topology

ATOL = 2e-6
RING = {a: {a: 0.5, (a + 1) % 4: 0.25, (a - 1) % 4: 0.25} for a in range(4)}


def _mlp(seed: int) -> torch.nn.Module:
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(6, 16), torch.nn.ReLU(),
                               torch.nn.BatchNorm1d(16), torch.nn.Linear(16, 3))


def _pair():
    models = {a: _mlp(a) for a in range(4)}
    return models, {a: copy.deepcopy(m) for a, m in models.items()}


def _params(m) -> np.ndarray:
    return np.concatenate([p.detach().numpy().ravel() for p in m.parameters()])


@pytest.mark.parametrize("topology", ["dict", "matrix"])
@pytest.mark.parametrize("times,eps", [(1, None), (3, None), (1, 1e-3)])
def test_mix_matches_jax(topology, times, eps):
    ours_models, their_models = _pair()
    topo = RING if topology == "dict" else Topology.ring(4).metropolis_weights()
    ours, theirs = TorchModelMixer(ours_models, topo), JTorchModelMixer(their_models, topo)
    assert ours.engine.device == torch.device("cpu")
    assert ours.mix(times, eps) == theirs.mix(times, eps)
    for a in range(4):
        np.testing.assert_allclose(_params(ours_models[a]), _params(their_models[a]),
                                   atol=ATOL, rtol=0)
    devs, jdevs = ours.get_parameters_deviation(), theirs.get_parameters_deviation()
    assert devs.keys() == jdevs.keys()
    for a in devs:
        assert abs(devs[a] - jdevs[a]) <= 1e-5
    assert abs(ours.get_max_parameters_std() - theirs.get_max_parameters_std()) <= ATOL


def test_mix_keeps_the_mean_and_every_parameter_object():
    models = {a: _mlp(a) for a in range(4)}
    mean0 = np.mean([_params(m) for m in models.values()], axis=0)
    ids = {a: [id(p) for p in m.parameters()] for a, m in models.items()}
    mixer = TorchModelMixer(models, RING)
    assert mixer.mix(1, eps=1e-7) > 1
    for a, m in models.items():
        np.testing.assert_allclose(_params(m), mean0, atol=1e-5, rtol=0)
        assert [id(p) for p in m.parameters()] == ids[a]
    assert mixer.get_max_parameters_std() < 1e-6


def test_optimizer_state_survives_and_buffers_stay_per_agent():
    models = {a: _mlp(a) for a in range(4)}
    opts = {a: torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9) for a, m in models.items()}
    rng = np.random.default_rng(0)
    for a, m in models.items():  # one step each: momentum buffers and BN statistics
        x = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
        m(x).square().mean().backward()
        opts[a].step()
    bufs = {a: [opts[a].state[p]["momentum_buffer"].clone() for p in m.parameters()]
            for a, m in models.items()}
    stats = {a: m[2].running_mean.clone() for a, m in models.items()}
    mixer = TorchModelMixer(models, RING)
    mixer.mix(2)
    for a, m in models.items():
        for p, before in zip(m.parameters(), bufs[a]):
            assert torch.equal(opts[a].state[p]["momentum_buffer"], before)
        assert torch.equal(m[2].running_mean, stats[a])
    assert not torch.equal(models[0][2].running_mean, models[1][2].running_mean)
    for a, m in models.items():  # and the optimizer steps on the mixed parameters
        opts[a].zero_grad()
        m(torch.ones(4, 6)).sum().backward()
        opts[a].step()


def test_rejections():
    with pytest.raises(ValueError, match="non-empty"):
        TorchModelMixer({}, RING)
    odd = {a: _mlp(a) for a in range(4)}
    odd[3] = torch.nn.Sequential(torch.nn.Linear(6, 3))
    with pytest.raises(ValueError, match="same architecture"):
        TorchModelMixer(odd, RING)
    split = {a: _mlp(a) for a in range(4)}
    split[2] = split[2].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        TorchModelMixer(split, RING)
    with pytest.raises(ValueError, match="params missing for agents"):
        TorchModelMixer({a: _mlp(a) for a in range(3)}, RING)
    assert TorchModelMixer({"solo": _mlp(0)}, np.ones((1, 1)), tokens=["solo"]).mix(4) == 0
