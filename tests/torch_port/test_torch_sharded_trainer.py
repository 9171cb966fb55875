"""``GossipTrainer(mesh=)``: the paper's loop with one agent a gloo rank on
the CPU (4 ranks, spawned once for the module), on a small MLP.

* The plain ring route against the JAX package's ``GossipTrainer`` on the
  same converted init, shards and shuffle streams, for 2 epochs:
  per-epoch losses, grad norms, accuracies, deviation and every agent's
  parameters (the limits of ``test_torch_trainer.py``: 5e-5 on losses and
  grad norms, 2e-5 on parameters, 1e-6 on deviation and accuracy).
* Every gossip route (plain, per-call matrix from a
  ``topology_schedule``, Chebyshev, eps stopping, the Gossip-PGA exact
  average, and ROADMAP item 3b's CHOCO top-k with per-leaf and global
  budgets and error feedback, async gossip, clipped robust gossip, async
  trimmed mean on the complete graph) against the port's dense trainer on the
  same inputs, and the superstep (``train_epochs(2)``) against the eager
  epochs bit for bit: 2e-6 on parameters (the mixing tolerance; the
  local steps are the same ops on one agent's rows), 1e-6 on the
  reported numbers, 1e-5 relative on the robust masses.  The port's
  dense trainer holds these options to the JAX package's trainer in
  ``test_torch_trainer_choco.py`` and ``test_torch_trainer_async_robust.py``.
* A mesh that is not an ``AgentMesh`` is refused.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel import Topology as JaxTopology
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import (
    MLP,
    NODES,
    ROUTES,
    SUPERSTEP_ROUTES,
    Ranks,
    route_options,
    trainer_common,
)

MIX_TOL = 2e-6
MASS_RTOL = 1e-5


@pytest.fixture(scope="module")
def world():
    jt = JaxTrainer(model="mlp", model_kwargs=MLP, weights=JaxTopology.ring(4),
                    **trainer_common())
    jt.initialize_nodes()
    p0 = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=4)
    ranks = Ranks("trainer", 4, {f"p0_{k}": np.asarray(v) for k, v in p0.items()})
    jpays = [jt.train_epoch() for _ in range(2)]
    jparams = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=4)
    return p0, jt, jpays, jparams, ranks.results()


def _params(res, key):
    return {k: np.concatenate([r[key][k] for r in res]) for k in res[0][key]}


def _dense(p0, weights=None, **opts):
    t = GossipTrainer(model="mlp", model_kwargs=MLP,
                      weights=Topology.ring(4) if weights is None else weights, device="cpu",
                      **trainer_common(**opts))
    t.initialize_nodes(params={k: torch.as_tensor(np.asarray(v)) for k, v in p0.items()})
    return t


def test_sharded_trainer_equals_the_jax_trainer(world):
    _, jt, jpays, jparams, res = world
    for r in res:  # every rank reports every agent, as the dense trainer
        for pt, pj in zip(r["plain_payloads"], jpays):
            assert pt["mixed"] and pt["mix_rounds"] == pj["mix_rounds"] == 2
            for key in ("train_loss", "grad_norm"):
                np.testing.assert_allclose(pt[key], np.asarray(pj[key]), atol=5e-5)
            for key in ("train_acc", "test_acc"):
                np.testing.assert_allclose(pt[key], np.asarray(pj[key]), atol=1e-6)
            assert pt["deviation"] == pytest.approx(pj["deviation"], abs=1e-6)
        for a in NODES:
            np.testing.assert_allclose(r["plain_losses"][a], jt.network[a].stats.train_loss,
                                       atol=5e-5)
        assert r["plain_deviation"] == pytest.approx(jt.parameter_deviation(), abs=1e-6)
    for name, p in _params(res, "plain_params").items():
        np.testing.assert_allclose(p, jparams[name], atol=2e-5, err_msg=name)


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_gossip_route_equals_the_dense_trainer(world, route):
    p0, _, _, _, res = world
    t = _dense(p0, **route_options(route))
    pays = [t.train_epoch() for _ in range(2)]
    for r in res:  # the redirected mass is the total over the agents
        assert len(r[f"{route}_masses"]) == len(t._robust_masses)
        for got, want in zip(r[f"{route}_masses"], t._robust_masses):
            assert got == pytest.approx(want, rel=MASS_RTOL, abs=1e-12)
    for pt, pd in zip(res[0][f"{route}_payloads"], pays):
        assert pt["mix_rounds"] == pd["mix_rounds"] and pt["mixed"] == pd["mixed"]
        for key in ("train_loss", "grad_norm", "train_acc", "test_acc"):
            np.testing.assert_allclose(pt[key], pd[key], atol=1e-6, err_msg=key)
        assert pt["deviation"] == pytest.approx(pd["deviation"], abs=1e-6)
    for name, p in _params(res, f"{route}_params").items():
        np.testing.assert_allclose(p, t.model.stacked_parameters()[name].detach().numpy(),
                                   atol=MIX_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("route", SUPERSTEP_ROUTES)
def test_superstep_equals_the_eager_epochs(world, route):
    _, _, _, _, res = world
    for pt, pe in zip(res[0][f"{route}_superstep"], res[0][f"{route}_payloads"]):
        assert pt["mix_rounds"] == pe["mix_rounds"]
        np.testing.assert_array_equal(pt["train_loss"], pe["train_loss"])
        assert pt["deviation"] == pe["deviation"]
    got, want = _params(res, f"{route}_superstep_params"), _params(res, f"{route}_params")
    for name in got:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("mesh", ["agents", object()])
def test_a_mesh_must_be_an_agent_mesh(mesh):
    with pytest.raises(ValueError, match="AgentMesh"):
        GossipTrainer(model="mlp", model_kwargs=MLP, weights=Topology.ring(4), device="cpu",
                      mesh=mesh, **trainer_common())
