"""The port's 4-agent gossip trainer against the JAX package's
``GossipTrainer`` on the same converted init, shards, shuffle streams and
ring: per-step losses, per-epoch grad norms, parameters after each epoch,
the post-mix deviation and test accuracy.  Float32 on the CPU, where the
JAX LM's flash path runs ``attention_reference`` and the port's runs the
kernels' plain versions.  Tolerances: 5e-5 on losses and grad norms,
2e-5 on parameters (float32 sums in another order, carried through
Adam), 1e-6 on deviation and accuracy."""

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.parallel import Topology as JaxTopology
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu.training.trainer import make_optimizer as jax_make_optimizer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.models import TransformerLM, get_model
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import (
    GossipTrainer,
    MasterNode,
    make_optimizer,
)
from distributed_learning_tpu_torch.utils import RecordingTelemetry
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

V, T = 32, 16
NODES = list(range(4))
LM = dict(vocab_size=V, num_layers=2, num_heads=2, head_dim=16, max_len=T)


def pattern_batch(n_seq, phases):
    """Cyclic token windows starting at the given phases; y = next token."""
    phases = np.asarray(list(phases))
    starts = phases[np.arange(n_seq) % len(phases)]
    seq = (starts[:, None] + np.arange(T + 1)[None, :]) % V
    return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)


def _common(**over):
    kw = dict(
        node_names=NODES, optimizer="adam", learning_rate=3e-3,
        error="cross_entropy",
        train_data={a: pattern_batch(16, range(8 * a, 8 * a + 8)) for a in NODES},
        test_data=pattern_batch(10, range(V)), epoch=2, batch_size=4,
        epoch_len=3, mix_times=2, stat_step=1, eval_batch_size=4, seed=0,
    )
    kw.update(over)
    return kw


def _pair(**over):
    jt = JaxTrainer(model=JaxLM(attn_impl="flash", **LM), weights=JaxTopology.ring(4),
                    dropout=False, **_common(**over))
    jt.initialize_nodes()
    p0 = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=4)
    tt = GossipTrainer(
        model=TransformerLM(attn_impl="flash", n_agents=4, device="cpu", **LM),
        weights=Topology.ring(4), device="cpu", **_common(**over))
    tt.initialize_nodes(params=p0)
    return jt, tt


def test_gossip_trainer_matches_jax():
    jt, tt = _pair()
    for _ in range(2):
        pj, pt = jt.train_epoch(), tt.train_epoch()
        assert pt["mixed"] and pt["mix_rounds"] == pj["mix_rounds"] == 2
        for key in ("train_loss", "grad_norm"):
            np.testing.assert_allclose(pt[key], np.asarray(pj[key]), atol=5e-5)
        for key in ("train_acc", "test_acc"):
            np.testing.assert_allclose(pt[key], np.asarray(pj[key]), atol=1e-6)
        assert pt["deviation"] == pytest.approx(pj["deviation"], abs=1e-6)
        jp = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=4)
        for name, p in tt.model.stacked_parameters().items():
            np.testing.assert_allclose(p.detach().numpy(), jp[name], atol=2e-5,
                                       err_msg=name)
    for a in NODES:  # per-step losses (stat_step=1)
        np.testing.assert_allclose(tt.network[a].stats.train_loss,
                                   jt.network[a].stats.train_loss, atol=5e-5)
    assert tt.parameter_deviation() == pytest.approx(jt.parameter_deviation(), abs=1e-6)
    node0 = tt.node_parameters()[0]
    assert torch.equal(node0["head.bias"], tt.model.head.bias[0])


def test_eps_stopping_gossip_matches_jax():
    jt, tt = _pair(mix_eps=5e-2, mix_times=1, epoch=1)
    pj, pt = jt.train_epoch(), tt.train_epoch()
    assert pt["mix_rounds"] == pj["mix_rounds"] > 1
    assert pt["deviation"] == pytest.approx(pj["deviation"], abs=1e-6)
    assert pt["deviation"] < 5e-2


@pytest.mark.parametrize(
    "name,kwargs",
    [
        ("sgd", {}),
        ("sgd", {"momentum": 0.9, "weight_decay": 5e-4}),
        ("sgd", {"momentum": 0.9, "nesterov": True}),
        ("adam", {"weight_decay": 1e-3}),
        ("adamw", {"weight_decay": 1e-2}),
    ],
)
def test_optimizers_match_optax(name, kwargs):
    """Three steps on a stacked (N, P) buffer equal the reference's optax
    chain (torch-style L2 for sgd/adam, decoupled for adamw); atol 1e-6."""
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(3, 7)).astype(np.float32)
    grads = [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(3)]
    flat = torch.tensor(x0)
    flat.grad = torch.zeros_like(flat)
    opt = make_optimizer(name, kwargs, 0.05)(flat)
    tx = jax_make_optimizer(name, dict(kwargs), 0.05)
    p = jax.numpy.asarray(x0)
    state = tx.init(p)
    for g in grads:
        flat.grad.copy_(torch.tensor(g))
        opt.step()
        upd, state = tx.update(jax.numpy.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
    np.testing.assert_allclose(flat.numpy(), np.asarray(p), atol=1e-6)


@pytest.mark.parametrize(
    "option,value",
    [
        ("mesh", "agents"),
        ("mesh", object()),
    ],
)
def test_unported_options_raise(option, value):
    # mesh is ported (one agent a rank); what is not an AgentMesh is refused.
    with pytest.raises(ValueError, match="AgentMesh"):
        GossipTrainer(model="transformer", model_kwargs=LM, device="cpu",
                      weights=Topology.ring(4), **_common(**{option: value}))


@pytest.mark.parametrize(
    "option,value",
    [("timer_every_n", 5), ("profile_costs", True), ("obs", True)],
)
def test_obs_options_are_ported(option, value):
    """The obs options, rejected until the obs layer was ported, build."""
    GossipTrainer(model="transformer", model_kwargs=LM, device="cpu",
                  weights=Topology.ring(4), **_common(**{option: value}))


@pytest.mark.parametrize(
    "option,value,rounds",
    [
        ("superstep", 2, [2, 2]),
        ("chebyshev", True, [2, 2]),
        ("mix_times_schedule", lambda e: 3 - e, [3, 2]),
        ("adaptive_comm", {"target": 1.0, "gain": 0.0}, [2, 2]),
        ("topology_schedule", lambda e: Topology.complete(4), [2, 2]),
        ("global_avg_every", 2, [2, 1]),
        ("learning_rate", lambda count: 3e-3 / (1 + count), [2, 2]),
    ],
)
def test_ported_options_run(option, value, rounds):
    """The options this port once rejected now train: two epochs through
    start_consensus, with the expected gossip rounds per epoch."""
    t = GossipTrainer(model="transformer", model_kwargs=LM, device="cpu",
                      weights=Topology.ring(4), **_common(**{option: value}))
    out = t.start_consensus()
    assert [p["mix_rounds"] for p in out] == rounds
    assert all(np.isfinite(p["train_loss"]).all() for p in out)


def _small(**over):
    return dict(model="transformer", model_kwargs=LM, device="cpu", **_common(**over))


@pytest.mark.parametrize(
    "over,match",
    [
        (dict(chebyshev=True, mix_eps=1e-3), "mutually exclusive"),
        (dict(chebyshev=True, weights=None), "gamma"),  # isolated nodes
        (dict(adaptive_comm={"target": 1e-2}, chebyshev=True), "mutually exclusive with chebyshev"),
        (dict(global_avg_every=0), "global_avg_every must be >= 1"),
        (dict(superstep=0), "superstep must be >= 1"),
        (dict(adaptive_comm={"target": 1e-2, "speed": 2}), "unknown adaptive_comm keys"),
        (dict(adaptive_comm={"gain": 1.0}), "needs 'target'"),
        (dict(adaptive_comm={"target": 0.0}), "target must be > 0"),
        (dict(adaptive_comm={"target": 1.0, "min_times": 3, "max_times": 2}), "min_times"),
        (dict(adaptive_comm=0.5), "must be a mapping"),
    ],
)
@pytest.mark.filterwarnings("ignore:GossipTrainer. mixing matrix is the identity")
def test_gossip_option_validation(over, match):
    """The JAX trainer's constructor checks, with its messages' meaning."""
    with pytest.raises(ValueError, match=match):
        GossipTrainer(**_small(**{"weights": Topology.ring(4), **over}))


def test_zero_rounds_from_schedule_raise():
    t = GossipTrainer(weights=Topology.ring(4), **_small(mix_times_schedule=lambda e: 0))
    with pytest.raises(ValueError, match="mix_times_schedule\\(0\\) returned 0"):
        t.train_epoch()
    t = GossipTrainer(weights=Topology.ring(4), **_small(mix_times_schedule=lambda e: 1 - e))
    with pytest.raises(ValueError, match="must be >= 1"):
        t.train_epochs(2)  # resolved on the host before the superstep runs
    assert t._epochs_done == 0


def test_master_node_surface_trains_and_reports():
    """The reference constructor surface: a model by name, start_consensus
    over all epochs, telemetry per node and epoch, a falling loss."""
    tel = RecordingTelemetry()
    data = {a: pattern_batch(16, range(8 * a, 8 * a + 8)) for a in NODES}
    master = MasterNode(
        NODES, "transformer", model_args=(V,), optimizer="adam",
        optimizer_kwargs={"lr": 1e-2}, weights=Topology.ring(4),
        train_loaders=data, test_loader=pattern_batch(8, range(V)),
        stat_step=2, epoch=3, epoch_len=4, batch_size=4, telemetry=tel,
        device="cpu", model_kwargs=dict(num_layers=1, num_heads=2, head_dim=16, max_len=T),
    )
    master.initialize_nodes()
    results = master.start_consensus()
    assert [r["epoch"] for r in results] == [0, 1, 2]
    assert results[-1]["train_loss"].mean() < results[0]["train_loss"].mean()
    assert len(tel.by_token()[0]) == 3
    assert len(master.network[0].stats.steps) == 3 * 2
    # The vision zoo is ported: the positional argument is num_classes.
    wrn = get_model("wide-resnet", 10, depth=10, widen_factor=1, device="cpu")
    assert wrn.Dense_0.kernel.shape == (1, 64, 10)
