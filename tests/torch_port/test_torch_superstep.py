"""The port's epoch superstep ``train_epochs(k)`` and the gossip
schedules it carries, on the CPU.

Two oracles, on the MLP and the 48-sample shards of the JAX package's own
superstep tests (``tests/test_trainer.py`` ``_superstep_data``), here
over 4 nodes on a Metropolis ring so that a round does not average
exactly:

* the port's ``train_epochs(3)`` equals three of its ``train_epoch()``
  calls BIT FOR BIT (parameters, optimizer state, traces, round counts,
  deviations, stat curves) for every gossip configuration: plain, eps
  stopping, Chebyshev, Gossip-PGA across ``epoch_cons_num``,
  ``mix_times_schedule``, ``adaptive_comm`` and ``topology_schedule``
  (plain, with Chebyshev, with eps); on the CPU both run the same ops;
* the port's ``train_epochs(3)`` against the JAX package's, from the
  JAX trainer's init carried over by ``convert.py``: equal per-epoch
  round counts and ``mixed`` flags; losses and gradient norms within
  5e-5, parameters within 2e-5 and deviations within 1e-6 (the limits of
  ``test_torch_trainer.py``: float32 sums in another order), accuracies
  exactly.  Learning-rate schedules (SGD with momentum, Adam) take the
  optax schedule itself, at the same limits.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer

NODES = list(range(4))
RING = Topology.ring(4).metropolis_weights()
COMPLETE = Topology.complete(4).metropolis_weights()
K = 3


def _data(seed=0, d=8):
    rng = np.random.default_rng(seed)
    train = {a: (rng.normal(size=(48, d)).astype(np.float32),
                 rng.integers(0, 3, size=(48,)).astype(np.int32)) for a in NODES}
    test = (rng.normal(size=(20, d)).astype(np.float32),
            rng.integers(0, 3, size=(20,)).astype(np.int32))
    return train, test


def _alternating(e):
    return RING if e % 2 == 0 else COMPLETE


CONFIGS = {
    "plain": dict(mix_times=2),
    "eps": dict(mix_eps=1e-3, mix_times=1),
    "cheby": dict(chebyshev=True, mix_times=3),
    "gavg": dict(mix_times=1, global_avg_every=2, epoch_cons_num=2),
    "schedule": dict(mix_times_schedule=lambda e: 1 + e % 3),
    "adaptive": dict(mix_times=2, adaptive_comm={"target": 0.05, "gain": 1.0}),
    "adaptive_eps": dict(mix_eps=2e-2, mix_times=1,
                         adaptive_comm={"target": 0.05, "gain": 0.5, "max_times": 6}),
    "topology": dict(topology_schedule=_alternating, mix_times=2, weights=None),
    "topology_cheby": dict(topology_schedule=_alternating, chebyshev=True, mix_times=3,
                           weights=None),
    "topology_eps": dict(topology_schedule=_alternating, mix_eps=1e-3, weights=None),
}


def _kw(**over):
    train, test = _data()
    kw = dict(node_names=NODES, model="mlp", model_kwargs={"hidden_dim": 8, "output_dim": 3},
              weights=RING, train_data=train, test_data=test, batch_size=8, epoch_len=2,
              stat_step=2, dropout=False, learning_rate=0.05, optimizer="sgd",
              optimizer_kwargs={"momentum": 0.9}, seed=7)
    kw.update(over)
    return kw


def _port(**over):
    t = GossipTrainer(device="cpu", **_kw(**over))
    t.initialize_nodes()
    return t


def _opt_state(t):
    return [v.clone() for st in t._opt.state.values() for v in st.values()
            if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_superstep_equals_per_epoch_loop(name):
    ref = _port(**CONFIGS[name])
    ref_out = [ref.train_epoch() for _ in range(K)]
    sup = _port(**CONFIGS[name])
    sup_out = sup.train_epochs(K)
    assert torch.equal(ref.model.flat_params, sup.model.flat_params)
    for a, b in zip(_opt_state(ref), _opt_state(sup)):
        assert torch.equal(a, b)
    assert len(sup_out) == K
    for j, (ro, so) in enumerate(zip(ref_out, sup_out)):
        assert so["epoch"] == ro["epoch"] == j
        assert so["mixed"] == ro["mixed"] and so["mix_rounds"] == ro["mix_rounds"]
        for key in ("train_loss", "train_acc", "grad_norm"):
            np.testing.assert_array_equal(so[key], ro[key], err_msg=f"{name} {key}")
        assert so["deviation"] == ro["deviation"]
        # The test set is evaluated once, at the superstep's boundary.
        if j < K - 1:
            assert so["test_acc"] is None
        else:
            np.testing.assert_array_equal(so["test_acc"], ro["test_acc"])
    for a in NODES:
        assert ref.network[a].stats.train_loss == sup.network[a].stats.train_loss
        assert ref.network[a].stats.steps == sup.network[a].stats.steps


def _jax_pair(**over):
    kw = _kw(**over)
    jt = JaxTrainer(**{k: v for k, v in kw.items()})
    jt.initialize_nodes()
    tt = GossipTrainer(device="cpu", **kw)
    tt.initialize_nodes(params=flax_to_torch(jax.tree.map(np.asarray, jt.state[0]),
                                             n_agents=len(NODES)))
    return jt, tt


def _assert_close_to_jax(jt, tt, pj, pt, label):
    assert [p["mix_rounds"] for p in pt] == [int(p["mix_rounds"]) for p in pj], label
    assert [p["mixed"] for p in pt] == [bool(p["mixed"]) for p in pj], label
    for a, b in zip(pt, pj):
        for key in ("train_loss", "grad_norm"):
            np.testing.assert_allclose(a[key], np.asarray(b[key]), atol=5e-5,
                                       err_msg=f"{label} {key}")
        np.testing.assert_array_equal(a["train_acc"], np.asarray(b["train_acc"]))
        assert a["deviation"] == pytest.approx(b["deviation"], abs=1e-6), label
    np.testing.assert_array_equal(pt[-1]["test_acc"], np.asarray(pj[-1]["test_acc"]))
    want = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=len(NODES))
    for name, p in tt.model.stacked_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=2e-5,
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_superstep_matches_jax_superstep(name):
    jt, tt = _jax_pair(**CONFIGS[name])
    _assert_close_to_jax(jt, tt, jt.train_epochs(K), tt.train_epochs(K), name)


def test_adaptive_gain_zero_runs_the_static_rounds():
    """gain 0 leaves every epoch's count at the configured one, bit for
    bit the static run, whatever the residual."""
    static = _port(mix_times=2)
    adaptive = _port(mix_times=2, adaptive_comm={"target": 1e-9, "gain": 0.0})
    s_out, a_out = static.train_epochs(K), adaptive.train_epochs(K)
    assert [p["mix_rounds"] for p in a_out] == [p["mix_rounds"] for p in s_out] == [2] * K
    assert torch.equal(static.model.flat_params, adaptive.model.flat_params)


def test_adaptive_rounds_follow_the_residual():
    """A target far under the residual raises the count to max_times,
    and the controller starts from the configured count."""
    t = _port(mix_times=2, adaptive_comm={"target": 1e-6, "gain": 1.0, "max_times": 5})
    rounds = [p["mix_rounds"] for p in t.train_epochs(K)]
    assert rounds == [2, 5, 5]


@pytest.mark.parametrize(
    "optimizer,kwargs,schedule",
    [
        ("sgd", {"momentum": 0.9, "weight_decay": 5e-4},
         optax.cosine_decay_schedule(0.1, decay_steps=6, alpha=0.1)),
        ("adam", {}, optax.linear_schedule(1e-2, 1e-3, transition_steps=5)),
        # eps_root builds the port's own Adam (torch's has no such term).
        ("adamw", {"eps_root": 1e-8, "weight_decay": 1e-2},
         optax.linear_schedule(1e-2, 1e-3, transition_steps=5)),
    ],
)
def test_learning_rate_schedule_matches_jax(optimizer, kwargs, schedule):
    """The optax schedule itself drives both trainers, read at the update
    count before each update."""
    jt, tt = _jax_pair(optimizer=optimizer, optimizer_kwargs=kwargs,
                       learning_rate=schedule, mix_times=1)
    _assert_close_to_jax(jt, tt, jt.train_epochs(K), tt.train_epochs(K), optimizer)
    # Then two single epochs: the count carries on across calls.
    for _ in range(2):
        pj, pt = jt.train_epoch(), tt.train_epoch()
        np.testing.assert_allclose(pt["train_loss"], np.asarray(pj["train_loss"]), atol=5e-5)


def test_start_consensus_runs_superstep_chunks():
    """superstep=2 over 5 epochs: chunks of 2, 2 and 1, the trajectory of
    five single epochs; a test accuracy at each chunk's boundary."""
    ref = _port(mix_times=1, epoch=5)
    ref_out = ref.start_consensus()
    sup = _port(mix_times=1, epoch=5, superstep=2)
    sup_out = sup.start_consensus()
    assert [p["epoch"] for p in sup_out] == list(range(5))
    assert [p["test_acc"] is not None for p in sup_out] == [False, True, False, True, True]
    assert torch.equal(ref.model.flat_params, sup.model.flat_params)
    assert [p["deviation"] for p in sup_out] == [p["deviation"] for p in ref_out]


def test_graph_replays_count_their_captured_launches():
    """GraphSet.replay counts the capture's launch record and its obs
    record once per replay, and the replays per graph (a stand-in graph:
    no card here)."""
    from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry
    from distributed_learning_tpu_torch.ops import flash_attention as fa
    from distributed_learning_tpu_torch.training.graphs import GraphSet

    class FakeGraph:
        replayed = 0

        def replay(self):
            FakeGraph.replayed += 1

    graphs = object.__new__(GraphSet)
    graphs._graphs, graphs.replays = {}, __import__("collections").Counter()
    record = __import__("collections").Counter({("flash_fwd", "wgmma"): 16,
                                                ("flash_bwd_rowterm", "cuda_core"): 8})
    counted = MetricsRegistry()
    counted.inc("consensus.rounds_run", 2)
    counted.gauge("consensus.leaf_count", 7)
    graphs._graphs[("train",)] = (FakeGraph(), record, counted)
    fa.reset_launch_counts()
    with use_registry(MetricsRegistry()) as reg:
        for _ in range(3):
            graphs.replay(("train",))
    assert FakeGraph.replayed == 3 and graphs.replays[("train",)] == 3
    assert reg.counters == {"consensus.rounds_run": 6.0}
    assert reg.gauges == {"consensus.leaf_count": 7.0}
    assert fa.KERNELS["flash_fwd"].by_body["wgmma"] == 48
    assert fa.KERNELS["flash_bwd_rowterm"].launches == 24
    fa.reset_launch_counts()


def test_state_snapshot_undoes_a_warm_up():
    """Tensors come back by identity, state created after the snapshot is
    zeroed, generators rewind to their draws."""
    from distributed_learning_tpu_torch.training.graphs import StateSnapshot

    a, g = torch.arange(4.0), torch.Generator().manual_seed(3)
    state = [a]
    snap = StateSnapshot(lambda: state, [g])
    first = torch.rand(2, generator=g)
    a.add_(1.0)
    state.append(torch.ones(3))  # e.g. Adam's moments, created by the warm-up
    snap.restore()
    assert torch.equal(a, torch.arange(4.0)) and torch.equal(state[1], torch.zeros(3))
    assert torch.equal(torch.rand(2, generator=g), first)
