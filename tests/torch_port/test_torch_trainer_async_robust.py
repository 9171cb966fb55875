"""Asynchronous (stale-weighted) and Byzantine-robust gossip in the port's
trainer, on the CPU.

The MLP and the 48-sample shards of ``test_torch_trainer_choco.py``, 4
nodes, SGD with momentum 0.9, one configuration per route of
``chip_smoke.py``'s ``robust_routes`` phase.  Oracles:

* the port against the JAX package's trainer from the JAX init carried
  over by ``convert.py``, for ``train_epoch`` x 3 and ``train_epochs(3)``,
  with the limits of ``test_torch_trainer_choco.py``: equal round counts
  and ``mixed`` flags, losses and gradient norms within 5e-5, parameters
  and the published buffer within 2e-5, deviations within 1e-6,
  accuracies, ages and the round counter exactly;
* (the clip routes compare deviations at 2e-5, ``CLIP_DEVIATION_ATOL``)
* each run's per-epoch redirected masses (``_robust_masses``) summed
  against the reference's ``consensus.robust.clipped_mass`` counter: to
  1e-6 relative for trim and median, whose mass counts trimmed
  coordinates; to 1e-3 for clip (``CLIP_MASS_RTOL``);
* the port's ``train_epochs(3)`` equals three ``train_epoch()`` calls bit
  for bit, the async carry and the masses included;
* the constructor rejects what the reference rejects, with its texts,
  and a staleness schedule that raises leaves every tensor as it was.
"""

import jax
import numpy as np
import pytest
import torch

from distributed_learning_tpu.obs import MetricsRegistry
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

NODES = list(range(4))
RING = Topology.ring(4).metropolis_weights()
COMPLETE = Topology.complete(4).metropolis_weights()
K = 3
# Agent 3 publishes every third round; a contribution older than one
# round is dropped.
STRAGGLER = {"staleness_bound": 1, "publish_period": [1, 1, 1, 3]}
CLIP = {"kind": "clip", "radius": 0.05}

CONFIGS = {
    "async_neutral": dict(async_gossip={"staleness_bound": 0, "publish_period": 1}, mix_times=2),
    "async_straggler": dict(async_gossip=STRAGGLER, mix_times=2),
    "async_tau_schedule": dict(async_gossip={"staleness_bound": lambda e: e % 3,
                                             "publish_period": [1, 2, 1, 3]}, mix_times=2),
    "async_mix_times_schedule": dict(async_gossip=STRAGGLER,
                                     mix_times_schedule=lambda e: 1 + e % 3),
    "async_adaptive_comm": dict(async_gossip=STRAGGLER, mix_times=2,
                                adaptive_comm={"target": 0.05, "gain": 1.0}),
    "clip": dict(robust_mixing=CLIP, mix_times=2),
    "clip_adaptive": dict(robust_mixing={"kind": "clip", "radius": 0.5, "adaptive": True},
                          mix_times=2),
    "trim": dict(robust_mixing={"kind": "trim", "trim": 1}, weights=COMPLETE),
    "median": dict(robust_mixing="median", weights=COMPLETE, mix_times=2),
    "async_clip": dict(async_gossip=STRAGGLER, robust_mixing=CLIP, mix_times=2),
    "async_trim": dict(async_gossip=STRAGGLER, robust_mixing={"kind": "trim", "trim": 1},
                       weights=COMPLETE, mix_times=2),
}
ROBUST = [name for name, cfg in CONFIGS.items() if "robust_mixing" in cfg]
# Clipping reads the distances from the Gram form sx + sy - 2 x.y, whose
# float32 cancellation differs with the summation order: on these
# buffers sx ~ 23 against squared deltas of 0.04-0.14, and the two sides'
# squared distances differ by up to 1.7e-4 relative (each as far from a
# float64 direct distance).  The clip scales r / ||x_j - x_i|| carry that
# into the trajectory and the mass, so the clip routes compare their
# deviations at the parameters' 2e-5 (measured gap up to 1.1e-5) and their
# masses to 1e-3 relative (measured up to 1.8e-4).  Fed the same distances, the clip matrices and
# masses agree to 1e-7 (test_torch_async_robust_mixing.py).
CLIP_DEVIATION_ATOL = 2e-5
CLIP_MASS_RTOL = 1e-3


def _data(seed=0, d=8):
    rng = np.random.default_rng(seed)
    train = {a: (rng.normal(size=(48, d)).astype(np.float32),
                 rng.integers(0, 3, size=(48,)).astype(np.int32)) for a in NODES}
    test = (rng.normal(size=(20, d)).astype(np.float32),
            rng.integers(0, 3, size=(20,)).astype(np.int32))
    return train, test


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


def _state(t):
    """Every tensor and counter a run leaves behind, copied."""
    out = {"params": t.model.flat_params.clone(), "stats": t.model.flat_stats.clone(),
           "counters": (t._epochs_done, t._global_step, t._opt_steps),
           "masses": list(t._robust_masses)}
    for st in t._opt.state.values():
        for k, v in st.items():
            out[f"opt.{k}"] = v.clone() if isinstance(v, torch.Tensor) else v
    if t._async_state is not None:
        out["pub"] = t._async_state.pub["float32"].clone()
        out["age"] = t._async_state.age.clone()
        out["rnd"] = t._async_state.rnd.clone()
    if t._robust_mass is not None:
        out["mass"] = t._robust_mass.clone()
    return out


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_async_robust_superstep_equals_per_epoch_loop(name):
    ref = _port(**CONFIGS[name])
    ref_out = [ref.train_epoch() for _ in range(K)]
    sup = _port(**CONFIGS[name])
    sup_out = sup.train_epochs(K)
    for a, b in zip(ref_out, sup_out):
        assert a["mixed"] == b["mixed"] and a["mix_rounds"] == b["mix_rounds"]
        for key in ("train_loss", "train_acc", "grad_norm"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["deviation"] == b["deviation"]
    _assert_states_equal(_state(ref), _state(sup))


def _jax_pair(**over):
    kw = _kw(**over)
    jt = JaxTrainer(obs=MetricsRegistry(), **kw)
    jt.initialize_nodes()
    tt = GossipTrainer(device="cpu", **kw)
    tt.initialize_nodes(params=flax_to_torch(jax.tree.map(np.asarray, jt.state[0]),
                                             n_agents=len(NODES)))
    return jt, tt


def _pub_tree(tt):
    flat, named = tt._async_state.pub["float32"], tt.model.stacked_parameters()
    return {name: flat[:, off: off + size].reshape(named[name].shape).numpy()
            for name, (off, size) in tt.model.param_slices.items()}


@pytest.mark.parametrize("route", ["train_epoch", "train_epochs"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_async_robust_trainer_matches_jax(name, route):
    jt, tt = _jax_pair(**CONFIGS[name])
    if route == "train_epoch":
        pj = [jt.train_epoch() for _ in range(K)]
        pt = [tt.train_epoch() for _ in range(K)]
    else:
        pj, pt = jt.train_epochs(K), tt.train_epochs(K)
    assert [p["mix_rounds"] for p in pt] == [int(p["mix_rounds"]) for p in pj]
    assert [p["mixed"] for p in pt] == [bool(p["mixed"]) for p in pj]
    for a, b in zip(pt, pj):
        for key in ("train_loss", "grad_norm"):
            np.testing.assert_allclose(a[key], np.asarray(b[key]), atol=5e-5, err_msg=key)
        np.testing.assert_array_equal(a["train_acc"], np.asarray(b["train_acc"]))
        assert a["deviation"] == pytest.approx(
            b["deviation"], abs=CLIP_DEVIATION_ATOL if "clip" in name else 1e-6)
    np.testing.assert_array_equal(pt[-1]["test_acc"], np.asarray(pj[-1]["test_acc"]))
    want = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=len(NODES))
    for pname, p in tt.model.stacked_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(), want[pname], atol=2e-5, err_msg=pname)
    if "async_gossip" in CONFIGS[name]:
        st = jt._async_state
        np.testing.assert_array_equal(tt._async_state.age.numpy(), np.asarray(st.age))
        assert int(tt._async_state.rnd) == int(st.rnd)
        want = flax_to_torch(jax.tree.map(np.asarray, st.pub), n_agents=len(NODES))
        got = _pub_tree(tt)
        for pname in want:
            np.testing.assert_allclose(got[pname], want[pname], atol=2e-5, err_msg=pname)
    counters = jt._obs_registry.snapshot()["counters"]
    if name in ROBUST:
        ref_mass = counters["consensus.robust.clipped_mass"]
        assert len(tt._robust_masses) == K
        rtol = CLIP_MASS_RTOL if "clip" in name else 1e-6
        assert sum(tt._robust_masses) == pytest.approx(ref_mass, rel=rtol)
        assert ref_mass > 0.0  # every robust route here bites
    else:
        assert "consensus.robust.clipped_mass" not in counters and not tt._robust_masses


def test_async_straggler_ages_and_decay():
    """Agent 3 publishes every third round: over 3 epochs of 2 rounds its
    age runs 0, 1, 2, 0, 1, 2, and the async run leaves the plain one."""
    t = _port(**CONFIGS["async_straggler"])
    ages = []
    for _ in range(K):
        t.train_epoch()
        ages.append(t._async_state.age.tolist())
    assert ages == [[0, 0, 0, 1], [0, 0, 0, 0], [0, 0, 0, 2]]
    assert int(t._async_state.rnd) == 2 * K
    plain = _port(mix_times=2)
    [plain.train_epoch() for _ in range(K)]
    assert not torch.equal(plain.model.flat_params, t.model.flat_params)


@pytest.mark.parametrize("over", [
    dict(async_gossip={"staleness_bound": 0, "publish_period": 1}),
    dict(robust_mixing="clip"),
    dict(robust_mixing={"kind": "trim", "trim": 0}),
    dict(async_gossip={"staleness_bound": 0, "publish_period": 1},
         robust_mixing={"kind": "clip", "radius": float("inf"), "adaptive": True}),
])
def test_neutral_knobs_are_bitwise_the_plain_trainer(over):
    plain = _port(mix_times=2)
    plain_out = plain.train_epochs(K)
    knob = _port(mix_times=2, **over)
    knob_out = knob.train_epochs(K)
    assert torch.equal(plain.model.flat_params, knob.model.flat_params)
    assert [p["deviation"] for p in plain_out] == [p["deviation"] for p in knob_out]
    assert all(m == 0.0 for m in knob._robust_masses)


def test_fresh_carry_at_initialize_and_kept_by_restore(tmp_path):
    """``initialize_nodes`` restarts the carry; a checkpoint holds none,
    and ``restore_checkpoint`` leaves the carry as it is."""
    t = _port(**CONFIGS["async_straggler"])
    t.train_epochs(2)
    path = str(tmp_path / "ckpt.pt")
    t.save_checkpoint(path)
    t.train_epoch()
    carry = (t._async_state.pub["float32"].clone(), t._async_state.age.clone(),
             t._async_state.rnd.clone())
    t.restore_checkpoint(path)
    assert torch.equal(t._async_state.pub["float32"], carry[0])
    assert torch.equal(t._async_state.age, carry[1]) and int(t._async_state.rnd) == 6
    t.initialize_nodes()
    assert int(t._async_state.rnd) == 0 and not t._async_state.age.any()
    assert not t._async_state.pub["float32"].any()


def test_staleness_schedule_that_raises_leaves_the_state():
    def tau(e):
        return 1 if e < 1 else -1

    for run in ("train_epoch", "train_epochs"):
        t = _port(async_gossip={"staleness_bound": tau, "publish_period": [1, 1, 1, 3]})
        t.train_epoch()
        before = _state(t)
        with pytest.raises(ValueError, match=r"staleness_bound\(1\) returned -1; must be >= 0"):
            t.train_epoch() if run == "train_epoch" else t.train_epochs(2)
        _assert_states_equal(before, _state(t))


@pytest.mark.parametrize(
    "over,exc,match",
    [
        (dict(async_gossip=3), ValueError, "async_gossip must be a mapping"),
        (dict(async_gossip={"tau": 1}), ValueError, "unknown async_gossip keys"),
        (dict(async_gossip={"staleness_bound": 1}, chebyshev=True), ValueError,
         "async_gossip applies to the plain-mix config only"),
        (dict(async_gossip={"staleness_bound": 1}, mix_eps=1e-3), ValueError,
         "async_gossip applies to the plain-mix config only"),
        (dict(async_gossip={"staleness_bound": 1}, topology_schedule=lambda e: RING),
         ValueError, "async_gossip applies to the plain-mix config only"),
        (dict(async_gossip={"staleness_bound": 1}, global_avg_every=2), ValueError,
         "async_gossip applies to the plain-mix config only"),
        (dict(async_gossip={"staleness_bound": 1}, compression="topk:0.3"), ValueError,
         "async_gossip applies to the plain-mix config only"),
        (dict(robust_mixing="nope"), ValueError, "robust_mixing kind must be one of"),
        (dict(robust_mixing={"kind": "clip", "bogus": 1}), ValueError,
         "unknown robust_mixing key"),
        (dict(robust_mixing={"kind": "trim", "trim": -1}), ValueError, "trim must be >= 0"),
        (dict(robust_mixing=3.5), TypeError, "robust_mixing must be a RobustConfig"),
        (dict(robust_mixing="clip", chebyshev=True), ValueError,
         "robust_mixing applies to the plain-mix"),
        (dict(robust_mixing="clip", global_avg_every=2), ValueError,
         "robust_mixing applies to the plain-mix"),
        (dict(robust_mixing="clip", compression="sign"), ValueError,
         "robust_mixing applies to the plain-mix"),
    ],
)
def test_async_robust_constructor_rejections_match_jax(over, exc, match):
    with pytest.raises(exc, match=match):
        JaxTrainer(**_kw(**over))
    with pytest.raises(exc, match=match):
        GossipTrainer(device="cpu", **_kw(**over))


def test_options_are_ported():
    from distributed_learning_tpu_torch.training import trainer

    assert not hasattr(trainer, "_UNPORTED")  # every option of the reference is ported
    t = _port(async_gossip=STRAGGLER, robust_mixing="median", weights=COMPLETE)
    assert t._async_sim["periods"] == (1, 1, 1, 3) and t._robust_cfg.kind == "median"
