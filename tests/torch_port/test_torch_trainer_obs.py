"""Observability in the port's trainer (options ``obs``, ``profile_costs``,
``timer_every_n``; the engines' obs hooks), on the CPU, on the MLP of
``test_torch_trainer_async_robust.py`` (4 nodes, 48-sample shards).

* obs-on, ``profile_costs=True`` and ``timer_every_n=2`` each leave the
  run bit-identical to obs-off: three ``train_epoch()`` calls and a
  ``train_epochs(3)`` superstep, for dense, CHOCO, async and robust
  gossip (payloads, parameters, statistics, optimizer and gossip state);
* against the JAX trainer with ``obs=MetricsRegistry()`` (and its own
  default registry scoped for the engines' hooks): the same series
  names and steps, values within the trainer oracle's limits (losses and
  gradient norms 5e-5, accuracies exactly, residuals 1e-6; the robust
  mass 1e-6 relative); the same consensus counters and gauges on both
  registries (``rounds_run``, ``bytes_mixed``, ``leaf_count``,
  ``fused_buckets``, ``compressed_bytes``, ``compression_ratio``,
  ``global_averages``, ``robust.rounds``, ``mix_until.calls``,
  ``robust.clipped_mass``), exactly but the mass;
* a superstep counts what its epochs would have counted one by one;
* the telemetry payloads carry ``step_time_s`` / ``mfu`` with the timer
  on, set on sampled chunks only; the step's cost profile counts the
  MLP's products exactly and the MFU follows the loop convention;
* no option is left unported (``mesh`` and ``remat`` run).
"""

import jax
import numpy as np
import pytest
import torch

from distributed_learning_tpu.obs import MetricsRegistry as JaxRegistry
from distributed_learning_tpu.obs import use_registry as jax_use_registry
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry
from distributed_learning_tpu_torch.obs import cost as tcost
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from distributed_learning_tpu_torch.utils.telemetry import RecordingTelemetry
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

NODES = list(range(4))
RING = Topology.ring(4).metropolis_weights()
COMPLETE = Topology.complete(4).metropolis_weights()
K = 3
CONFIGS = {
    "dense": dict(mix_times=2),
    "pga": dict(mix_times=2, global_avg_every=2),
    "eps": dict(mix_eps=1e-3),
    "choco": dict(compression="topk:0.3", compression_gamma=0.3, mix_times=2),
    "async": dict(async_gossip={"staleness_bound": 1, "publish_period": [1, 1, 1, 3]},
                  mix_times=2),
    "robust": dict(robust_mixing={"kind": "trim", "trim": 1}, weights=COMPLETE),
}
BIT_CONFIGS = ["dense", "choco", "async", "robust"]
OBS_OPTIONS = {
    "obs": lambda: dict(obs=MetricsRegistry()),
    "profile_costs": lambda: dict(profile_costs=True),
    "timer": lambda: dict(timer_every_n=2),
}


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


def _run(t):
    return [t.train_epoch() for _ in range(K)] + t.train_epochs(K)


def _state(t):
    out = {"params": t.model.flat_params, "stats": t.model.flat_stats,
           "grads": t.model.flat_grads,
           "counters": (t._epochs_done, t._global_step, t._opt_steps),
           "masses": list(t._robust_masses)}
    for st in t._opt.state.values():
        out.update({f"opt.{k}": v for k, v in st.items()})
    if t._async_state is not None:
        out.update(pub=t._async_state.pub["float32"], age=t._async_state.age,
                   rnd=t._async_state.rnd)
    if t._choco is not None:
        out.update(xhat=t._choco_xhat, gen=t._choco_gen.get_state())
    out["gens"] = [g.get_state() for g in t._train_generators]
    return out


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, list):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("option", sorted(OBS_OPTIONS))
@pytest.mark.parametrize("name", BIT_CONFIGS)
def test_obs_options_leave_the_run_bit_identical(name, option):
    off = _port(**CONFIGS[name])
    out_off = _run(off)
    with use_registry(MetricsRegistry()):
        on = _port(**CONFIGS[name], **OBS_OPTIONS[option]())
        out_on = _run(on)
    for a, b in zip(out_off, out_on):
        assert a.keys() == b.keys()
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
            else:
                assert a[key] == b[key], key
    sa, sb = _state(off), _state(on)
    assert sa.keys() == sb.keys()
    for key in sa:
        assert _equal(sa[key], sb[key]), key
    tcost.clear_profiles()


def _jax_pair(**over):
    kw = _kw(**over)
    jt = JaxTrainer(obs=JaxRegistry(), **kw)
    jt.initialize_nodes()
    tt = GossipTrainer(device="cpu", obs=MetricsRegistry(), **kw)
    tt.initialize_nodes(params=flax_to_torch(jax.tree.map(np.asarray, jt.state[0]),
                                             n_agents=len(NODES)))
    return jt, tt


def _series(reg):
    return {name: list(pts) for name, pts in reg.series.items()}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_series_and_counters_match_jax_trainer(name):
    with jax_use_registry(JaxRegistry()) as jdef, use_registry(MetricsRegistry()) as tdef:
        jt, tt = _jax_pair(**CONFIGS[name])
        for _ in range(K):
            jt.train_epoch()
            tt.train_epoch()
    js, ts = _series(jt._obs_registry), _series(tt._obs_registry)
    assert sorted(js) == sorted(ts)
    for key in js:
        assert [s for s, _ in ts[key]] == [s for s, _ in js[key]], key
        got, want = [v for _, v in ts[key]], [v for _, v in js[key]]
        if key.startswith("train.acc") or key.startswith("eval."):
            assert got == want, key
        elif key.startswith("consensus.robust"):
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, atol=5e-5 if key.startswith("train") else 1e-6,
                                       err_msg=key)
    jc, tc = jt._obs_registry.counters, tt._obs_registry.counters
    assert sorted(jc) == sorted(tc)
    for key in jc:
        if key == "consensus.robust.clipped_mass":
            assert tc[key] == pytest.approx(jc[key], rel=1e-6)
        else:
            assert tc[key] == jc[key], key
    # The engines' hooks, on each package's default registry.
    assert tdef.counters == jdef.counters
    assert tdef.gauges == jdef.gauges
    assert tdef.counters  # every configuration here gossips


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_superstep_counts_what_its_epochs_count(name):
    runs = {}
    for route in ("epochs", "superstep"):
        with use_registry(MetricsRegistry()) as default:
            t = _port(**CONFIGS[name], obs=MetricsRegistry())
            if route == "epochs":
                [t.train_epoch() for _ in range(K)]
            else:
                t.train_epochs(K)
        runs[route] = (default.counters, default.gauges, t._obs_registry)
    (ce, ge, re), (cs, gs, rs) = runs["epochs"], runs["superstep"]
    assert cs == ce and gs == ge
    for key in ("consensus.rounds_run", "consensus.robust.clipped_mass"):
        assert rs.counters.get(key) == re.counters.get(key), key
    # The consensus series per epoch; the test set is evaluated once, at
    # the superstep's boundary.
    assert {k: v for k, v in rs.series.items() if k.startswith("consensus")} == \
        {k: v for k, v in re.series.items() if k.startswith("consensus")}
    assert rs.series["eval.test_acc"] == re.series["eval.test_acc"][-1:]
    # Dispatches: 3 an epoch eagerly (steps, gossip, deviation), 2 a
    # superstep epoch (steps; gossip with its deviation) unless the round
    # count needs the residual.
    assert re.counters["trainer.dispatches"] == K * 3
    assert rs.counters["trainer.dispatches"] == K * (3 if name == "eps" else 2)


@pytest.mark.parametrize("every_n", [0, 2])
def test_telemetry_gains_cost_keys_on_sampled_chunks(every_n, monkeypatch):
    monkeypatch.setenv(tcost.PEAK_FLOPS_ENV, "1e12")
    tel = RecordingTelemetry()
    jtel = __import__("distributed_learning_tpu.utils.telemetry",
                      fromlist=["RecordingTelemetry"]).RecordingTelemetry()
    with use_registry(MetricsRegistry()), jax_use_registry(JaxRegistry()):
        t = _port(telemetry=tel, timer_every_n=every_n, profile_costs=True)
        jt = JaxTrainer(telemetry=jtel, timer_every_n=every_n, **_kw())
        jt.initialize_nodes()
        for _ in range(K):
            t.train_epoch()
            jt.train_epoch()
    recs = [p for _, p in tel.records]
    jrecs = [p for _, p in jtel.records]
    assert [sorted(p) for p in recs] == [sorted(p) for p in jrecs]
    if every_n == 0:
        assert "step_time_s" not in recs[0] and "mfu" not in recs[0]
        return
    sampled = [p["epoch"] % every_n == 0 for p in recs]
    assert [p["step_time_s"] is not None for p in recs] == sampled
    assert [p["mfu"] is not None for p in recs] == sampled
    assert [p["step_time_s"] is not None for p in jrecs] == sampled
    prof = tcost.get_profile("trainer.epoch")
    for p in recs:
        if p["step_time_s"] is not None:
            assert p["mfu"] == pytest.approx(prof.flops * t.epoch_len / p["step_time_s"] / 1e12)
    tcost.clear_profiles()


def test_step_profile_counts_the_mlps_products():
    with use_registry(MetricsRegistry()) as default:
        t = _port(profile_costs=True, obs=MetricsRegistry())
        t.train_epoch()
        t.train_epochs(2)
    dims = [8, 8, 8, 8, 3]
    macs = sum(a * b for a, b in zip(dims, dims[1:]))
    n_b = len(NODES) * 8  # agents x batch
    want = 2 * n_b * (2 * macs + (macs - dims[0] * dims[1]))  # fwd, dW, dX (no dX for layer 0)
    for name in ("trainer.epoch", "trainer.superstep2"):
        prof = tcost.get_profile(name)
        assert prof.flops == want and prof.platform == "cpu", name
        assert t._obs_registry.gauges[f"cost.flops/{name}"] == want
    assert "cost.flops/trainer.epoch" not in default.gauges
    tcost.clear_profiles()


def test_unported_still_rejects_mesh_and_remat():
    """``mesh`` and ``remat`` are both ported now: no ``_UNPORTED`` table
    is left, and a mesh that is not an ``AgentMesh`` is refused."""
    from distributed_learning_tpu_torch.training import trainer

    assert not hasattr(trainer, "_UNPORTED")
    with pytest.raises(ValueError, match="AgentMesh"):
        GossipTrainer(device="cpu", **_kw(mesh="agents"))
    assert GossipTrainer(device="cpu", **_kw(remat=True)).remat
    with pytest.raises(ValueError, match="obs must be"):
        GossipTrainer(device="cpu", **_kw(obs="yes"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_superstep_series_match_jax_trainer(name):
    """train_epochs(3): the JAX superstep is one compiled dispatch, so its
    trainer registry carries the series and the round / mass counters
    (its engines count nothing inside the trace); the port's equal them.
    ``trainer.dispatches`` differs by design: 1 compiled dispatch there,
    the replays here."""
    with jax_use_registry(JaxRegistry()), use_registry(MetricsRegistry()):
        jt, tt = _jax_pair(**CONFIGS[name])
        jt.train_epochs(K)
        tt.train_epochs(K)
    js, ts = _series(jt._obs_registry), _series(tt._obs_registry)
    assert sorted(js) == sorted(ts)
    for key in js:
        assert [s for s, _ in ts[key]] == [s for s, _ in js[key]], key
        np.testing.assert_allclose([v for _, v in ts[key]], [v for _, v in js[key]],
                                   rtol=1e-6, atol=5e-5, err_msg=key)
    jc, tc = jt._obs_registry.counters, tt._obs_registry.counters
    assert sorted(jc) == sorted(tc)
    assert tc.get("consensus.rounds_run") == jc.get("consensus.rounds_run")
    assert tc.get("consensus.robust.clipped_mass", 0.0) == pytest.approx(
        jc.get("consensus.robust.clipped_mass", 0.0), rel=1e-6)
    assert jc["trainer.dispatches"] == 1
