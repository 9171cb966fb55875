"""CHOCO compressed gossip in the port's trainer, its checkpoints, and the
schedule repairs, on the CPU.

The MLP and the 48-sample shards of ``test_torch_superstep.py``, 4 nodes
on a Metropolis ring, SGD with momentum 0.9.  Oracles:

* the port against the JAX package's trainer from the JAX init carried
  over by ``convert.py``, with the same shuffle streams, for
  ``train_epoch`` x 3 and ``train_epochs(3)``: equal round counts and
  ``mixed`` flags; losses and gradient norms within 5e-5, parameters and
  CHOCO estimates within 2e-5, deviations within 1e-6 (the limits of
  ``test_torch_superstep.py``; the CHOCO round itself rounds as the
  reference's does, ``test_torch_compression.py``; int8 within 2e-4,
  see ``PARAM_ATOL``), accuracies exactly;
* the port's ``train_epochs(3)`` equals three ``train_epoch()`` calls bit
  for bit, estimates, error-feedback bank and generator included, for
  every compressor kind and budget (random-k too, whose draws cannot
  follow ``jax.random``);
* the constructor rejects what the reference rejects, with its texts.

Checkpoints and the schedule repairs: ``test_torch_checkpoint.py``.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

NODES = list(range(4))
RING = Topology.ring(4).metropolis_weights()
K = 3


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


# Configurations the JAX package's trainer runs too.
JAX_CONFIGS = {
    "topk": dict(compression="topk:0.3", mix_times=2),
    "pga_reset": dict(compression="topk:0.3", global_avg_every=2),
    "pga_reset_late": dict(compression="topk:0.3", global_avg_every=3, epoch_cons_num=2),
    "schedule": dict(compression="topk:0.3", mix_times_schedule=lambda e: 1 + e % 3),
    "global_ef": dict(compression="topk:0.2", compression_budget="global",
                      compression_error_feedback=True, mix_times=2, compression_gamma=0.1),
    "atopk": dict(compression="atopk:0.3"),
    "sign": dict(compression="sign", compression_gamma=0.1),
    "int8": dict(compression="int8", mix_times=2),
    "perleaf_oracle": dict(compression="topk:0.3", fused_consensus=False),
    "adaptive": dict(compression="topk:0.3", mix_times=2,
                     adaptive_comm={"target": 0.05, "gain": 1.0}),
}
# And the port's own: random draws, which follow no JAX stream.
PORT_CONFIGS = dict(
    JAX_CONFIGS,
    randk=dict(compression="randk:0.3", mix_times=2),
    randk_global_ef=dict(compression="randk:0.3", compression_budget="global",
                         compression_error_feedback=True, compression_gamma=0.1),
    randk_pga=dict(compression="randk:0.3", global_avg_every=2),
    randk_perleaf_oracle=dict(compression="randk:0.3", fused_consensus=False),
    # The other kinds under the other budget, and per-leaf error feedback.
    atopk_global=dict(compression="atopk:0.3", compression_budget="global"),
    sign_global=dict(compression="sign", compression_budget="global", compression_gamma=0.1),
    int8_global_ef=dict(compression="int8", compression_budget="global",
                        compression_error_feedback=True, compression_gamma=0.1),
    topk_ef=dict(compression="topk:0.3", compression_error_feedback=True,
                 compression_gamma=0.1),
)


def _state(t):
    """Every tensor and counter a run leaves behind, copied."""
    out = {"params": t.model.flat_params.clone(), "stats": t.model.flat_stats.clone(),
           "counters": (t._epochs_done, t._global_step, t._opt_steps)}
    for st in t._opt.state.values():
        for k, v in st.items():
            out[f"opt.{k}"] = v.clone() if isinstance(v, torch.Tensor) else v
    for i, g in enumerate(t._generators):
        out[f"gen{i}"] = g.get_state()
    if t._choco is not None:
        out["xhat"] = t._choco_xhat.clone()
        out["present"] = t._choco_present
        if t._choco_ef is not None:
            out["ef"] = t._choco_ef.clone()
    return out


def _assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _assert_payloads_equal(pa, pb):
    assert len(pa) == len(pb)
    for a, b in zip(pa, pb):
        assert a["mixed"] == b["mixed"] and a["mix_rounds"] == b["mix_rounds"]
        for key in ("train_loss", "train_acc", "grad_norm"):
            np.testing.assert_array_equal(a[key], b[key])
        assert a["deviation"] == b["deviation"]


@pytest.mark.parametrize("name", sorted(PORT_CONFIGS))
def test_choco_superstep_equals_per_epoch_loop(name):
    ref = _port(**PORT_CONFIGS[name])
    ref_out = [ref.train_epoch() for _ in range(K)]
    sup = _port(**PORT_CONFIGS[name])
    sup_out = sup.train_epochs(K)
    _assert_payloads_equal(ref_out, sup_out)
    _assert_states_equal(_state(ref), _state(sup))


def _jax_pair(**over):
    kw = _kw(**over)
    jt = JaxTrainer(**kw)
    jt.initialize_nodes()
    tt = GossipTrainer(device="cpu", **kw)
    tt.initialize_nodes(params=flax_to_torch(jax.tree.map(np.asarray, jt.state[0]),
                                             n_agents=len(NODES)))
    return jt, tt


def _port_tree(tt, flat):
    named = tt.model.stacked_parameters()
    return {name: flat[:, off: off + size].reshape(named[name].shape).numpy()
            for name, (off, size) in tt.model.param_slices.items()}


# Both routes for top-k, the PGA reset, the schedule and the global budget
# with error feedback; the superstep alone for the rest (it equals the
# per-epoch loop bit for bit, test_choco_superstep_equals_per_epoch_loop).
BOTH = ("topk", "pga_reset", "schedule", "global_ef")
JAX_CASES = [(n, r) for n in sorted(JAX_CONFIGS)
             for r in (("train_epoch", "train_epochs") if n in BOTH else ("train_epochs",))]
# int8's round(v / s) is discontinuous: the float32 differences of the
# training steps (1e-7) can round one entry of a correction the other way,
# which moves it by a quantum s = max|delta| / 127 (~2e-3 here), and the
# parameters by gamma W s (~1e-4) from then on.
PARAM_ATOL = {"int8": 2e-4}


@pytest.mark.parametrize("name,route", JAX_CASES)
def test_choco_trainer_matches_jax(name, route):
    atol = PARAM_ATOL.get(name, 2e-5)
    jt, tt = _jax_pair(**JAX_CONFIGS[name])
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
        assert a["deviation"] == pytest.approx(b["deviation"], abs=1e-6 if atol == 2e-5 else atol)
    np.testing.assert_array_equal(pt[-1]["test_acc"], np.asarray(pj[-1]["test_acc"]))
    want = flax_to_torch(jax.tree.map(np.asarray, jt.state[0]), n_agents=len(NODES))
    for pname, p in tt.model.stacked_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(), want[pname], atol=atol, err_msg=pname)
    # The estimates: the reference holds None until its next CHOCO epoch
    # after a reset; the port then holds the reset state, zeros.
    hats = _port_tree(tt, tt._choco_xhat)
    if jt._choco_xhat is None:
        assert not tt._choco_present and not tt._choco_xhat.any()
    else:
        assert tt._choco_present
        want = flax_to_torch(jax.tree.map(np.asarray, jt._choco_xhat), n_agents=len(NODES))
        for pname in want:
            np.testing.assert_allclose(hats[pname], want[pname], atol=atol, err_msg=pname)
    if tt._choco_ef is not None and jt._choco_ef is not None:
        want = flax_to_torch(jax.tree.map(np.asarray, jt._choco_ef), n_agents=len(NODES))
        got = _port_tree(tt, tt._choco_ef)
        for pname in want:
            np.testing.assert_allclose(got[pname], want[pname], atol=atol, err_msg=pname)


def test_choco_lowers_the_deviation_like_dense_gossip():
    """CHOCO mixes: its post-mix deviation sits between no gossip and
    dense gossip of the same rounds, and the estimates are live."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the isolated nodes' identity matrix
        alone = _port(weights=np.eye(4), mix_times=4)
        dense = _port(mix_times=4)
        choco = _port(mix_times=4, compression="topk:0.3", compression_gamma=0.3)
        dev = {k: t.train_epochs(K)[-1]["deviation"]
               for k, t in (("alone", alone), ("dense", dense), ("choco", choco))}
    assert dev["dense"] < dev["choco"] < dev["alone"]
    assert choco._choco_present and choco._choco_xhat.abs().sum() > 0


@pytest.mark.parametrize(
    "over,match",
    [
        (dict(compression=""), "empty compression spec"),
        (dict(compression="  "), "empty compression spec"),
        (dict(compression="sign", chebyshev=True), "mutually exclusive"),
        (dict(compression="sign", mix_eps=1e-4), "mutually exclusive"),
        (dict(compression="sign", topology_schedule=lambda e: RING), "mutually exclusive"),
        (dict(compression="nonsense:9"), "unknown compressor"),
        (dict(compression="topk:2"), "fraction must be in"),
        (dict(compression_error_feedback=True), "needs a compression"),
        (dict(compression="topk:0.1", compression_budget="per-tensor"), "unknown compression budget"),
        (dict(compression="topk:0.1", compression_budget="global", fused_consensus=False),
         "requires fused=True"),
        (dict(compression="topk:0.1", compression_error_feedback=True, fused_consensus=False),
         "requires fused=True"),
    ],
)
def test_choco_constructor_rejections_match_jax(over, match):
    with pytest.raises(ValueError, match=match):
        JaxTrainer(**_kw(**over))
    with pytest.raises(ValueError, match=match):
        GossipTrainer(device="cpu", **_kw(**over))


@pytest.mark.parametrize("spec", ["none", "identity", "None:0", " NONE "])
def test_compression_none_means_dense_gossip(spec):
    t = GossipTrainer(device="cpu", chebyshev=True, **_kw(compression=spec))
    assert t._choco is None


