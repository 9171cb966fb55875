"""Checkpoint/resume of the port's trainer, and the schedule repairs of
the epoch superstep, on the CPU (the MLP of ``test_torch_trainer_choco.py``;
one WRN-10-1 configuration with dropout and augmentation).

* A run saved after 2 epochs and resumed, in a fresh trainer or in one
  that trained (and on the card captured graphs) first, equals the
  uninterrupted run bit for bit: parameters, statistics, optimizer state,
  every generator, the counters, the CHOCO estimates and bank, payloads.
* Both cross-compatibility directions warn with the reference's texts; a
  failed save keeps the previous checkpoint.
* Every epoch's schedule is called and validated before a superstep
  trains, and Gossip-PGA epochs call ``mix_times_schedule`` as the
  reference's do (the call lists are compared).
"""

import numpy as np
import pytest
import torch

from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training import checkpoint as ckpt
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)
NODES = list(range(4))


def _kw(**over):
    rng = np.random.default_rng(0)
    train = {a: (rng.normal(size=(48, 8)).astype(np.float32),
                 rng.integers(0, 3, size=(48,)).astype(np.int32)) for a in NODES}
    test = (rng.normal(size=(20, 8)).astype(np.float32),
            rng.integers(0, 3, size=(20,)).astype(np.int32))
    kw = dict(node_names=NODES, model="mlp", model_kwargs={"hidden_dim": 8, "output_dim": 3},
              weights=Topology.ring(4).metropolis_weights(), train_data=train, test_data=test,
              batch_size=8,
              epoch_len=2, stat_step=2, dropout=False, learning_rate=0.05, optimizer="sgd",
              optimizer_kwargs={"momentum": 0.9}, seed=7)
    kw.update(over)
    return kw


def _port(**over):
    t = GossipTrainer(device="cpu", **_kw(**over))
    t.initialize_nodes()
    return t


def _state(t):
    """Every tensor, generator state and counter a run leaves behind."""
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


# -- checkpoints --------------------------------------------------------- #
CKPT_CONFIGS = {
    "dense": dict(mix_times=2),
    "topk": dict(compression="topk:0.3", mix_times=2),
    "randk_global_ef": dict(compression="randk:0.3", compression_budget="global",
                            compression_error_feedback=True, compression_gamma=0.1),
    "adam_schedule_pga": dict(compression="randk:0.3", global_avg_every=2, optimizer="adam",
                              optimizer_kwargs={}, learning_rate=lambda c: 1e-2 / (1 + c)),
    "dropout_vision": dict(compression="topk:0.3", model="wide-resnet",
                           model_kwargs=dict(depth=10, widen_factor=1, dropout_rate=0.3),
                           dropout=True, augment=True),
}


def _vision_data(over):
    if over.get("model") != "wide-resnet":
        return over
    rng = np.random.default_rng(1)
    train = {a: (rng.normal(size=(16, 32, 32, 3)).astype(np.float32),
                 rng.integers(0, 10, size=(16,)).astype(np.int32)) for a in NODES}
    test = (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, size=(8,)).astype(np.int32))
    return dict(over, train_data=train, test_data=test, batch_size=8, epoch_len=1)


@pytest.mark.parametrize("resume", ["fresh", "trained"])
@pytest.mark.parametrize("name", sorted(CKPT_CONFIGS))
def test_checkpoint_resume_is_bit_identical(name, resume, tmp_path):
    """Train 2 epochs, save, train 2 more; a second trainer (fresh, or one
    that trained and captured elsewhere first) restores and trains the
    same 2: the same state and payloads, bit for bit."""
    cfg = _vision_data(CKPT_CONFIGS[name])
    a = _port(**cfg)
    a.train_epochs(2)
    path = str(tmp_path / "ckpt.pt")
    a.save_checkpoint(path)
    want = [a.train_epoch(), a.train_epoch()]
    b = _port(**cfg)
    if resume == "trained":
        b.train_epochs(3)
    b.restore_checkpoint(path)
    assert b._epochs_done == 2
    got = b.train_epochs(2)
    _assert_payloads_equal(want, got)
    _assert_states_equal(_state(a), _state(b))


def test_checkpoint_holds_the_choco_subtree(tmp_path):
    t = _port(compression="topk:0.3", compression_error_feedback=True,
              compression_budget="global", compression_gamma=0.1)
    path = str(tmp_path / "c.pt")
    t.save_checkpoint(path)
    tree = ckpt.restore_checkpoint(path)
    assert set(tree) == {"params", "batch_stats", "opt_state", "generators", "epochs_done",
                         "global_step", "opt_steps", "choco"}
    assert tree["choco"]["present"] == 0 and not tree["choco"]["xhat"].any()
    assert set(tree["choco"]) == {"present", "xhat", "generator", "ef"}
    t.train_epoch()
    t.save_checkpoint(path)
    tree = ckpt.restore_checkpoint(path)
    assert tree["choco"]["present"] == 1
    assert torch.equal(tree["choco"]["xhat"], t._choco_xhat)
    assert torch.equal(tree["choco"]["ef"], t._choco_ef)
    assert tree["epochs_done"] == 1 and tree["opt_steps"] == 2


def test_compressed_trainer_restores_dense_checkpoint(tmp_path):
    """A checkpoint without CHOCO state restores into a compressed
    trainer: the training state loads, the estimates reset, with the
    reference's warning."""
    dense = _port(mix_times=2)
    dense.train_epoch()
    path = str(tmp_path / "dense.pt")
    dense.save_checkpoint(path)
    comp = _port(compression="topk:0.5")
    comp.train_epochs(2)
    with pytest.warns(UserWarning, match="no CHOCO state"):
        comp.restore_checkpoint(path)
    assert comp._epochs_done == 1 and not comp._choco_present
    assert not comp._choco_xhat.any()
    assert torch.equal(comp.model.flat_params, dense.model.flat_params)
    fresh = torch.Generator().manual_seed(7 + 2)
    assert torch.equal(comp._choco_gen.get_state(), fresh.get_state())
    comp.train_epoch()


def test_dense_trainer_restores_compressed_checkpoint(tmp_path):
    comp = _port(compression="topk:0.5")
    comp.train_epoch()
    path = str(tmp_path / "comp.pt")
    comp.save_checkpoint(path)
    dense = _port()
    with pytest.warns(UserWarning, match="estimates are ignored"):
        dense.restore_checkpoint(path)
    assert dense._epochs_done == 1
    assert torch.equal(dense.model.flat_params, comp.model.flat_params)
    dense.train_epoch()


def test_failed_save_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    t = _port(compression="topk:0.3")
    path = str(tmp_path / "c.pt")
    t.save_checkpoint(path)
    before = open(path, "rb").read()
    t.train_epoch()
    real = torch.save

    def failing(obj, f, *args, **kwargs):
        real(obj, f, *args, **kwargs)  # a complete temp file, then the failure
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError, match="disk full"):
        t.save_checkpoint(path)
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.pt"]
    assert ckpt.restore_checkpoint(path)["epochs_done"] == 0


def test_restore_rejects_another_model(tmp_path):
    t = _port()
    path = str(tmp_path / "c.pt")
    t.save_checkpoint(path)
    other = _port(model_kwargs={"hidden_dim": 5, "output_dim": 3})
    with pytest.raises(ValueError, match="structure differs at /params"):
        other.restore_checkpoint(path)


# -- schedule repairs ------------------------------------------------------ #
def _raises_at(epoch):
    def sched(e):
        if e == epoch:
            raise RuntimeError(f"schedule failed at epoch {e}")
        return 1 + e % 2
    return sched


@pytest.mark.parametrize(
    "over",
    [dict(adaptive_comm={"target": 0.05}), dict(mix_eps=1e-3),
     dict(compression="topk:0.3", adaptive_comm={"target": 0.05}),
     dict(compression="randk:0.3"), dict()],
    ids=["adaptive", "eps", "choco_adaptive", "choco", "plain"],
)
def test_superstep_schedule_failure_leaves_the_state(over):
    """A schedule that raises at the last epoch of train_epochs(3) raises
    before any epoch trains: every state tensor, generator and counter is
    as it was (the eps and adaptive supersteps used to train first)."""
    t = _port(mix_times_schedule=_raises_at(3), **over)
    t.train_epoch()  # epochs 1, 2, 3 next
    before = _state(t)
    with pytest.raises(RuntimeError, match="failed at epoch 3"):
        t.train_epochs(3)
    _assert_states_equal(before, _state(t))


@pytest.mark.parametrize("route", ["train_epoch", "train_epochs"])
@pytest.mark.parametrize("compression", [None, "topk:0.3"])
def test_pga_epochs_call_and_validate_the_schedule(route, compression):
    """Every consensus epoch calls mix_times_schedule once, a Gossip-PGA
    epoch too, in the reference's order; 0 on a PGA epoch raises."""
    def recorder(calls, zero_at=None):
        def sched(e):
            calls.append(e)
            return 0 if e == zero_at else 1 + e % 2
        return sched

    seen = {}
    for side in ("jax", "port"):
        calls = []
        kw = _kw(global_avg_every=2, epoch_cons_num=2, mix_times_schedule=recorder(calls),
                 compression=compression)
        t = JaxTrainer(**kw) if side == "jax" else GossipTrainer(device="cpu", **kw)
        t.initialize_nodes()
        if route == "train_epoch":
            for _ in range(5):
                t.train_epoch()
        else:
            t.train_epochs(2)
            t.train_epochs(3)
        seen[side] = calls
    assert seen["port"] == seen["jax"] == [1, 2, 3, 4]
    # Epoch 2 is the first PGA epoch (consensus epoch 1 of every 2).
    t = _port(global_avg_every=2, epoch_cons_num=2, mix_times_schedule=recorder([], zero_at=2),
              compression=compression)
    with pytest.raises(ValueError, match=r"mix_times_schedule\(2\) returned 0"):
        if route == "train_epoch":
            for _ in range(3):
                t.train_epoch()
        else:
            t.train_epochs(3)
