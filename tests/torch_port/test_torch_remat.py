"""The trainer's ``remat`` option (activation checkpointing around the
loss, ``torch.utils.checkpoint`` non-reentrant) against the same run
without it, on the CPU: parameters, running statistics, optimizer state
and every trace equal bit for bit (stricter than the reference's
``tests/test_trainer.py:474``, which allows float32 noise).  Each case
has the trap that ``torch.utils.checkpoint`` alone falls into, run as a
control that must differ:

* the LM with dropout on (rope + GQA + MoE, 4 agents): the recompute
  must replay the forward's masks; a plain checkpoint draws new ones from
  the explicit per-agent generators;
* WRN-10-1 with BatchNorm and dropout: the recompute must not update the
  running statistics a second time;
* obs on (a ``MetricsRegistry``, the cost profile and the chunk timer):
  the trainer's and the default registry's counters equal those of the
  run without remat;

and the CLI's ``--remat`` trains, to the losses of the run without it."""

import contextlib

import numpy as np
import pytest
import torch

from distributed_learning_tpu_torch import cli as tcli
from distributed_learning_tpu_torch.obs import MetricsRegistry, use_registry
from distributed_learning_tpu_torch.parallel import Topology
from distributed_learning_tpu_torch.training import trainer as trainer_mod
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

NODES = list(range(4))
V, T = 32, 16
LM = dict(vocab_size=V, num_layers=2, num_heads=4, head_dim=8, max_len=T, pos_emb="rope",
          num_kv_heads=2, mlp="moe", num_experts=4, moe_top_k=2, dropout_rate=0.2)
WRN = dict(depth=10, widen_factor=1, dropout_rate=0.3)


def _tokens(seed):
    rng = np.random.default_rng(seed)
    return {a: (rng.integers(0, V, (8, T)).astype(np.int32),
                rng.integers(0, V, (8, T)).astype(np.int32)) for a in NODES}


def _images(seed):
    rng = np.random.default_rng(seed)
    return {a: (rng.normal(size=(8, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, 8).astype(np.int32)) for a in NODES}


def _trainer(model, model_kwargs, data, **over):
    kw = dict(node_names=NODES, model=model, model_kwargs=model_kwargs, optimizer="adam",
              optimizer_kwargs={"lr": 1e-3}, weights=Topology.ring(4), train_data=data,
              batch_size=2, epoch_len=2, device="cpu", seed=1)
    kw.update(over)
    t = GossipTrainer(**kw)
    t.initialize_nodes()
    return t


def _record(t, payloads):
    rec = {"params": t.model.flat_params.clone(), "stats": t.model.flat_stats.clone()}
    for st in t._opt.state.values():
        for key, v in st.items():
            if isinstance(v, torch.Tensor):
                rec[f"opt.{key}"] = v.clone()
    for key in ("train_loss", "train_acc", "grad_norm"):
        rec[key] = torch.tensor(np.stack([p[key] for p in payloads]))
    rec["generators"] = torch.cat([g.get_state() for g in t._train_generators])
    return rec


def _run(model, model_kwargs, data, epochs=2, **over):
    t = _trainer(model, model_kwargs, data, **over)
    payloads = [t.train_epoch() for _ in range(epochs)]
    return t, _record(t, payloads)


def _differs(a, b):
    return sorted(k for k in b if not torch.equal(a[k], b[k]))


@contextlib.contextmanager
def _plain_checkpoint(monkeypatch):
    """The control: ``torch.utils.checkpoint``'s default contexts."""
    with monkeypatch.context() as m:
        m.setattr(trainer_mod, "_remat_contexts",
                  lambda: (contextlib.nullcontext(), contextlib.nullcontext()))
        yield


def test_lm_with_dropout_remat_is_bitwise(monkeypatch):
    _, off = _run("transformer", LM, _tokens(0))
    t, on = _run("transformer", LM, _tokens(0), remat=True)
    assert t.remat and _differs(on, off) == []
    with _plain_checkpoint(monkeypatch):
        _, ctl = _run("transformer", LM, _tokens(0), remat=True)
    assert "params" in _differs(ctl, off)


def test_wrn_with_batch_norm_and_dropout_remat_is_bitwise(monkeypatch):
    _, off = _run("wide-resnet", WRN, _images(1), epochs=1)
    _, on = _run("wide-resnet", WRN, _images(1), epochs=1, remat=True)
    assert _differs(on, off) == []
    assert not torch.equal(off["stats"][0], off["stats"][1])  # per-agent statistics moved
    with _plain_checkpoint(monkeypatch):
        _, ctl = _run("wide-resnet", dict(WRN, dropout_rate=0.0), _images(1), epochs=1,
                      remat=True)
    _, ref = _run("wide-resnet", dict(WRN, dropout_rate=0.0), _images(1), epochs=1)
    assert "stats" in _differs(ctl, ref)  # updated twice per step


def test_obs_counters_with_remat_equal_those_without():
    """One eager epoch and a superstep of 2 with obs on, with and without
    remat."""
    runs = {}
    for remat in (False, True):
        default = MetricsRegistry()
        with use_registry(default):
            t = _trainer("transformer", LM, _tokens(2), obs=MetricsRegistry(),
                         profile_costs=True, timer_every_n=1, remat=remat)
            payloads = [t.train_epoch()] + t.train_epochs(2)
        runs[remat] = (_record(t, payloads), dict(t._obs_registry.counters),
                       dict(default.counters))
    (rec_off, trainer_off, default_off), (rec_on, trainer_on, default_on) = runs[False], runs[True]
    assert _differs(rec_on, rec_off) == []
    assert trainer_on == trainer_off and trainer_off.get("trainer.dispatches")
    assert default_on == default_off and default_off


def test_cli_remat_trains_to_the_same_losses(tmp_path, capsys):
    argv = ["--net_type", "lenet", "--nodes", "4", "--epochs", "2", "--batch-size", "16",
            "--n-train", "128", "--device", "cpu"]
    outs = []
    for extra in ([], ["--remat"]):
        assert tcli.main(argv + ["--checkpoint-dir", str(tmp_path / f"c{len(extra)}")] + extra) == 0
        outs.append([line for line in capsys.readouterr().out.splitlines() if "loss" in line])
    assert outs[0] and outs[0] == outs[1]
