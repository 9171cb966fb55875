"""``training/config.py``, ``cli.py`` and ``__main__.py`` of the port against
the JAX package's, on the CPU.

* ``config_from_args`` of both CLIs gives the same JSON for the same
  flags; ``--dump-config`` / ``--config`` round-trip across packages;
* ``wrn_lr_schedule`` equals ``optax.piecewise_constant_schedule`` at
  every count, colliding boundaries included (exactly);
* ``--device cpu`` runs of LeNet on synthetic CIFAR and of a Titanic MLP
  print per-epoch losses within 2e-4 of the JAX CLI's from the same
  init (the printed 4 decimals plus float32 differences; the init is
  the JAX trainer's, carried across by ``convert.py``, since the two
  packages draw different weights from one seed);
* ``--checkpoint-dir`` plus ``--resume`` equals an uninterrupted run,
  bit for bit; ``--testOnly`` evaluates the checkpoint;
* ``obs-report`` prints the JAX CLI's text for the same event log;
* the CLI trains on the card unless ``--device cpu`` is given, and
  ``--remat`` reaches the trainer, which trains with it.
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from distributed_learning_tpu import cli as jcli
from distributed_learning_tpu.training import config as jconfig
from distributed_learning_tpu.training.trainer import GossipTrainer as JaxTrainer
from distributed_learning_tpu_torch import cli as tcli
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.obs import MetricsRegistry
from distributed_learning_tpu_torch.training import config as tconfig
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

FLAG_SETS = [
    [],
    ["--net_type", "wide-resnet", "--depth", "16", "--widen_factor", "4", "--dropout", "0.3",
     "--dataset", "cifar10", "--nodes", "4", "--lr", "0.1"],
    ["--dataset", "cifar100", "--topology", "torus2d", "--nodes", "9", "--weight-mode", "sdp",
     "--epochs", "7", "--batch-size", "64", "--mix-times", "3", "--chebyshev", "--superstep", "2"],
    ["--dataset", "titanic", "--net_type", "ann", "--compression", "topk:0.1",
     "--compression-gamma", "0.3", "--compression-budget", "global",
     "--compression-error-feedback", "--global-avg-every", "3", "--seed", "5"],
    ["--adaptive-target", "0.01", "--adaptive-gain", "0.5", "--adaptive-max-times", "9",
     "--augment", "--remat", "--no-donate", "--lr-schedule", "wrn_step", "--n-train", "512",
     "--stat-step", "7", "--checkpoint-dir", "ck", "--mix-eps", "1e-3", "--time-varying-p", "0.4",
     "--epoch-cons-num", "2"],
]


def _cfg(cli, argv):
    return cli.config_from_args(cli.build_parser().parse_args(argv)).to_json()


@pytest.mark.parametrize("argv", FLAG_SETS, ids=[f"flags{i}" for i in range(len(FLAG_SETS))])
def test_config_from_args_matches_jax_cli(argv):
    assert _cfg(tcli, argv) == _cfg(jcli, argv)
    # --device is the port's own flag and no part of the config.
    assert _cfg(tcli, argv + ["--device", "cpu"]) == _cfg(jcli, argv)


@pytest.mark.parametrize("argv", FLAG_SETS[1:3], ids=["wrn", "cifar100"])
def test_dump_config_round_trips_across_packages(argv, tmp_path, capsys):
    path = str(tmp_path / "cfg.json")
    assert tcli.main(argv + ["--dump-config", path]) == 0
    assert f"wrote {path}" in capsys.readouterr().out
    port = tconfig.ExperimentConfig.load(path)
    assert jconfig.ExperimentConfig.load(path).to_json() == port.to_json()
    # --config, with a flag overriding the file, in both CLIs.
    over = ["--config", path, "--epochs", "3", "--mix-times", "5"]
    assert _cfg(tcli, over) == _cfg(jcli, over)
    with pytest.raises(ValueError, match="unknown config fields"):
        tconfig.ExperimentConfig.from_json(json.dumps({"bogus": 1}))


@pytest.mark.parametrize("base_lr,epochs,epoch_len", [(0.1, 10, 5), (0.05, 3, 4), (0.1, 1, 7),
                                                      (0.2, 2, 3), (0.1, 5, 1), (0.3, 200, 391)])
def test_wrn_lr_schedule_equals_optax_everywhere(base_lr, epochs, epoch_len):
    port = tconfig.wrn_lr_schedule(base_lr, epochs, epoch_len)
    ref = jconfig.wrn_lr_schedule(base_lr, epochs, epoch_len)
    total = epochs * epoch_len
    counts = sorted(set(range(min(total, 40) + 2)) | {
        b + d for f in (0.3, 0.6, 0.8) for b in [int(epochs * f) * epoch_len] for d in (-1, 0, 1)
        if b + d >= 0} | {total, total + 1})
    assert [port(c) for c in counts] == [float(ref(c)) for c in counts]


def _losses(out):
    return [float(m) for m in re.findall(r"^\| epoch .* loss (\S+)", out, flags=re.M)]


@pytest.fixture
def same_init(monkeypatch):
    """The JAX CLI's trainer init, handed to the port CLI's trainer."""
    seen = {}
    j_init, t_init = JaxTrainer.initialize_nodes, GossipTrainer.initialize_nodes

    def j_wrap(self, *a, **k):
        out = j_init(self, *a, **k)
        seen["params"] = jax.tree.map(np.asarray, self.state[0])
        seen["stats"] = jax.tree.map(np.asarray, self.state[1])
        return out

    def t_wrap(self, params=None, batch_stats=None):
        n = len(self.node_names)
        stats = flax_to_torch(seen["stats"], n_agents=n) if seen["stats"] else None
        return t_init(self, params=flax_to_torch(seen["params"], n_agents=n), batch_stats=stats)

    monkeypatch.setattr(JaxTrainer, "initialize_nodes", j_wrap)
    monkeypatch.setattr(GossipTrainer, "initialize_nodes", t_wrap)
    return seen


def _titanic_config(path, ckpt):
    cfg = tconfig.ExperimentConfig(
        dataset="titanic", model="ann", model_args=[1], model_kwargs={"hidden_dim": 16},
        error="binary_logistic", batch_size=32, epoch=3, learning_rate=0.1,
        optimizer_kwargs={"momentum": 0.9}, dropout=False, checkpoint_dir=ckpt)
    cfg.save(path)
    return path


@pytest.mark.parametrize("kind", ["lenet_cifar", "titanic"])
def test_cpu_runs_print_the_jax_clis_losses(kind, same_init, tmp_path, capsys):
    if kind == "lenet_cifar":
        common = ["--net_type", "lenet", "--nodes", "4", "--epochs", "2", "--batch-size", "16",
                  "--n-train", "128", "--dropout", "0", "--lr", "0.05"]
        jargv = common + ["--checkpoint-dir", str(tmp_path / "j")]
        targv = common + ["--checkpoint-dir", str(tmp_path / "t"), "--device", "cpu"]
    else:
        jargv = ["--config", _titanic_config(str(tmp_path / "tj.json"), str(tmp_path / "j"))]
        targv = ["--config", _titanic_config(str(tmp_path / "tt.json"), str(tmp_path / "t")),
                 "--device", "cpu"]
    assert jcli.main(jargv) == 0
    jl = _losses(capsys.readouterr().out)
    assert tcli.main(targv) == 0
    tl = _losses(capsys.readouterr().out)
    assert len(tl) == len(jl) >= 2
    np.testing.assert_allclose(tl, jl, atol=2e-4)


def _tree(path):
    return torch.load(os.path.join(path, tcli.CHECKPOINT_FILE), weights_only=True)


def _assert_trees_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def test_resume_equals_an_uninterrupted_run(tmp_path, capsys):
    common = ["--net_type", "ann", "--nodes", "4", "--batch-size", "16", "--n-train", "128",
              "--superstep", "2", "--device", "cpu", "--seed", "3"]
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert tcli.main(common + ["--epochs", "2", "--checkpoint-dir", a]) == 0
    assert tcli.main(["--resume", "--epochs", "3", "--checkpoint-dir", a, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "restored checkpoint" in out and "epoch 2" in out
    assert tcli.main(common + ["--epochs", "3", "--checkpoint-dir", b]) == 0
    ta, tb = _tree(a), _tree(b)
    assert ta["epochs_done"] == 3
    _assert_trees_equal(ta, tb)
    capsys.readouterr()
    assert tcli.main(["--testOnly", "--checkpoint-dir", a, "--device", "cpu"]) == 0
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("node ")]
    assert len(lines) == 4 and all("test acc" in l for l in lines)


def test_obs_report_of_a_trainer_run_matches_jax_cli(tmp_path, capsys):
    from distributed_learning_tpu_torch.parallel import Topology

    rng = np.random.default_rng(0)
    train = {a: (rng.normal(size=(32, 8)).astype(np.float32),
                 rng.integers(0, 3, 32).astype(np.int32)) for a in range(4)}
    reg = MetricsRegistry(clock=iter(range(10 ** 6)).__next__)
    t = GossipTrainer(node_names=list(range(4)), model="mlp",
                      model_kwargs={"hidden_dim": 8, "output_dim": 3}, weights=Topology.ring(4),
                      train_data=train, batch_size=8, epoch_len=2, dropout=False,
                      device="cpu", obs=reg)
    t.train_epoch()
    t.train_epochs(2)
    path = str(tmp_path / "run.jsonl")
    reg.dump_jsonl(path)
    outs = []
    for main in (jcli.main, tcli.main):
        assert main(["obs-report", path]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "train.loss" in outs[1] and "consensus.residual" in outs[1]


def test_cli_needs_the_card_unless_cpu_is_asked_for(tmp_path):
    argv = ["--net_type", "lenet", "--nodes", "4", "--epochs", "1", "--batch-size", "16",
            "--n-train", "128", "--checkpoint-dir", str(tmp_path / "c")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv)
    assert tcli.main(argv + ["--device", "cpu", "--remat"]) == 0


def test_python_dash_m_entry_point(tmp_path):
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out = subprocess.run(
        [sys.executable, "-m", "distributed_learning_tpu_torch", "--dump-config",
         str(tmp_path / "c.json"), "--nodes", "3"],
        cwd=repo, env=dict(os.environ, PYTHONPATH=repo), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.load(open(tmp_path / "c.json"))["node_names"] == [0, 1, 2]
