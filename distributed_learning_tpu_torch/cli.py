"""Command-line trainer of the port (``distributed_learning_tpu/cli.py``'s
flags, plus ``--device``).

Flag-for-flag parity with the training script the reference baselines ran
(the wide-resnet submodule's ``main.py``, invoked by
``CIFAR_10_Baseline.ipynb`` cell 9 as ``python main.py --lr 0.1 --net_type
wide-resnet --depth 28 --widen_factor 10 --dropout 0.3 --dataset
cifar10``), extended with the gossip options that script never had
(``--nodes``, ``--topology``, ``--epoch-cons-num``, ...) and config-file
reproducibility (``--config``/``--dump-config``):

    python -m distributed_learning_tpu_torch --net_type wide-resnet --depth 28 \\
        --widen_factor 10 --dropout 0.3 --dataset cifar10 --nodes 4

It trains on the card; ``--device cpu`` runs the plain PyTorch paths on
the host instead (the CLI never picks the CPU on its own).  A checkpoint
lives in the ``--checkpoint-dir`` directory (``checkpoint.pt``), its
experiment config beside it (``<dir>.config.json``).

Subcommands (dispatched before the trainer flag surface):

    python -m distributed_learning_tpu_torch.cli obs-report <run.jsonl>
    python -m distributed_learning_tpu_torch.cli obs-report --merge <a.jsonl> <b.jsonl>
    python -m distributed_learning_tpu_torch.cli obs-report --bench <bench record files>
    python -m distributed_learning_tpu_torch.cli obs-report --ledger <perf ledger>
    python -m distributed_learning_tpu_torch.cli obs-monitor <aggregate.jsonl>

summarize JSONL observability event logs — single-process, merged
run-wide (per-agent labels + straggler profile), a benchmark trajectory,
or the perf ledger (cost profiles + measured MFU per run,
regression-flagged) — and tail the run-wide aggregate live, all without
touching a device.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

import numpy as np

from distributed_learning_tpu_torch.training.config import DATASET_DEFAULTS, ExperimentConfig

__all__ = ["main", "build_parser", "config_from_args", "CHECKPOINT_FILE"]

#: The checkpoint file inside ``--checkpoint-dir``.
CHECKPOINT_FILE = "checkpoint.pt"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="distributed_learning_tpu_torch",
        description="gossip-SGD training (reference main.py surface + gossip)",
    )
    # Every overridable flag defaults to None: a value appears in the
    # resolved config ONLY when given on the command line, so a --config
    # file is never silently clobbered by parser defaults.
    # -- reference main.py flags --
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--net_type", default=None,
                   choices=["lenet", "vggnet", "resnet", "wide-resnet", "ann"])
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--widen_factor", type=int, default=None)
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--dataset", default=None,
                   choices=sorted(DATASET_DEFAULTS))
    p.add_argument("--resume", "-r", action="store_true",
                   help="resume from the checkpoint dir")
    p.add_argument("--testOnly", "-t", action="store_true",
                   help="evaluate the checkpoint, no training")
    # -- gossip extensions --
    p.add_argument("--nodes", type=int, default=None)
    p.add_argument("--topology", default=None)
    p.add_argument("--weight-mode", default=None,
                   choices=["metropolis", "sdp"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epoch-cons-num", type=int, default=None)
    p.add_argument("--mix-times", type=int, default=None)
    p.add_argument("--mix-eps", type=float, default=None)
    p.add_argument("--chebyshev", action="store_true")
    p.add_argument("--time-varying-p", type=float, default=None)
    p.add_argument("--superstep", type=int, default=None,
                   help="epochs fused into one compiled dispatch "
                        "(train_epochs; every config compiles in — "
                        "schedules ride as traced data, CHOCO/async/"
                        "robust state as scan carries; checkpoints land "
                        "on superstep boundaries)")
    p.add_argument("--global-avg-every", type=int, default=None,
                   help="Gossip-PGA: exact all-reduce every H-th epoch")
    p.add_argument("--compression", default=None,
                   help="CHOCO-SGD compressed gossip: topk:F | atopk:F | randk:F | sign | int8 | none (disables, overriding a saved config)")
    p.add_argument("--compression-gamma", type=float, default=None)
    p.add_argument("--compression-budget", default=None,
                   choices=["per-leaf", "global"],
                   help="fused CHOCO k budget: per-leaf keeps each "
                        "tensor's fraction (oracle-identical), global "
                        "spends one budget per fused dtype bucket")
    p.add_argument("--compression-error-feedback", action="store_true",
                   help="bank the mass the compressor drops and re-offer "
                        "it next round (EF-SGD; keeps aggressive global "
                        "budgets convergent)")
    p.add_argument("--adaptive-target", type=float, default=None,
                   help="residual-adaptive communication: scale each "
                        "epoch's gossip round budget by last epoch's "
                        "consensus residual relative to this target "
                        "(1 + gain*(res/target - 1), clipped)")
    p.add_argument("--adaptive-gain", type=float, default=None,
                   help="adaptive_comm gain (default 1.0; 0 = static)")
    p.add_argument("--adaptive-max-times", type=int, default=None,
                   help="adaptive_comm round-budget ceiling")
    p.add_argument("--augment", action="store_true",
                   help="jitted RandomCrop+Flip train augmentation")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize activations in backward (saves HBM)")
    p.add_argument("--no-donate", action="store_true",
                   help="keep epoch state buffers alive instead of donating "
                        "them (needed to hold trainer.state across epochs)")
    p.add_argument("--lr-schedule", default=None, choices=["wrn_step"])
    p.add_argument("--n-train", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--stat-step", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    # -- config file reproducibility --
    p.add_argument("--config", default=None,
                   help="load an ExperimentConfig JSON (CLI flags override)")
    p.add_argument("--dump-config", default=None,
                   help="write the resolved config JSON here and exit")
    # -- the port's own --
    p.add_argument("--device", default=None,
                   help="where to train: the card by default (an error "
                        "without one); 'cpu' runs the plain PyTorch paths")
    return p


def config_from_args(args: argparse.Namespace) -> ExperimentConfig:
    """Resolve precedence: CLI flag > --config file > dataset defaults."""
    from_file = bool(args.config)
    cfg = ExperimentConfig.load(args.config) if from_file else ExperimentConfig()
    if args.dataset is not None:
        cfg.dataset = args.dataset
    elif not from_file:
        cfg.dataset = "cifar10"
    defaults = DATASET_DEFAULTS[cfg.dataset]

    if args.nodes is not None:
        cfg.node_names = list(range(args.nodes))
    if args.topology is not None:
        cfg.topology = args.topology
        cfg.topology_args = []
    if args.weight_mode is not None:
        cfg.weight_mode = args.weight_mode
    if args.net_type is not None or not from_file:
        # Choosing a net type (or starting fresh) rebuilds the model spec
        # so kwargs from another architecture never leak across.
        net = args.net_type or ("lenet" if not from_file else cfg.model)
        cfg.model = net
        cfg.model_args = [defaults["num_classes"]]
        if net == "wide-resnet":
            cfg.model_kwargs = {
                "depth": args.depth if args.depth is not None else 28,
                "widen_factor": (
                    args.widen_factor if args.widen_factor is not None else 10
                ),
                "dropout_rate": args.dropout if args.dropout is not None else 0.3,
            }
        else:
            cfg.model_kwargs = {}
    elif args.net_type is None and cfg.model == "wide-resnet":
        # Tweak a config-file WRN in place.
        if args.depth is not None:
            cfg.model_kwargs["depth"] = args.depth
        if args.widen_factor is not None:
            cfg.model_kwargs["widen_factor"] = args.widen_factor
        if args.dropout is not None:
            cfg.model_kwargs["dropout_rate"] = args.dropout
    if args.dropout is not None:
        cfg.dropout = args.dropout > 0
    if args.lr is not None:
        cfg.learning_rate = args.lr
    elif not from_file:
        cfg.learning_rate = defaults["lr"]
    if args.lr_schedule is not None:
        cfg.lr_schedule = args.lr_schedule
    if args.epochs is not None:
        cfg.epoch = args.epochs
    elif not from_file:
        cfg.epoch = defaults["num_epochs"]
    if args.batch_size is not None:
        cfg.batch_size = args.batch_size
    elif not from_file:
        cfg.batch_size = defaults["batch_size"]
    for field, value in (
        ("epoch_cons_num", args.epoch_cons_num),
        ("mix_times", args.mix_times),
        ("mix_eps", args.mix_eps),
        ("time_varying_p", args.time_varying_p),
        ("global_avg_every", args.global_avg_every),
        ("superstep", args.superstep),
        ("compression", args.compression),
        ("compression_gamma", args.compression_gamma),
        ("compression_budget", args.compression_budget),
        ("n_train", args.n_train),
        ("seed", args.seed),
        ("stat_step", args.stat_step),
        ("checkpoint_dir", args.checkpoint_dir),
    ):
        if value is not None:
            setattr(cfg, field, value)
    if args.chebyshev:
        cfg.chebyshev = True
    if args.compression_error_feedback:
        cfg.compression_error_feedback = True
    if args.adaptive_target is not None:
        adaptive = {"target": args.adaptive_target}
        if args.adaptive_gain is not None:
            adaptive["gain"] = args.adaptive_gain
        if args.adaptive_max_times is not None:
            adaptive["max_times"] = args.adaptive_max_times
        cfg.adaptive_comm = adaptive
    if args.augment:
        cfg.augment = True
    if args.remat:
        cfg.remat = True
    if args.no_donate:
        cfg.donate_state = False
    if cfg.checkpoint_dir is None and not from_file:
        cfg.checkpoint_dir = "checkpoint"
    return cfg


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "obs-report":
        # device-free path: replay + summarize obs JSONL event logs.
        from distributed_learning_tpu_torch.obs.report import obs_report_main

        return obs_report_main(argv[1:])
    if argv and argv[0] == "obs-monitor":
        # device-free path: tail the run-wide aggregate stream live.
        from distributed_learning_tpu_torch.obs.report import obs_monitor_main

        return obs_monitor_main(argv[1:])
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.dump_config:
        cfg.save(args.dump_config)
        print(f"wrote {args.dump_config}")
        return 0

    ckpt = os.path.abspath(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    cfg_path = ckpt + ".config.json" if ckpt else None
    ckpt_file = os.path.join(ckpt, CHECKPOINT_FILE) if ckpt else None
    if (args.resume or args.testOnly) and cfg_path and os.path.exists(cfg_path):
        # A checkpoint is only restorable into the exact experiment that
        # wrote it (model/optimizer state structures must match), so the
        # config saved beside it is authoritative; only the schedule
        # length may be extended on resume.
        saved = ExperimentConfig.load(cfg_path)
        if args.epochs is not None:
            saved.epoch = args.epochs
        cfg = saved
        print(f"loaded experiment config from {cfg_path}")

    master = cfg.build(device=args.device)
    master.initialize_nodes()
    if (args.resume or args.testOnly) and ckpt_file and os.path.exists(ckpt_file):
        master.restore_checkpoint(ckpt_file)
        print(f"restored checkpoint from {ckpt} "
              f"(epoch {master._epochs_done})")

    if args.testOnly:
        accs = master._eval_accuracy()
        for name, acc in zip(master.node_names, accs):
            print(f"node {name}: test acc {acc:.4f}")
        return 0

    if cfg_path:
        cfg.save(cfg_path)
    while master._epochs_done < cfg.epoch:
        # Superstep chunks (k=1 is the per-epoch loop); checkpoints land
        # on chunk boundaries.
        k = min(max(cfg.superstep, 1), cfg.epoch - master._epochs_done)
        for out in master.train_epochs(k):
            accs = (
                "n/a"
                if out["test_acc"] is None
                else " ".join(f"{a:.4f}" for a in np.asarray(out["test_acc"]))
            )
            residual = (
                "   n/a  " if out["deviation"] is None
                else f"{out['deviation']:.2e}"
            )
            print(
                f"| epoch {out['epoch'] + 1:3d}/{cfg.epoch}  "
                f"loss {float(np.mean(out['train_loss'])):.4f}  "
                f"acc {float(np.mean(out['train_acc'])):.4f}  "
                f"test [{accs}]  residual {residual}",
                flush=True,
            )
        if ckpt:
            os.makedirs(ckpt, exist_ok=True)
            master.save_checkpoint(ckpt_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
