"""Serializable experiment configuration (port of
``distributed_learning_tpu/training/config.py``).

Everything that defines a gossip-SGD experiment — topology, mixing
schedule, model, optimizer, data split, stopping rules — in one
JSON-round-trippable record with the reference's fields (a config file
written by either package loads in the other), plus ``build()`` to
construct the port's trainer on a device, and the per-dataset defaults
``CIFAR_10_Baseline.ipynb``'s training script used.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ExperimentConfig", "DATASET_DEFAULTS", "wrn_lr_schedule"]


# Per-dataset training defaults (parity: the submodule's config.py table —
# batch size, epochs, lr, and the standard WRN step schedule).
DATASET_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "cifar10": {"batch_size": 128, "num_epochs": 100, "lr": 0.1, "num_classes": 10},
    "cifar100": {"batch_size": 128, "num_epochs": 100, "lr": 0.1, "num_classes": 100},
    "titanic": {"batch_size": 64, "num_epochs": 50, "lr": 0.1, "num_classes": 2},
}


def wrn_lr_schedule(base_lr: float, num_epochs: int, epoch_len: int) -> Callable[[int], float]:
    """The WRN paper's step schedule: x0.2 at 30%/60%/80% of training
    (the schedule the reference baseline runs used for their recorded
    93.77%/75.71% accuracies), as a callable of the update count.

    It equals ``optax.piecewise_constant_schedule`` at every count: the
    rate is float32, and each boundary ``<= count`` multiplies it by its
    scale in float32, in ascending order; colliding boundaries (short
    runs) compound their scales (in float64, then float32) instead of
    overwriting; a run too short for any boundary keeps ``base_lr`` as
    given, optax's constant schedule."""
    boundaries: Dict[int, float] = {}
    for f in (0.3, 0.6, 0.8):
        step = int(num_epochs * f) * epoch_len
        if step <= 0:
            continue  # runs too short to reach this decay point
        boundaries[step] = boundaries.get(step, 1.0) * 0.2
    ordered = sorted(boundaries.items())
    if not ordered:  # optax's constant schedule: the rate as given
        return lambda count: float(base_lr)
    base = np.float32(base_lr)

    def schedule(count: int) -> float:
        v = base
        for threshold, scale in ordered:
            if count >= threshold:
                v = np.float32(np.float32(scale) * v)
        return float(v)

    return schedule


@dataclasses.dataclass
class ExperimentConfig:
    """One reproducible gossip-SGD experiment."""

    # nodes & topology
    node_names: List[Any] = dataclasses.field(default_factory=lambda: [0, 1, 2, 3])
    topology: str = "ring"          # ring|chain|complete|star|grid2d|torus2d|
                                    # hypercube|watts_strogatz|random_regular|
                                    # erdos_renyi
    topology_args: List[Any] = dataclasses.field(default_factory=list)
    weight_mode: str = "metropolis"  # metropolis | sdp
    # model
    model: str = "lenet"
    model_args: List[Any] = dataclasses.field(default_factory=lambda: [10])
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # optimizer / loss
    optimizer: str = "sgd"
    optimizer_kwargs: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"momentum": 0.9, "weight_decay": 5e-4}
    )
    learning_rate: float = 0.1
    lr_schedule: Optional[str] = None  # None | "wrn_step"
    error: str = "cross_entropy"
    # data
    dataset: str = "cifar10"
    n_train: Optional[int] = None
    data_seed: int = 0
    # schedule
    epoch: int = 10
    epoch_len: Optional[int] = None
    epoch_cons_num: int = 1
    batch_size: int = 128
    stat_step: int = 100
    mix_times: int = 1
    mix_eps: Optional[float] = None
    chebyshev: bool = False
    time_varying_p: Optional[float] = None  # erdos_renyi edge prob per epoch
    global_avg_every: Optional[int] = None  # Gossip-PGA period (2105.09080)
    superstep: int = 1  # epochs fused into one compiled dispatch
                        # (train_epochs; EVERY config compiles in —
                        # schedules ride as traced data, CHOCO/async/
                        # robust state threads through the scan carry)
    compression: Optional[str] = None  # CHOCO spec: topk:F | atopk:F | randk:F | sign | int8
    compression_gamma: float = 0.2
    compression_budget: str = "per-leaf"  # fused k budget: per-leaf | global
    compression_error_feedback: bool = False  # EF bank on the correction
                                              # (fused global budget rescue)
    adaptive_comm: Optional[Dict[str, Any]] = None  # residual-adaptive gossip
                                                    # budget: {"target": R,
                                                    # "gain", "min_times",
                                                    # "max_times"}
    # misc
    seed: int = 0
    dropout: bool = True
    augment: bool = False  # jitted RandomCrop+Flip inside the train step
    remat: bool = False    # recompute activations in backward (HBM headroom)
    donate_state: bool = True  # donate epoch state buffers (False keeps a
                               # saved `trainer.state` alive across epochs)
    checkpoint_dir: Optional[str] = None

    # ------------------------------------------------------------------ #
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_json(cls, text: str) -> "ExperimentConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config fields: {sorted(unknown)}")
        return cls(**data)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    # ------------------------------------------------------------------ #
    def build_topology(self):
        from distributed_learning_tpu_torch.parallel.topology import Topology

        n = len(self.node_names)
        factory = getattr(Topology, self.topology, None)
        if factory is None:
            raise ValueError(f"unknown topology {self.topology!r}")
        args = list(self.topology_args)
        if not args:
            # Defaults must produce EXACTLY n agents (a mismatched agent
            # count fails later, deep in mixing-matrix resolution).
            if self.topology == "torus2d":
                rows = next(
                    (r for r in range(int(n**0.5), 1, -1) if n % r == 0), 0
                )
                if rows < 2 or n // rows < 2:
                    raise ValueError(
                        f"torus2d needs a rows*cols factorization of "
                        f"{n} with both sides >= 2; pass topology_args"
                    )
                args = [rows, n // rows]
            elif self.topology == "grid2d":
                rows = next(
                    (r for r in range(int(n**0.5), 0, -1) if n % r == 0), 1
                )
                args = [rows, n // rows]
            elif self.topology == "hypercube":
                dim = (n - 1).bit_length()
                if n != 1 << dim:
                    raise ValueError(
                        f"hypercube needs a power-of-two node count, got {n}"
                    )
                args = [dim]
            else:
                args = {
                    "ring": [n], "chain": [n], "complete": [n], "star": [n],
                    "watts_strogatz": [n, 2, 0.3],
                    "random_regular": [2, n],
                    "erdos_renyi": [n, 0.5],
                }[self.topology]
        topo = factory(*args)
        if topo.n_agents != n:
            raise ValueError(
                f"topology {self.topology}{tuple(args)} has "
                f"{topo.n_agents} agents but node_names has {n}"
            )
        return topo

    def build_data(self) -> Tuple[Mapping[Any, Any], Tuple[Any, Any]]:
        """``(shards, test)`` as numpy arrays: normalized CIFAR (the real
        files when present, else the synthetic stand-in) dealt by
        ``shard_dataset``, or Titanic split across the nodes."""
        if self.dataset in ("cifar10", "cifar100"):
            from distributed_learning_tpu_torch.data import (
                load_cifar, normalize, shard_dataset,
            )

            (X, y), (Xt, yt) = load_cifar(self.dataset)
            if self.n_train:
                X, y = X[: self.n_train], y[: self.n_train]
            Xn = normalize(X, dataset=self.dataset).numpy()
            Xtn = normalize(Xt, dataset=self.dataset).numpy()
            shards = shard_dataset(
                Xn, y, list(self.node_names),
                batch_size=self.batch_size, seed=self.data_seed,
            )
            return shards, (Xtn, yt)
        if self.dataset == "titanic":
            from distributed_learning_tpu_torch.data import load_titanic, split_data

            X_tr, y_tr, X_te, y_te = load_titanic()
            shards = split_data(X_tr, y_tr, list(self.node_names))
            return shards, (X_te, y_te)
        raise ValueError(f"unknown dataset {self.dataset!r}")

    def build(self, mesh=None, telemetry=None, *, device=None):
        """Construct the ready-to-run :class:`MasterNode` on ``device``
        (the card unless ``"cpu"`` is asked for).  ``mesh`` and ``remat``
        reach the trainer, which rejects them while they are unported.
        ``donate_state`` has no counterpart: the port's trainer updates
        its buffers in place and never donates them."""
        from distributed_learning_tpu_torch.training.trainer import MasterNode

        weights: Any = None
        if self.time_varying_p is None:
            topo = self.build_topology()
            weights = topo
            if self.weight_mode == "sdp":
                from distributed_learning_tpu_torch.parallel.fast_averaging import (
                    solve_fastest_mixing,
                )

                weights, _ = solve_fastest_mixing(topo)
            elif self.weight_mode != "metropolis":
                raise ValueError(f"unknown weight_mode {self.weight_mode!r}")
        elif self.weight_mode == "sdp":
            raise ValueError(
                "weight_mode='sdp' is meaningless with time_varying_p (the "
                "graph is resampled every epoch); use metropolis"
            )
        aug_pad: Any = 0.0
        if self.augment:
            if self.dataset not in ("cifar10", "cifar100"):
                raise ValueError(
                    f"augment=True is only meaningful for image datasets; "
                    f"got dataset={self.dataset!r}"
                )
            from distributed_learning_tpu_torch.data import normalized_pad_value

            # build_data normalizes before sharding, so crop borders must
            # carry the normalized value of black to match the reference's
            # crop-before-normalize pipeline.
            aug_pad = normalized_pad_value(self.dataset)
        shards, test = self.build_data()
        lr: Any = self.learning_rate
        if self.lr_schedule == "wrn_step":
            sample = shards[list(self.node_names)[0]]
            epoch_len = self.epoch_len or max(
                len(sample[0]) // self.batch_size, 1
            )
            lr = wrn_lr_schedule(self.learning_rate, self.epoch, epoch_len)
        elif self.lr_schedule is not None:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        topology_schedule = None
        if self.time_varying_p is not None:
            from distributed_learning_tpu_torch.parallel.topology import Topology

            n, p = len(self.node_names), self.time_varying_p
            topology_schedule = lambda e: Topology.erdos_renyi(  # noqa: E731
                n, p, seed=self.seed * 10_000 + e
            )
        return MasterNode(
            node_names=list(self.node_names),
            model=self.model,
            model_args=list(self.model_args),
            model_kwargs=dict(self.model_kwargs),
            optimizer=self.optimizer,
            optimizer_kwargs=dict(self.optimizer_kwargs),
            learning_rate=lr,
            error=self.error,
            weights=weights,
            topology_schedule=topology_schedule,
            chebyshev=self.chebyshev,
            train_loaders=shards,
            test_loader=test,
            stat_step=self.stat_step,
            epoch=self.epoch,
            epoch_len=self.epoch_len,
            epoch_cons_num=self.epoch_cons_num,
            batch_size=self.batch_size,
            mix_times=self.mix_times,
            mix_eps=self.mix_eps,
            global_avg_every=self.global_avg_every,
            superstep=self.superstep,
            compression=self.compression,
            compression_gamma=self.compression_gamma,
            compression_budget=self.compression_budget,
            compression_error_feedback=self.compression_error_feedback,
            adaptive_comm=self.adaptive_comm,
            mesh=mesh,
            telemetry=telemetry,
            seed=self.seed,
            dropout=self.dropout,
            augment=self.augment,
            augment_pad_value=aug_pad,
            remat=self.remat,
            device=device,
        )
