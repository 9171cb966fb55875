"""Gossip-SGD trainer (port of ``distributed_learning_tpu/training/trainer.py``).

The reference's ``MasterNode`` surface: train each named node for an
epoch on its own shard, then average parameters over the ``weights``
topology from epoch ``epoch_cons_num`` on; record per-node statistics
every ``stat_step`` batches; evaluate every node on the common test set.

All N node replicas live on a leading *agent* axis of one agent-stacked
model (``models/transformer.py``): one forward/backward serves every
agent, and a gossip round is one ``W @ X`` GEMM on the model's fused
``(N, P)`` float32 parameter buffer.  Only *parameters* mix; optimizer
moments stay per node.  All nodes start from one shared init.

Adam and SGD are elementwise, so ONE torch optimizer over the stacked
``(N, P)`` buffer takes exactly the step that N per-agent optimizers
would (the reference's ``jax.vmap(tx.update)``), and the summed loss's
gradient with respect to agent ``a``'s slice is agent ``a``'s own
gradient, since agents share no parameter.

Ported: fixed ``mix_times`` or ``mix_eps`` gossip, per-node stats, the
per-epoch eval, telemetry, ``node_parameters`` / ``parameter_deviation``.  Options that are not
ported raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models import get_model
from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine
from distributed_learning_tpu_torch.parallel.topology import Topology
from distributed_learning_tpu_torch.utils.telemetry import TelemetryProcessor

__all__ = [
    "MasterNode",
    "ConsensusNode",
    "GossipTrainer",
    "make_optimizer",
    "get_loss",
    "get_metric",
    "resolve_mixing_matrix",
]


# ---------------------------------------------------------------------- #
# Loss / metric / optimizer registries                                   #
# ---------------------------------------------------------------------- #
def get_loss(error: Any) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Resolve the reference's ``error`` argument to a per-agent loss
    ``(logits (N, ...), labels (N, ...)) -> (N,)``.

    ``'cross_entropy'`` (integer labels) and ``'binary_logistic'``
    ({-1,+1} labels) are built in.  A custom callable takes ONE agent's
    ``(logits, y)`` and returns a scalar, as in the reference; it is
    applied to each agent in turn.
    """
    if error is None or error == "cross_entropy":
        def ce(logits, y):
            n, C = logits.shape[0], logits.shape[-1]
            per = F.cross_entropy(logits.reshape(-1, C), y.reshape(-1).long(), reduction="none")
            return per.reshape(n, -1).mean(dim=1)
        return ce
    if error == "binary_logistic":
        def bl(margin, y):
            per = F.softplus(-y * margin.squeeze(-1))
            return per.reshape(per.shape[0], -1).mean(dim=1)
        return bl
    if callable(error):
        return lambda logits, y: torch.stack(
            [error(logits[a], y[a]) for a in range(logits.shape[0])]
        )
    raise ValueError(f"unknown loss {error!r}")


def get_metric(error: Any) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Per-example accuracy ``(out (N, B, ...), y (N, B, ...)) -> (N, B)``
    matching the loss: argmax agreement for cross-entropy-style losses,
    sign agreement for the binary {-1,+1} margin loss; for custom losses
    a single-output model is a margin model.  The reference's per-batch
    metric is the mean of these scores over B."""

    def sign_acc(margin, y):
        hit = (torch.sign(margin.squeeze(-1)) == y).to(torch.float32)
        return hit.reshape(hit.shape[0], hit.shape[1], -1).mean(dim=2)

    def argmax_acc(logits, y):
        hit = (logits.argmax(dim=-1) == y).to(torch.float32)
        return hit.reshape(hit.shape[0], hit.shape[1], -1).mean(dim=2)

    if error == "binary_logistic":
        return sign_acc
    if error is None or error == "cross_entropy":
        return argmax_acc
    return lambda out, y: sign_acc(out, y) if out.shape[-1] == 1 else argmax_acc(out, y)


def make_optimizer(
    optimizer: Any = "sgd",
    optimizer_kwargs: Optional[Mapping[str, Any]] = None,
    learning_rate: float = 0.02,
) -> Callable[[torch.Tensor], torch.optim.Optimizer]:
    """Resolve the reference's ``optimizer`` / ``optimizer_kwargs`` pair to
    a factory ``build(flat_params) -> torch.optim.Optimizer``.

    Names ``'sgd'`` / ``'adam'`` / ``'adamw'`` take torch-style kwargs
    (``momentum``, ``nesterov``, ``weight_decay``) with the reference's
    semantics: for sgd and adam, ``weight_decay`` is L2 added to the
    gradient before the update (``optax.add_decayed_weights`` chained in
    front); for adamw it is decoupled.  Adam's defaults are optax's (eps
    1e-8; ``eps_root`` must be 0, as torch has no such term).  A
    ``torch.optim.Optimizer`` subclass or factory is called as
    ``optimizer([flat_params], lr=..., **kwargs)``.
    """
    kw = dict(optimizer_kwargs or {})
    lr = kw.pop("lr", kw.pop("learning_rate", learning_rate))
    if callable(lr):
        raise NotImplementedError(
            "learning-rate schedules are not ported yet (ROADMAP.md queue 1, item 2)"
        )
    lr = float(lr)
    if isinstance(optimizer, str):
        wd = float(kw.pop("weight_decay", 0.0))
        name = optimizer.lower()
        if name == "sgd":
            momentum = float(kw.pop("momentum", 0.0) or 0.0)
            nesterov = bool(kw.pop("nesterov", False))
            if kw:
                raise ValueError(f"unknown sgd kwargs {sorted(kw)}")
            return lambda p: torch.optim.SGD(
                [p], lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=wd
            )
        if name in ("adam", "adamw"):
            betas = (float(kw.pop("b1", 0.9)), float(kw.pop("b2", 0.999)))
            eps = float(kw.pop("eps", 1e-8))
            if float(kw.pop("eps_root", 0.0)) != 0.0:
                raise NotImplementedError("adam eps_root != 0 has no torch counterpart")
            if kw:
                raise ValueError(f"unknown {name} kwargs {sorted(kw)}")
            cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
            return lambda p: cls([p], lr=lr, betas=betas, eps=eps, weight_decay=wd)
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if callable(optimizer):
        return lambda p: optimizer([p], lr=lr, **kw)
    raise ValueError(f"cannot interpret optimizer {optimizer!r}")


def resolve_mixing_matrix(weights: Any, node_names: Sequence[Hashable]) -> np.ndarray:
    """Resolve MasterNode's ``weights`` argument to an (n, n) mixing matrix
    aligned with ``node_names`` order: a ``{agent: {neighbor: weight}}``
    dict, a :class:`Topology` (-> Metropolis weights), an explicit matrix,
    or ``None`` (isolated nodes)."""
    n = len(node_names)
    if weights is None:
        return np.eye(n)
    if isinstance(weights, Mapping):
        topo, W = Topology.from_neighbor_dict(weights)
        if set(topo.tokens) != set(node_names):
            raise ValueError(
                "weights topology must cover exactly the trainer's "
                f"node_names; topology has {sorted(map(str, topo.tokens))}, "
                f"trainer has {sorted(map(str, node_names))}"
            )
        order = [topo.tokens.index(t) for t in node_names]
        return W[np.ix_(order, order)]
    if isinstance(weights, Topology):
        W = weights.metropolis_weights()
        if set(weights.tokens) == set(node_names):
            order = [weights.tokens.index(t) for t in node_names]
            return W[np.ix_(order, order)]
        if set(weights.tokens) == set(range(n)):
            # Positional indices: index i maps to node_names[i].
            order = [weights.tokens.index(i) for i in range(n)]
            return W[np.ix_(order, order)]
        raise ValueError(
            "weights Topology tokens must either match node_names or "
            f"be 0..n-1 positional indices; topology has "
            f"{sorted(map(str, weights.tokens))}, trainer has "
            f"{sorted(map(str, node_names))}"
        )
    W = np.asarray(weights, dtype=np.float64)
    if W.shape != (n, n):
        raise ValueError(f"mixing matrix shape {W.shape} != ({n}, {n})")
    return W


# Constructor options of the reference that this port does not run yet:
# option -> (values that mean "off", the ROADMAP.md item that ports it).
_UNPORTED = {
    "superstep": ((1,), "queue 1, item 2 (superstep train_epochs)"),
    "mix_times_schedule": ((None,), "queue 1, item 2 (per-epoch schedules)"),
    "adaptive_comm": ((None, False), "queue 1, item 2 (superstep + adaptive_comm)"),
    "compression": ((None, "none", "identity"), "queue 1, item 3 (compression / CHOCO)"),
    "async_gossip": ((None, False), "queue 1, item 4 (async and robust gossip)"),
    "robust_mixing": ((None, False), "queue 1, item 4 (async and robust gossip)"),
    "topology_schedule": ((None,), "queue 1, item 5 (engine routes)"),
    "chebyshev": ((False,), "queue 1, item 5 (engine routes)"),
    "global_avg_every": ((None,), "queue 1, item 5 (engine routes)"),
    "mesh": ((None,), "queue 1, item 6 (sharded engine on torch.distributed)"),
    "obs": ((None, False), "queue 1, item 8 (obs/)"),
    "profile_costs": ((False,), "queue 1, item 8 (obs/)"),
    "timer_every_n": ((0,), "queue 1, item 8 (obs/)"),
    "augment": ((False,), "queue 1, item 1 (WRN/Titanic path, data/)"),
    "remat": ((False,), "queue 1, item 9 (LM extras)"),
}


def _reject_unported(options: Mapping[str, Any]) -> None:
    for name, value in options.items():
        off, item = _UNPORTED[name]
        if not any(value is v or (type(value) is type(v) and value == v) for v in off):
            raise NotImplementedError(
                f"GossipTrainer option {name}={value!r} is not ported yet: "
                f"ROADMAP.md {item}"
            )


# ---------------------------------------------------------------------- #
# Per-node stats                                                         #
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class _EpochStats:
    """Host-side per-node training curves (what show_graphs plots)."""

    steps: List[int] = dataclasses.field(default_factory=list)
    train_loss: List[float] = dataclasses.field(default_factory=list)
    train_acc: List[float] = dataclasses.field(default_factory=list)
    test_acc: List[float] = dataclasses.field(default_factory=list)
    test_epochs: List[int] = dataclasses.field(default_factory=list)


class ConsensusNode:
    """Per-node stats holder (the reference's ``ConsensusNode`` surface
    used by ``node.show_graphs()``)."""

    def __init__(self, name: Hashable):
        self.name = name
        self.stats = _EpochStats()

    def show_graphs(self, show: bool = False):
        """Plot per-node loss/accuracy curves; returns the figure, or None
        with a text summary printed when matplotlib is unavailable."""
        try:
            import matplotlib

            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt
        except ImportError:
            print(self.summary())
            return None
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        axes[0].plot(self.stats.steps, self.stats.train_loss)
        axes[0].set_title(f"{self.name}: train loss")
        axes[0].set_xlabel("batch")
        axes[1].plot(self.stats.steps, self.stats.train_acc, label="train")
        if self.stats.test_acc:
            axes[1].plot(self.stats.test_epochs, self.stats.test_acc, label="test (per epoch)")
        axes[1].set_title(f"{self.name}: accuracy")
        axes[1].legend()
        if show:  # pragma: no cover
            plt.show()
        return fig

    def summary(self) -> str:
        s = self.stats
        last_loss = s.train_loss[-1] if s.train_loss else float("nan")
        last_acc = s.test_acc[-1] if s.test_acc else float("nan")
        return (
            f"node {self.name}: {len(s.steps)} stat points, "
            f"final train loss {last_loss:.4f}, final test acc {last_acc:.4f}"
        )


# ---------------------------------------------------------------------- #
# Trainer                                                                #
# ---------------------------------------------------------------------- #
class GossipTrainer:
    """Stacked-replica gossip-SGD trainer.

    Parameters mirror the MasterNode surface but take in-memory arrays:
    ``train_data[name] = (X, y)`` and ``test_data = (X, y)``.  ``model``
    is a registry name (built with ``n_agents`` = number of nodes) or an
    agent-stacked model whose ``n_agents`` equals the number of nodes.
    ``device`` defaults to the card; pass ``"cpu"`` for the plain path.
    """

    def __init__(
        self,
        *,
        node_names: Sequence[Hashable],
        model: Any,
        model_args: Sequence[Any] = (),
        model_kwargs: Optional[Mapping[str, Any]] = None,
        optimizer: Any = "sgd",
        optimizer_kwargs: Optional[Mapping[str, Any]] = None,
        learning_rate: float = 0.02,
        error: Any = "cross_entropy",
        weights: Any = None,
        train_data: Mapping[Hashable, Tuple[np.ndarray, np.ndarray]],
        test_data: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        stat_step: int = 100,
        epoch: int = 10,
        epoch_len: Optional[int] = None,
        epoch_cons_num: int = 1,
        batch_size: int = 128,
        mix_times: int = 1,
        mix_eps: Optional[float] = None,
        telemetry: Optional[TelemetryProcessor] = None,
        seed: int = 0,
        eval_batch_size: int = 1024,
        device=None,
        superstep: int = 1,
        mix_times_schedule: Optional[Callable[[int], int]] = None,
        adaptive_comm: Any = None,
        compression: Any = None,
        async_gossip: Any = None,
        robust_mixing: Any = None,
        topology_schedule: Optional[Callable[[int], Any]] = None,
        chebyshev: bool = False,
        global_avg_every: Optional[int] = None,
        mesh: Any = None,
        obs: Any = None,
        profile_costs: bool = False,
        timer_every_n: int = 0,
        augment: bool = False,
        remat: bool = False,
    ):
        _reject_unported(dict(
            superstep=superstep, mix_times_schedule=mix_times_schedule,
            adaptive_comm=adaptive_comm,
            compression=compression, async_gossip=async_gossip,
            robust_mixing=robust_mixing, topology_schedule=topology_schedule,
            chebyshev=chebyshev, global_avg_every=global_avg_every, mesh=mesh,
            obs=obs, profile_costs=profile_costs, timer_every_n=timer_every_n,
            augment=augment, remat=remat,
        ))
        self.device = resolve_device(device)
        self.eval_batch_size = int(eval_batch_size)
        self.node_names = list(node_names)
        n = len(self.node_names)
        if n == 0:
            raise ValueError("need at least one node")
        if train_data is None:
            raise ValueError(
                "train_data (MasterNode: train_loaders) is required: a dict "
                "mapping each node name to its (X, y) shard"
            )
        missing = [t for t in self.node_names if t not in train_data]
        if missing:
            raise ValueError(f"train_data missing for nodes: {missing}")

        if isinstance(model, str):
            model = get_model(
                model, *model_args, n_agents=n, device=self.device,
                seed=seed, **dict(model_kwargs or {}),
            )
        if getattr(model, "n_agents", None) != n:
            raise ValueError(
                f"model must be agent-stacked over the {n} nodes "
                f"(n_agents={getattr(model, 'n_agents', None)})"
            )
        if model.flat_params.device != self.device:
            raise ValueError(
                f"model lives on {model.flat_params.device}, trainer on {self.device}"
            )
        self.model = model
        self.loss_fn = get_loss(error)
        self.metric_fn = get_metric(error)
        self._make_opt = make_optimizer(optimizer, optimizer_kwargs, learning_rate)
        self.telemetry = telemetry
        self.stat_step = int(stat_step)
        self.num_epochs = int(epoch)
        self.epoch_cons_num = int(epoch_cons_num)
        self.batch_size = int(batch_size)
        self.mix_times = int(mix_times)
        self.mix_eps = mix_eps
        self.seed = seed

        W = resolve_mixing_matrix(weights, self.node_names)
        if n > 1 and np.allclose(W, np.eye(n)):
            warnings.warn(
                "GossipTrainer: mixing matrix is the identity (weights=None"
                " or an edgeless topology) — nodes will train in isolation"
                " with no gossip. Pass weights=Topology.ring(n) (or any"
                " connected topology/matrix) for consensus training.",
                stacklevel=2,
            )
        self.engine = ConsensusEngine(W, device=self.device)

        self._Xs, self._ys = self._stack_data(train_data, batch_size)
        max_len = self._Xs.shape[1] // batch_size
        self.epoch_len = min(epoch_len or max_len, max_len)
        if self.epoch_len < 1:
            raise ValueError(
                f"shards of {self._Xs.shape[1]} samples cannot fill one "
                f"batch of {batch_size}"
            )
        self.test_data = None
        if test_data is not None:
            self.test_data = (
                torch.as_tensor(np.asarray(test_data[0]), device=self.device),
                torch.as_tensor(np.asarray(test_data[1]), device=self.device),
            )
        self.network: Dict[Hashable, ConsensusNode] = {
            name: ConsensusNode(name) for name in self.node_names
        }
        self._opt: Optional[torch.optim.Optimizer] = None
        self._global_step = 0
        self._epochs_done = 0

    # ------------------------------------------------------------------ #
    def _stack_data(self, train_data, batch_size):
        lens = [len(train_data[t][0]) for t in self.node_names]
        m = min(lens)
        m -= m % batch_size
        if m == 0:
            raise ValueError(
                f"smallest shard ({min(lens)}) is below batch_size {batch_size}"
            )
        if max(lens) > m:
            if max(lens) > min(lens):
                msg = (
                    f"node shards are imbalanced ({min(lens)}..{max(lens)} "
                    f"samples); every shard is truncated to {m} (the "
                    "smallest, batch-aligned) so the stacked epoch has a "
                    "common batch grid"
                )
            else:
                msg = (
                    f"node shards ({min(lens)} samples) are not a multiple "
                    f"of batch_size; each is truncated to {m} so the "
                    "stacked epoch has a whole number of batches"
                )
            warnings.warn(msg, stacklevel=3)
        Xs = np.stack([np.asarray(train_data[t][0][:m]) for t in self.node_names])
        ys = np.stack([np.asarray(train_data[t][1][:m]) for t in self.node_names])
        return (torch.as_tensor(Xs, device=self.device),
                torch.as_tensor(ys, device=self.device))

    @property
    def _buffers(self) -> Dict[str, torch.Tensor]:
        """The parameters as the engine's fused ``{dtype: (N, P)}`` state."""
        return {"float32": self.model.flat_params}

    # ------------------------------------------------------------------ #
    def initialize_nodes(self, params: Optional[Mapping[str, Any]] = None):
        """Shared init (from ``seed``, or ``params`` — ``{name: array}`` as
        ``convert.flax_to_torch`` gives, stacked or per agent) and fresh
        per-node optimizer state (parity: ``master.initialize_nodes()``)."""
        if params is None:
            self.model.reset_parameters(self.seed)
        else:
            self.model.load_stacked(params)
        self.model.flat_grads.zero_()
        flat = self.model.flat_params
        flat.grad = self.model.flat_grads
        self._opt = self._make_opt(flat)
        return self

    def _epoch_perm(self, epoch_idx: int) -> np.ndarray:
        """Host-side (steps, n, B) shuffle indices for one epoch — one
        ``np.random.default_rng(seed*1000 + epoch)`` stream per epoch, the
        reference's streams exactly."""
        n, m = self._Xs.shape[0], self._Xs.shape[1]
        steps = self.epoch_len
        rng = np.random.default_rng(self.seed * 1000 + epoch_idx)
        idx = np.stack(
            [rng.permutation(m)[: steps * self.batch_size] for _ in range(n)]
        ).astype(np.int32)
        return idx.reshape(n, steps, self.batch_size).swapaxes(0, 1)

    def _train_step(self, x, y):
        """One fwd/bwd/update for every agent; returns (N,) loss, acc and
        gradient norm, left on the device."""
        model = self.model
        model.flat_grads.zero_()
        logits = model(x)
        loss = self.loss_fn(logits, y)
        with warnings.catch_warnings():
            # The gradients are strided views into the (N, P) buffer by
            # design; autograd accumulates into them in place.
            warnings.filterwarnings("ignore", message="grad and param do not obey")
            loss.sum().backward()
        gnorm = torch.linalg.vector_norm(model.flat_grads, dim=1)
        self._opt.step()
        acc = self.metric_fn(logits.detach(), y).mean(dim=1)
        return loss.detach(), acc, gnorm

    def _gossip(self) -> int:
        """One epoch's consensus phase, in place on the fused buffer;
        returns the number of rounds run."""
        with torch.no_grad():
            if self.mix_eps is None:
                self.engine.mix_(self._buffers, times=self.mix_times)
                return self.mix_times
            rounds, _ = self.engine.mix_until_(
                self._buffers, eps=self.mix_eps, min_times=self.mix_times
            )
        return rounds

    @torch.no_grad()
    def _eval_accuracy(self) -> np.ndarray:
        """Per-node test accuracy over the test set in batches of
        ``eval_batch_size``: the SUM of per-example scores over the seen
        examples, divided by their count.  The reference pads the ragged
        tail and masks it out so one compiled program serves every batch;
        eagerly the tail simply runs at its own size."""
        X, y = self.test_data
        n = len(self.node_names)
        total = torch.zeros(n, dtype=torch.float64, device=self.device)
        for s in range(0, len(X), self.eval_batch_size):
            xb = X[s: s + self.eval_batch_size]
            yb = y[s: s + self.eval_batch_size]
            xs = xb.unsqueeze(0).expand(n, *xb.shape)
            ys = yb.unsqueeze(0).expand(n, *yb.shape)
            per = self.metric_fn(self.model(xs), ys)  # (n, b)
            total += per.sum(dim=1).to(torch.float64)
        return (total / max(len(X), 1)).cpu().numpy()

    def train_epoch(self) -> Dict[str, Any]:
        """One epoch: local SGD on every node, then (maybe) gossip."""
        if self._opt is None:
            self.initialize_nodes()
        epoch_idx = self._epochs_done
        idx = torch.as_tensor(self._epoch_perm(epoch_idx), device=self.device).long()
        n = len(self.node_names)
        agent = torch.arange(n, device=self.device)[:, None]
        traces = []
        for t in range(idx.shape[0]):
            traces.append(self._train_step(self._Xs[agent, idx[t]], self._ys[agent, idx[t]]))
        mixed, mix_rounds = False, 0
        if epoch_idx + 1 >= self.epoch_cons_num and n > 1:
            mix_rounds = self._gossip()
            mixed = True
        # One host sync for the epoch's (steps, n) traces.
        losses, accs, gnorms = (
            torch.stack(col).cpu().numpy() for col in zip(*traces)
        )

        for s in range(0, losses.shape[0], self.stat_step):
            chunk = slice(s, min(s + self.stat_step, losses.shape[0]))
            for a, name in enumerate(self.node_names):
                node = self.network[name]
                node.stats.steps.append(self._global_step + chunk.stop)
                node.stats.train_loss.append(float(losses[chunk, a].mean()))
                node.stats.train_acc.append(float(accs[chunk, a].mean()))
        self._global_step += losses.shape[0]
        self._epochs_done += 1

        test_accs = None
        if self.test_data is not None:
            test_accs = self._eval_accuracy()
            for a, name in enumerate(self.node_names):
                node = self.network[name]
                node.stats.test_acc.append(float(test_accs[a]))
                node.stats.test_epochs.append(self._global_step)

        payload = {
            "epoch": epoch_idx,
            "mixed": mixed,
            "train_loss": losses.mean(axis=0),
            "train_acc": accs.mean(axis=0),
            "grad_norm": gnorms.mean(axis=0),
            "test_acc": test_accs,
            "mix_rounds": mix_rounds,
            "deviation": self.parameter_deviation(),
        }
        if self.telemetry is not None:
            for a, name in enumerate(self.node_names):
                self.telemetry.process(
                    name,
                    {
                        "epoch": epoch_idx,
                        "train_loss": float(payload["train_loss"][a]),
                        "train_acc": float(payload["train_acc"][a]),
                        "grad_norm": float(payload["grad_norm"][a]),
                        "test_acc": None if test_accs is None else float(test_accs[a]),
                        "mix_rounds": mix_rounds,
                        "deviation": payload["deviation"],
                    },
                )
        return payload

    def start_consensus(self) -> List[Dict[str, Any]]:
        """Run the full training schedule (parity: ``master.start_consensus()``)."""
        results: List[Dict[str, Any]] = []
        while self._epochs_done < self.num_epochs:
            results.append(self.train_epoch())
        return results

    # ------------------------------------------------------------------ #
    def node_parameters(self) -> Dict[Hashable, Dict[str, torch.Tensor]]:
        """``{node: {param name: tensor}}`` — views of each node's slice."""
        stacked = self.model.stacked_parameters()
        return {
            name: {k: v[a] for k, v in stacked.items()}
            for a, name in enumerate(self.node_names)
        }

    def parameter_deviation(self) -> float:
        return float(self.engine.max_deviation(self._buffers))


class MasterNode(GossipTrainer):
    """Constructor parity with the documented reference surface.
    ``train_loaders``/``test_loader`` take ``(X, y)`` arrays and are
    forwarded to :class:`GossipTrainer` as ``train_data``/``test_data``."""

    def __init__(
        self,
        node_names,
        model,
        model_args=(),
        optimizer="sgd",
        optimizer_kwargs=None,
        error="cross_entropy",
        weights=None,
        train_loaders=None,
        test_loader=None,
        stat_step=100,
        epoch=10,
        epoch_len=None,
        epoch_cons_num=1,
        **kwargs,
    ):
        super().__init__(
            node_names=list(node_names),
            model=model,
            model_args=model_args,
            optimizer=optimizer,
            optimizer_kwargs=optimizer_kwargs,
            error=error,
            weights=weights,
            train_data=train_loaders,
            test_data=test_loader,
            stat_step=stat_step,
            epoch=epoch,
            epoch_len=epoch_len,
            epoch_cons_num=epoch_cons_num,
            **kwargs,
        )
