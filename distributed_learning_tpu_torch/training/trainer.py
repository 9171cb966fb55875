"""Gossip-SGD trainer (port of ``distributed_learning_tpu/training/trainer.py``).

The reference's ``MasterNode`` surface: train each named node for an
epoch on its own shard, then average parameters over the ``weights``
topology from epoch ``epoch_cons_num`` on; record per-node statistics
every ``stat_step`` batches; evaluate every node on the common test set.

All N node replicas live on a leading *agent* axis of one agent-stacked
model (``models/_stacked.py``: the transformer, the vision zoo, the
MLP): one forward/backward serves every agent, and a gossip round is one
``W @ X`` GEMM on the model's fused ``(N, P)`` float32 parameter buffer.
Only *parameters* mix; optimizer moments and BatchNorm running
statistics stay per node.  All nodes start from one shared init.

Adam and SGD are elementwise, so ONE torch optimizer over the stacked
``(N, P)`` buffer takes exactly the step that N per-agent optimizers
would (the reference's ``jax.vmap(tx.update)``), and the summed loss's
gradient with respect to agent ``a``'s slice is agent ``a``'s own
gradient, since agents share no parameter.

Gossip per epoch: fixed ``mix_times`` or a ``mix_times_schedule``, eps
stopping (``mix_eps``), Chebyshev acceleration (``chebyshev``),
Gossip-PGA's exact average every ``global_avg_every`` consensus epochs,
a time-varying graph (``topology_schedule``, also with Chebyshev or eps),
the residual-adaptive round budget (``adaptive_comm``), CHOCO
compressed gossip (``compression``, ``parallel/compression.py``), whose
estimates persist across epochs until a Gossip-PGA epoch or a fresh
``initialize_nodes`` resets them, asynchronous stale-weighted gossip
(``async_gossip``: per-agent publish periods, a staleness bound or a
schedule of bounds), whose double-buffer carry persists across epochs
until a fresh ``initialize_nodes``, and Byzantine-robust gossip
(``robust_mixing``: clipped, trimmed-mean or coordinate-median,
``parallel/robust.py``), alone or with ``async_gossip``.  Learning
rates may be optax-style schedules ``count -> lr``.  ``save_checkpoint``
/ ``restore_checkpoint`` write and read everything a resumed run needs.

``train_epochs(k)`` is the reference's epoch superstep: the indices of
all k epochs go to the device at once, the per-step traces and each
epoch's post-mix deviation stay on the device until one flush at the
end, and the test set is evaluated once, at the boundary.  On the card
the k epochs are CUDA-graph replays (``training/graphs.py``) with no host
synchronisation in between; a configuration whose round count depends
on a device value (``mix_eps``, ``adaptive_comm``) runs its gossip
eagerly between the replays.  On the CPU the same ops run eagerly.  The
trajectory equals k calls of ``train_epoch``.

Observability (``obs/``): ``obs`` (a ``MetricsRegistry``, or ``True``
for the process-wide one) records the per-step traces as series through
``flush_chunk`` at the one host read of each chunk, the consensus
counters and the ``trainer.*`` spans; ``profile_costs`` registers the
cost profile of one training step (``cost_profile``), counted on a
snapshot of the state; ``timer_every_n`` times one chunk in N with CUDA
events (``SampledDispatchTimer``) and, with a profile, derives MFU.  All
three are host-side and leave the run bit-identical to an obs-off run;
inside a superstep they add no host sync.

Dropout masks, crops and flips come from explicit ``torch.Generator``s,
one per agent, seeded from ``seed``; their bits cannot follow the
reference's ``jax.random`` streams.  A model with MoE blocks trains on
``loss + moe_aux_coef * aux`` (the mean load-balance loss over its
blocks), and the loss trace reports that sum, as the reference's does.
``remat`` recomputes the forward's activations in the backward
(``torch.utils.checkpoint``, non-reentrant, around the loss, where the
reference puts ``jax.checkpoint``): the recompute replays the forward's
dropout masks, leaves BatchNorm running statistics alone and counts no
flash launch or obs hook, so a run with remat equals one without it bit
for bit.

``mesh`` (an :class:`~distributed_learning_tpu_torch.parallel.multihost.AgentMesh`)
is the paper's loop with one agent a rank: every rank builds the same
seeded init, keeps its own agent's parameters, optimizer slots and
BatchNorm statistics (a model stacked over one agent), draws the whole
shuffle stream and trains on its own row of it, and mixes through the
sharded consensus engine.  The per-step traces, the eval accuracies and
the residual are read across the ranks, so every rank reports what the
dense trainer reports.  On the card a superstep replays the training
graph and runs each epoch's gossip eagerly between the replays (gloo
cannot be captured).  CHOCO (``ChocoGossipEngine(mesh=)``), async and
robust gossip run sharded too: the estimates, the error-feedback bank,
the async carry's ``pub`` and the robust mass are this rank's (the mass
read as the total over the agents, the carry's ages replicated).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Callable, Dict, Hashable, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from distributed_learning_tpu_torch.data.cifar import augment_batch, draw_augment
from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models import get_model
from distributed_learning_tpu_torch.models._stacked import remat_tape
from distributed_learning_tpu_torch.models.moe import collect_load_balance_loss
from distributed_learning_tpu_torch.obs.carry import flush_chunk, global_norm
from distributed_learning_tpu_torch.obs.cost import SampledDispatchTimer, get_profile, profile_fn
from distributed_learning_tpu_torch.obs.instrument import muted
from distributed_learning_tpu_torch.obs.registry import MetricsRegistry, get_registry
from distributed_learning_tpu_torch.obs.spans import SpanTracer, get_tracer
from distributed_learning_tpu_torch.ops import flash_attention as fa
from distributed_learning_tpu_torch.ops import mixing as mixing_ops
from distributed_learning_tpu_torch.parallel.compression import (
    ChocoGossipEngine,
    compressor_from_spec,
)
from distributed_learning_tpu_torch.parallel.consensus import AsyncGossipState, ConsensusEngine
from distributed_learning_tpu_torch.parallel.multihost import AgentMesh
from distributed_learning_tpu_torch.parallel.robust import as_robust_config
from distributed_learning_tpu_torch.parallel.schedule import chebyshev_omegas
from distributed_learning_tpu_torch.parallel.topology import Topology
from distributed_learning_tpu_torch.parallel.topology import gamma as mixing_gamma
from distributed_learning_tpu_torch.training import checkpoint as ckpt
from distributed_learning_tpu_torch.training.graphs import GraphSet, StateSnapshot, count_host_syncs
from distributed_learning_tpu_torch.utils.telemetry import TelemetryProcessor

__all__ = [
    "MasterNode",
    "ConsensusNode",
    "GossipTrainer",
    "SGD",
    "Adam",
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


class SGD(torch.optim.Optimizer):
    """optax's ``sgd`` on the stacked buffer, with ``add_decayed_weights``
    in front for ``weight_decay`` (torch's L2 semantics): ``g += wd p``;
    ``m <- momentum m + g``; ``p -= lr (g + momentum m)`` with Nesterov,
    ``p -= lr m`` without.  The momentum starts at zero (optax's
    ``trace``) and exists from construction on, so the first step runs
    the same ops as every later one, eager or captured in a CUDA graph.
    ``lr`` is a float, or a 0-dim tensor on the parameters' device that
    each step reads (a learning-rate schedule on the card)."""

    def __init__(self, params, lr, momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=float(momentum), nesterov=bool(nesterov),
                                      weight_decay=float(weight_decay)))
        for group in self.param_groups:
            if group["momentum"]:
                for p in group["params"]:
                    self.state[p]["momentum_buffer"] = torch.zeros_like(p)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("SGD.step takes no closure")
        for group in self.param_groups:
            lr, m, wd = group["lr"], group["momentum"], group["weight_decay"]
            for p in group["params"]:
                d = p.grad
                if wd:
                    d = d.add(p, alpha=wd)
                if m:
                    buf = self.state[p]["momentum_buffer"]
                    buf.mul_(m).add_(d)
                    d = d.add(buf, alpha=m) if group["nesterov"] else buf
                if isinstance(lr, torch.Tensor):
                    p.addcmul_(d, lr, value=-1.0)
                else:
                    p.add_(d, alpha=-lr)


class Adam(torch.optim.Optimizer):
    """optax's ``adam`` / ``adamw`` with ``eps_root`` on the stacked
    buffer: ``m <- b1 m + (1 - b1) g``, ``v <- b2 v + (1 - b2) g^2``, ``t
    <- t + 1``, ``u = m_hat / (sqrt(v_hat + eps_root) + eps)`` with
    ``m_hat = m / (1 - b1^t)`` and ``v_hat = v / (1 - b2^t)``, then ``p
    -= lr u``.  ``weight_decay`` is L2 added to the gradient first
    (``optax.add_decayed_weights`` in front of adam), or with
    ``decoupled`` added to the update (``optax.adamw``: ``p -= lr (u + wd
    p)``).  The moments and the step count are tensors on the
    parameters' device, made at construction, so every step runs the
    same ops, eager or captured in a CUDA graph.  ``lr`` is a float or a
    0-dim device tensor, as for :class:`SGD`.

    A contiguous parameter is updated in slices of ``CHUNK`` elements:
    the update's temporaries (the decayed gradient, ``m_hat``, ``v_hat``)
    then take a slice's memory, not three copies of the whole stacked
    buffer (3 x 4.9 GB on the 4-agent extras LM, which a superstep's
    capture holds in its pool).  Every element goes through the same
    operations, so the result does not depend on the slicing."""

    CHUNK = 1 << 26

    def __init__(self, params, lr, betas=(0.9, 0.999), eps: float = 1e-8,
                 eps_root: float = 0.0, weight_decay: float = 0.0, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(map(float, betas)), eps=float(eps),
                                      eps_root=float(eps_root), weight_decay=float(weight_decay),
                                      decoupled=bool(decoupled)))
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                st["exp_avg"] = torch.zeros_like(p)
                st["exp_avg_sq"] = torch.zeros_like(p)

    def _slices(self, *ts):
        """``ts`` cut into aligned slices of at most ``CHUNK`` elements (the
        tensors themselves when one is not contiguous or all are small)."""
        n = ts[0].numel()
        if n <= self.CHUNK or not all(t.is_contiguous() for t in ts):
            yield ts
            return
        flat = [t.view(-1) for t in ts]
        for i in range(0, n, self.CHUNK):
            yield tuple(f[i:i + self.CHUNK] for f in flat)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError("Adam.step takes no closure")
        for group in self.param_groups:
            lr, (b1, b2), wd = group["lr"], group["betas"], group["weight_decay"]
            for p in group["params"]:
                st = self.state[p]
                m, v, t = st["exp_avg"], st["exp_avg_sq"], st["step"]
                t.add_(1.0)
                c1, c2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
                for ps, g, ms, vs in self._slices(p, p.grad, m, v):
                    if wd and not group["decoupled"]:
                        g = g.add(ps, alpha=wd)
                    ms.mul_(b1).add_(g, alpha=1.0 - b1)
                    vs.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    m_hat = ms / c1
                    v_hat = vs / c2
                    u = m_hat.div_(v_hat.add_(group["eps_root"]).sqrt_().add_(group["eps"]))
                    if wd and group["decoupled"]:
                        u.add_(ps, alpha=wd)
                    if isinstance(lr, torch.Tensor):
                        ps.addcmul_(u, lr, value=-1.0)
                    else:
                        ps.add_(u, alpha=-lr)


class _OptimizerFactory(NamedTuple):
    """``build(flat_params, lr=None)`` and the learning-rate ``schedule``
    (``None`` for a constant rate)."""

    build: Callable[..., torch.optim.Optimizer]
    schedule: Optional[Callable[[int], Any]]
    lr: float

    def __call__(self, p: torch.Tensor, lr=None) -> torch.optim.Optimizer:
        return self.build(p, self.lr if lr is None else lr)


def make_optimizer(
    optimizer: Any = "sgd",
    optimizer_kwargs: Optional[Mapping[str, Any]] = None,
    learning_rate: Any = 0.02,
) -> _OptimizerFactory:
    """Resolve the reference's ``optimizer`` / ``optimizer_kwargs`` pair to
    a factory ``build(flat_params, lr=None) -> torch.optim.Optimizer``.

    Names ``'sgd'`` / ``'adam'`` / ``'adamw'`` take torch-style kwargs
    (``momentum``, ``nesterov``, ``weight_decay``) with the reference's
    semantics: for sgd and adam, ``weight_decay`` is L2 added to the
    gradient before the update (``optax.add_decayed_weights`` chained in
    front); for adamw it is decoupled.  Adam's defaults are optax's (eps
    1e-8, ``eps_root`` 0).  Both adam names build the port's :class:`Adam`
    (optax's update, its step count and moments on the parameters'
    device, so eager and captured steps compute alike) for every
    ``eps_root``.  A ``torch.optim.Optimizer`` subclass or factory is
    called as ``optimizer([flat_params], lr=..., **kwargs)``.

    The learning rate may be an optax-style schedule ``count -> lr``,
    read at the update count *before* the update, as optax does: the
    factory's ``schedule`` holds it, and the trainer sets each step's
    rate (a float on the CPU; on the card a 0-dim device tensor passed
    as ``lr``, which a captured step reads).
    """
    kw = dict(optimizer_kwargs or {})
    lr = kw.pop("lr", kw.pop("learning_rate", learning_rate))
    schedule = lr if callable(lr) else None
    lr0 = float(schedule(0)) if schedule is not None else float(lr)
    if isinstance(optimizer, str):
        wd = float(kw.pop("weight_decay", 0.0))
        name = optimizer.lower()
        if name == "sgd":
            momentum = float(kw.pop("momentum", 0.0) or 0.0)
            nesterov = bool(kw.pop("nesterov", False))
            if kw:
                raise ValueError(f"unknown sgd kwargs {sorted(kw)}")
            return _OptimizerFactory(
                lambda p, lr: SGD([p], lr=lr, momentum=momentum, nesterov=nesterov,
                                  weight_decay=wd), schedule, lr0)
        if name in ("adam", "adamw"):
            betas = (float(kw.pop("b1", 0.9)), float(kw.pop("b2", 0.999)))
            eps = float(kw.pop("eps", 1e-8))
            eps_root = float(kw.pop("eps_root", 0.0))
            if kw:
                raise ValueError(f"unknown {name} kwargs {sorted(kw)}")
            return _OptimizerFactory(
                lambda p, lr: Adam([p], lr=lr, betas=betas, eps=eps, eps_root=eps_root,
                                   weight_decay=wd, decoupled=name == "adamw"),
                schedule, lr0)
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if callable(optimizer):
        return _OptimizerFactory(lambda p, lr: optimizer([p], lr=lr, **kw), schedule, lr0)
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


def _mesh_device(mesh, device):
    """The mesh's device (``device`` without a mesh), after checking that
    ``mesh`` is an ``AgentMesh`` on ``device``."""
    if mesh is None:
        return device
    if not isinstance(mesh, AgentMesh):
        raise ValueError("mesh must be a parallel.multihost.AgentMesh (one agent a rank), "
                         f"got {mesh!r}")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    return mesh.device


def _remat_contexts():
    """``torch.utils.checkpoint``'s ``context_fn`` for ``remat``: the
    forward records its dropout masks; the recompute replays them (the
    explicit generators do not advance twice, which the checkpoint's own
    RNG stash would not prevent), leaves BatchNorm running statistics
    alone (``models/_stacked.recomputing``), and counts its flash launches
    and obs hooks into records it throws away, so counters read as
    without remat."""
    forward, recompute = remat_tape()

    @contextlib.contextmanager
    def recompute_quietly():
        with fa.record_launches(), muted(), recompute():
            yield

    return forward(), recompute_quietly()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t``, for a checkpoint."""
    return t.detach().to("cpu", copy=True)


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
class _Plan(NamedTuple):
    """One epoch's gossip, resolved on the host: ``mode`` 0 (none), 1
    (this configuration's mixing) or 2 (the Gossip-PGA exact average);
    the round count (the floor for eps stopping); the epoch's matrix
    under a ``topology_schedule`` and its Chebyshev weights (float32);
    with ``async_gossip`` the epoch's staleness bound."""

    mode: int
    times: int
    W: Optional[np.ndarray] = None
    omegas: Optional[np.ndarray] = None
    tau: int = 0


class _Static(NamedTuple):
    """The captured graphs' fixed-address inputs and outputs."""

    idx: torch.Tensor                  # (steps, n, B) batch indices
    lr: Optional[torch.Tensor]         # (steps,) learning rates, with a schedule
    trace: torch.Tensor                # (steps, 3, n) loss, accuracy, gradient norm
    W: torch.Tensor                    # (n, n) the epoch's matrix (topology_schedule)
    omegas: Dict[int, torch.Tensor]    # rounds -> (rounds,) Chebyshev weights
    tau: torch.Tensor                  # () int32 the epoch's staleness bound (async_gossip)
    dev: torch.Tensor                  # () post-mix max deviation


class GossipTrainer:
    """Stacked-replica gossip-SGD trainer.

    Parameters mirror the MasterNode surface but take in-memory arrays:
    ``train_data[name] = (X, y)`` and ``test_data = (X, y)``.  ``model``
    is a registry name (built with ``n_agents`` = number of nodes) or an
    agent-stacked model whose ``n_agents`` equals the number of nodes.
    ``device`` defaults to the card; pass ``"cpu"`` for the plain path.
    ``superstep=k`` makes :meth:`start_consensus` run k epochs per
    :meth:`train_epochs` call.
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
        learning_rate: Any = 0.02,
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
        compression_gamma: float = 0.2,
        compression_budget: str = "per-leaf",
        compression_error_feedback: bool = False,
        fused_consensus: bool = True,
        async_gossip: Any = None,
        robust_mixing: Any = None,
        topology_schedule: Optional[Callable[[int], Any]] = None,
        chebyshev: bool = False,
        global_avg_every: Optional[int] = None,
        mesh: Any = None,
        obs: Any = None,
        profile_costs: bool = False,
        timer_every_n: int = 0,
        dropout: bool = True,
        augment: bool = False,
        augment_pad_value: Any = 0.0,
        remat: bool = False,
        moe_aux_coef: float = 0.01,
    ):
        device = _mesh_device(mesh, device)
        self.mesh = mesh
        self.remat = bool(remat)
        self.moe_aux_coef = float(moe_aux_coef)
        self.device = resolve_device(device)
        self.eval_batch_size = int(eval_batch_size)
        self.node_names = list(node_names)
        n = len(self.node_names)
        if n == 0:
            raise ValueError("need at least one node")
        if mesh is not None and mesh.size != n:
            raise ValueError(f"mesh has {mesh.size} agents for {n} nodes")
        # The agents this process holds: its rank's one on a mesh, else all.
        self._local = [mesh.agent] if mesh is not None else list(range(n))
        n_local = len(self._local)
        if train_data is None:
            raise ValueError(
                "train_data (MasterNode: train_loaders) is required: a dict "
                "mapping each node name to its (X, y) shard"
            )
        missing = [t for t in self.node_names if t not in train_data]
        if missing:
            raise ValueError(f"train_data missing for nodes: {missing}")
        self._check_gossip_options(mix_eps, chebyshev, global_avg_every, superstep, adaptive_comm)
        compression = self._check_compression(compression, compression_error_feedback, mix_eps,
                                              chebyshev, topology_schedule)
        self._check_async_robust(async_gossip, robust_mixing, chebyshev=chebyshev,
                                 mix_eps=mix_eps, topology_schedule=topology_schedule,
                                 global_avg_every=global_avg_every, compression=compression)
        self._Xs, self._ys = self._stack_data(train_data, batch_size)
        self.augment = bool(augment)
        self.augment_pad_value = augment_pad_value
        if self.augment and tuple(self._Xs.shape[2:]) != (32, 32, 3):
            raise ValueError(
                "augment=True needs (32, 32, 3) image inputs; got per-sample "
                f"shape {tuple(self._Xs.shape[2:])}"
            )
        # On the device once, so an augmentation step copies nothing from the host.
        self._pad_value = torch.as_tensor(np.asarray(augment_pad_value), device=self.device)
        if isinstance(model, str):
            model = get_model(
                model, *model_args, n_agents=n_local, device=self.device,
                seed=seed, input_shape=tuple(self._Xs.shape[2:]),
                **dict(model_kwargs or {}),
            )
        if getattr(model, "n_agents", None) != n_local:
            raise ValueError(
                f"model must be agent-stacked over the {n_local} nodes this process holds "
                f"(n_agents={getattr(model, 'n_agents', None)})"
            )
        if model.flat_params.device != self.device:
            raise ValueError(
                f"model lives on {model.flat_params.device}, trainer on {self.device}"
            )
        self.model = model
        self.dropout = bool(dropout)
        if hasattr(model, "set_dropout"):
            # The reference passes no dropout PRNG when dropout=False, so
            # its dropout layers cannot run; here they are switched off.
            model.set_dropout(self.dropout)
        # One generator per agent for the crops and flips.
        self._aug_gens = [torch.Generator(self.device) for _ in range(n_local)]
        self.loss_fn = get_loss(error)
        self.metric_fn = get_metric(error)
        self._make_opt = make_optimizer(optimizer, optimizer_kwargs, learning_rate)
        self.telemetry = telemetry
        # Observability: None/False off, True the process-wide registry and
        # tracer, or a MetricsRegistry with a tracer of its own.
        if obs is None or obs is False:
            self._obs_registry, self._obs_tracer = None, None
        elif obs is True:
            self._obs_registry, self._obs_tracer = get_registry(), get_tracer()
        elif isinstance(obs, MetricsRegistry):
            self._obs_registry, self._obs_tracer = obs, SpanTracer(registry=obs)
        else:
            raise ValueError(
                "obs must be None/False (off), True (default registry), "
                f"or a MetricsRegistry; got {obs!r}"
            )
        # The cost profile of one step, registered once per program name;
        # the sampled chunk timer (off at 0).
        self.profile_costs = bool(profile_costs)
        self._cost_profiled: set = set()
        self._cost_timer: Optional[SampledDispatchTimer] = None
        if int(timer_every_n) > 0:
            self._cost_timer = SampledDispatchTimer(
                int(timer_every_n), name="trainer.epoch", registry=self._obs_registry)
        self.stat_step = int(stat_step)
        self.num_epochs = int(epoch)
        self.epoch_cons_num = int(epoch_cons_num)
        self.batch_size = int(batch_size)
        self.mix_times = int(mix_times)
        self.mix_eps = mix_eps
        self.seed = seed
        self.superstep = int(superstep)
        self.mix_times_schedule = mix_times_schedule
        self.topology_schedule = topology_schedule
        self.chebyshev = bool(chebyshev)
        self.global_avg_every = global_avg_every

        # With a topology_schedule, epoch e mixes with its own graph and
        # ``weights`` only seeds the engine (its residual and gamma).
        if weights is None and topology_schedule is not None:
            weights = topology_schedule(0)
        W = resolve_mixing_matrix(weights, self.node_names)
        if n > 1 and topology_schedule is None and np.allclose(W, np.eye(n)):
            warnings.warn(
                "GossipTrainer: mixing matrix is the identity (weights=None"
                " or an edgeless topology) — nodes will train in isolation"
                " with no gossip. Pass weights=Topology.ring(n) (or any"
                " connected topology/matrix) for consensus training.",
                stacklevel=2,
            )
        self.engine = ConsensusEngine(W, mesh=mesh, device=self.device)
        # The per-leaf spans of the (N, P) parameter buffer: CHOCO's
        # per-leaf budget and the engine's layout gauges read them.
        named = model.stacked_parameters()
        self._param_layout = mixing_ops.FusedLayout(
            tuple(mixing_ops._LeafSlot(name, "float32", off, tuple(named[name].shape[1:]), size)
                  for name, (off, size) in model.param_slices.items()),
            (("float32", model.flat_params.shape[1]),))
        # The async carry and the robust mass: fixed-address state that the
        # gossip graphs write; the checkpoint holds neither.
        self._async_state: Optional[AsyncGossipState] = None
        if self._async_sim is not None:
            self._async_sim["periods"] = self.engine._normalize_periods(
                self._async_sim["periods"])
            self.engine._periods_tensor(self._async_sim["periods"])  # copied before any capture
            self._async_state = AsyncGossipState(
                pub={"float32": torch.zeros_like(model.flat_params)},
                age=torch.zeros(n, dtype=torch.int32, device=self.device),
                rnd=torch.zeros((), dtype=torch.int32, device=self.device))
        self._robust_mass: Optional[torch.Tensor] = None
        if self._robust_cfg is not None:
            self._robust_mass = torch.zeros((), dtype=torch.float32, device=self.device)
        # Each robust epoch's redirected mass on the host, in epoch order
        # (the reference's consensus.robust.clipped_mass increments).
        self._robust_masses: List[float] = []
        # Fused flat-buffer consensus; False runs CHOCO's per-leaf oracle
        # (every other route mixes the fused buffer either way).
        self.fused_consensus = bool(fused_consensus)
        self._choco: Optional[ChocoGossipEngine] = None
        if compression is not None:
            self._choco = ChocoGossipEngine(
                self.engine.W, compression, gamma=compression_gamma, fused=self.fused_consensus,
                budget=str(compression_budget), error_feedback=bool(compression_error_feedback),
                mesh=mesh, device=self.device)
            flat = model.flat_params
            self._choco_layout = self._param_layout
            # The estimates, the error-feedback bank and the random kinds'
            # generator: fixed-address state that the gossip graphs write.
            self._choco_xhat = torch.zeros_like(flat)
            self._choco_ef = torch.zeros_like(flat) if self._choco.error_feedback else None
            self._choco_gen = torch.Generator(self.device)
            self._reset_choco()
            self._choco.fused_compressor.prepare(self._choco_layout, self.device)
        if (self.chebyshev and topology_schedule is None and n > 1
                and not (0.0 <= self.engine.gamma < 1.0)):
            raise ValueError(
                "chebyshev=True needs a connected mixing graph with "
                f"gamma < 1; got gamma={self.engine.gamma} (weights="
                f"{'None (isolated nodes)' if weights is None else 'given'})"
            )

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
        self._agent = torch.arange(n_local, device=self.device)[:, None]
        self._opt: Optional[torch.optim.Optimizer] = None
        # A learning-rate schedule on the card: the 0-dim rate every step reads.
        self._lr: Optional[torch.Tensor] = None
        self._opt_steps = 0
        self._spare = None
        self._graphs: Optional[GraphSet] = None
        self._static: Optional[_Static] = None
        # Synchronising CUDA calls inside each superstep's replays.
        self.superstep_host_syncs: List[int] = []
        self._global_step = 0
        self._epochs_done = 0

    @staticmethod
    def _check_compression(compression, error_feedback, mix_eps, chebyshev, topology_schedule):
        """The reference's checks of the CHOCO options; returns the
        compressor, or ``None`` when compression is off (``None``,
        ``"none"`` or ``"identity"``: the plain dense gossip, not CHOCO
        with an identity compressor)."""
        if isinstance(compression, str):
            if compression.partition(":")[0].strip().lower() in ("none", "identity"):
                compression = None
            elif not compression.strip():
                raise ValueError("empty compression spec; use None or 'none' to disable")
        if compression is not None:
            if chebyshev or topology_schedule is not None or mix_eps is not None:
                raise ValueError(
                    "compression is mutually exclusive with chebyshev, topology_schedule, "
                    "and mix_eps"
                )
            if isinstance(compression, str):
                compression = compressor_from_spec(compression)
        if error_feedback and compression is None:
            raise ValueError(
                "compression_error_feedback=True needs a compression config (it banks "
                "the mass the compressor drops)"
            )
        return compression

    def _check_async_robust(self, async_gossip, robust_mixing, *, chebyshev, mix_eps,
                            topology_schedule, global_avg_every, compression) -> None:
        """The reference's checks of ``async_gossip`` and
        ``robust_mixing``, with its texts; sets ``_async_sim`` (the bound:
        an int or a callable ``epoch -> tau``, and the raw periods) and
        ``_robust_cfg``.  ``mix_times_schedule`` and ``adaptive_comm``
        compose with both, and the two with each other."""
        others = (chebyshev or mix_eps is not None or topology_schedule is not None
                  or global_avg_every is not None or compression is not None)
        self._async_sim = None
        if async_gossip is not None and async_gossip is not False:
            if not isinstance(async_gossip, Mapping):
                raise ValueError(
                    "async_gossip must be a mapping with keys 'staleness_bound' and/or "
                    f"'publish_period', got {async_gossip!r}"
                )
            unknown = set(async_gossip) - {"staleness_bound", "publish_period"}
            if unknown:
                raise ValueError(f"unknown async_gossip keys: {sorted(unknown)}")
            if others:
                raise ValueError(
                    "async_gossip applies to the plain-mix config only; it is mutually "
                    "exclusive with chebyshev, mix_eps, topology_schedule, global_avg_every, "
                    "and compression (mix_times_schedule composes: it sets the per-epoch "
                    "async round budget)"
                )
            tau = async_gossip.get("staleness_bound", 0)
            self._async_sim = {"tau": tau if callable(tau) else int(tau),
                               "periods": async_gossip.get("publish_period", 1)}
        self._robust_cfg = None
        if robust_mixing is not None and robust_mixing is not False:
            self._robust_cfg = as_robust_config(robust_mixing)
            if others:
                raise ValueError(
                    "robust_mixing applies to the plain-mix (optionally async_gossip) config "
                    "only; it is mutually exclusive with chebyshev, mix_eps, "
                    "topology_schedule, global_avg_every, and compression"
                )

    def _check_gossip_options(self, mix_eps, chebyshev, global_avg_every, superstep,
                              adaptive_comm) -> None:
        """The reference's constructor checks of the gossip options, with
        its messages' meaning; sets the adaptive controller's config."""
        if chebyshev and mix_eps is not None:
            raise ValueError(
                "mix_eps (eps-stopping) and chebyshev (fixed accelerated "
                "schedule) are mutually exclusive; pick one stopping rule"
            )
        if global_avg_every is not None and global_avg_every < 1:
            raise ValueError("global_avg_every must be >= 1")
        if int(superstep) < 1:
            raise ValueError(f"superstep must be >= 1, got {superstep}")
        self._adaptive_cfg = None
        self._adaptive_res = None
        if adaptive_comm is None or adaptive_comm is False:
            return
        if not isinstance(adaptive_comm, Mapping):
            raise ValueError(
                "adaptive_comm must be a mapping with 'target' and optional "
                f"'gain'/'min_times'/'max_times', got {adaptive_comm!r}"
            )
        unknown = set(adaptive_comm) - {"target", "gain", "min_times", "max_times"}
        if unknown:
            raise ValueError(f"unknown adaptive_comm keys: {sorted(unknown)}")
        if "target" not in adaptive_comm:
            raise ValueError(
                "adaptive_comm needs 'target': the consensus residual the "
                "controller steers toward"
            )
        target = float(adaptive_comm["target"])
        if not target > 0.0:
            raise ValueError(f"adaptive_comm target must be > 0, got {target}")
        lo = int(adaptive_comm.get("min_times", 1))
        hi = int(adaptive_comm.get("max_times", 10_000))
        if lo < 1 or hi < lo:
            raise ValueError(f"adaptive_comm needs 1 <= min_times <= max_times, got [{lo}, {hi}]")
        if chebyshev:
            raise ValueError(
                "adaptive_comm is mutually exclusive with chebyshev: the "
                "accelerated omega schedule is derived for a fixed round "
                "count, not a residual-modulated one"
            )
        self._adaptive_cfg = {"target": target, "gain": float(adaptive_comm.get("gain", 1.0)),
                              "min_times": lo, "max_times": hi}
        # Seeded at the target: the first epoch runs the unmodified count.
        self._adaptive_res = np.float32(target)

    # ------------------------------------------------------------------ #
    def _stack_data(self, train_data, batch_size):
        """The shards of the agents this process holds, each cut to the
        smallest shard's batch-aligned length (over every node)."""
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
        local = [self.node_names[a] for a in self._local]
        Xs = np.stack([np.asarray(train_data[t][0][:m]) for t in local])
        ys = np.stack([np.asarray(train_data[t][1][:m]) for t in local])
        return (torch.as_tensor(Xs, device=self.device),
                torch.as_tensor(ys, device=self.device))

    @property
    def _buffers(self) -> Dict[str, torch.Tensor]:
        """The parameters as the engine's fused ``{dtype: (N, P)}`` state:
        parameters only, so the gossip never touches the running
        statistics (``model.flat_stats``) or the optimizer's moments."""
        return {"float32": self.model.flat_params}

    @property
    def _train_generators(self) -> List[torch.Generator]:
        """Every generator a training step draws from: dropout, augmentation."""
        return list(getattr(self.model, "generators", [])) + self._aug_gens

    @property
    def _generators(self) -> List[torch.Generator]:
        """Every generator the training steps and the gossip draw from
        (the CHOCO one for ``random_k``)."""
        return self._train_generators + ([self._choco_gen] if self._choco is not None else [])

    @torch.no_grad()
    def _reset_choco(self) -> None:
        """CHOCO's fresh state: estimates and error-feedback bank at zero,
        the generator at ``seed + 2`` (the reference's lazy init); no
        estimates are ``present`` until a CHOCO round runs."""
        self._choco_xhat.zero_()
        if self._choco_ef is not None:
            self._choco_ef.zero_()
        self._choco_gen.manual_seed(int(self.seed) + 2)
        self._choco_present = False

    # ------------------------------------------------------------------ #
    def initialize_nodes(
        self,
        params: Optional[Mapping[str, Any]] = None,
        batch_stats: Optional[Mapping[str, Any]] = None,
    ):
        """Shared init (from ``seed``, or ``params`` — ``{name: array}`` as
        ``convert.flax_to_torch`` gives, stacked or per agent), BatchNorm
        running statistics at mean 0 and variance 1 for every agent (or
        ``batch_stats``, in the same form), fresh per-node optimizer state
        reseeded dropout and augmentation streams, fresh CHOCO
        estimates and a fresh async carry (parity:
        ``master.initialize_nodes()``)."""
        if params is None:
            self.model.reset_parameters(self.seed)
        else:
            self.model.load_stacked(self._local_rows(params, self.model.stacked_parameters()))
        if batch_stats is None:
            self.model.reset_stats()
        else:
            self.model.load_stats(self._local_rows(batch_stats, self.model.stacked_stats()))
        if hasattr(self.model, "seed_dropout"):
            self.model.seed_dropout(self.seed, first_agent=self._local[0])
        for a, g in zip(self._local, self._aug_gens):
            g.manual_seed(int(np.random.SeedSequence([int(self.seed), 1, a]).generate_state(1)[0]))
        self.model.flat_grads.zero_()
        flat = self.model.flat_params
        flat.grad = self.model.flat_grads
        if self._make_opt.schedule is not None and self.device.type == "cuda":
            if self._lr is None:
                self._lr = torch.zeros((), dtype=torch.float32, device=self.device)
            self._opt = self._make_opt(flat, lr=self._lr)
        else:
            self._opt = self._make_opt(flat)
        # New optimizer state tensors: graphs captured against the old ones are stale.
        self._graphs, self._static = None, None
        self._opt_steps = 0
        if self._adaptive_cfg is not None:
            self._adaptive_res = np.float32(self._adaptive_cfg["target"])
        if self._choco is not None:
            self._reset_choco()  # a fresh run: the estimates restart at 0
        if self._async_state is not None:
            # A fresh run: round 0 publishes every agent (0 is a multiple of
            # every period) before any read, so zeros equal the reference's
            # init_async_state.
            st = self._async_state
            for t in (st.pub["float32"], st.age, st.rnd):
                t.zero_()
        if self._robust_mass is not None:
            self._robust_mass.zero_()
        return self

    def _local_rows(self, tree, ref):
        """A ``{name: value}`` init for this process's agents: a value
        stacked over every node keeps its local rows; an unstacked one is
        broadcast by the model."""
        n = len(self.node_names)
        if self.mesh is None:
            return tree
        return {k: (v[self._local] if tuple(np.shape(v)) == (n,) + tuple(ref[k].shape[1:])
                    else v) for k, v in tree.items()}

    def _agents_last(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` with its trailing agent axis over every node: on a mesh
        each rank's ``(..., 1)`` gathered in agent order (one collective),
        else ``t`` itself."""
        if self.mesh is None:
            return t
        return self.mesh.all_gather(t.contiguous()).movedim(0, -1).squeeze(-2)

    def _epoch_perm(self, epoch_idx: int) -> np.ndarray:
        """Host-side (steps, n, B) shuffle indices for one epoch — one
        ``np.random.default_rng(seed*1000 + epoch)`` stream per epoch, the
        reference's streams exactly, over every node (a process keeps the
        rows of its agents, :meth:`_indices`)."""
        n, m = len(self.node_names), self._Xs.shape[1]
        steps = self.epoch_len
        rng = np.random.default_rng(self.seed * 1000 + epoch_idx)
        idx = np.stack(
            [rng.permutation(m)[: steps * self.batch_size] for _ in range(n)]
        ).astype(np.int32)
        return idx.reshape(n, steps, self.batch_size).swapaxes(0, 1)

    def _indices(self, epoch0: int, k: int) -> torch.Tensor:
        """(k, steps, n, B) indices of ``k`` epochs (this process's agents'
        rows), one host-to-device copy."""
        idx = np.stack([self._epoch_perm(epoch0 + j)[:, self._local]
                        for j in range(k)]).astype(np.int64)
        return torch.as_tensor(idx, device=self.device)

    def _lr_slots(self, k: int) -> Optional[torch.Tensor]:
        """(k, steps) float32 rates of the next ``k`` epochs' updates under
        the schedule (``None`` without one): the schedule at each update's
        count before the update, one host-to-device copy."""
        schedule = self._make_opt.schedule
        if schedule is None:
            return None
        count = self._opt_steps + np.arange(k * self.epoch_len)
        rates = np.asarray([float(schedule(int(c))) for c in count], dtype=np.float32)
        return torch.as_tensor(rates.reshape(k, self.epoch_len), device=self.device)

    def _augment(self, x: torch.Tensor) -> torch.Tensor:
        """RandomCrop(32, pad 4) + flip of every agent's batch, in ONE
        gather over the (N*B) images, each agent's crops and flips drawn
        from its own generator."""
        n, B = x.shape[:2]
        draws = [draw_augment(g, B, self.device) for g in self._aug_gens]
        offsets = torch.cat([d[0] for d in draws])
        flips = torch.cat([d[1] for d in draws])
        out = augment_batch(x.reshape(n * B, *x.shape[2:]), offsets, flips,
                            pad_value=self._pad_value)
        return out.reshape(x.shape)

    def _train_step(self, x, y):
        """One fwd/bwd/update for every agent (train mode: batch
        statistics, running statistics updated, dropout on); returns (N,)
        loss, acc and gradient norm, left on the device."""
        model = self.model
        model.train()
        if self.augment:
            x = self._augment(x)
        model.flat_grads.zero_()
        loss, acc = self._loss(x, y)
        with warnings.catch_warnings():
            # The gradients are strided views into the (N, P) buffer by
            # design; autograd accumulates into them in place.
            warnings.filterwarnings("ignore", message="grad and param do not obey")
            loss.sum().backward()
        gnorm = global_norm(model.flat_grads, dim=1)
        self._opt.step()
        return loss.detach(), acc, gnorm

    def _loss(self, x, y):
        """(N,) training loss of every agent on its batch (with MoE blocks
        ``loss + moe_aux_coef * aux``, the mean load-balance loss over the
        blocks) and (N,) batch accuracy; under ``remat`` the forward's
        activations are recomputed in the backward."""
        if self.remat:
            return checkpoint(self._loss_body, x, y, use_reentrant=False,
                              preserve_rng_state=False, context_fn=_remat_contexts)
        return self._loss_body(x, y)

    def _loss_body(self, x, y):
        logits = self.model(x)
        loss = self.loss_fn(logits, y)
        aux = collect_load_balance_loss(self.model)
        if aux is not None:
            loss = loss + self.moe_aux_coef * aux
        return loss, self.metric_fn(logits.detach(), y).mean(dim=1)

    def _run_steps(self, idx: torch.Tensor, lr: Optional[torch.Tensor],
                   trace: torch.Tensor) -> None:
        """One epoch's training steps on the (steps, n, B) indices ``idx``
        at the (steps,) rates ``lr`` (with a schedule), writing each step's
        (N,) loss, accuracy and gradient norm into ``trace`` (steps, 3, N).
        The same ops eagerly and inside the captured training graph."""
        for t in range(idx.shape[0]):
            if lr is not None:
                if self._lr is not None:
                    self._lr.copy_(lr[t])
                else:
                    for group in self._opt.param_groups:
                        group["lr"] = float(lr[t])
            i = idx[t]
            out = self._train_step(self._Xs[self._agent, i], self._ys[self._agent, i])
            for c, v in enumerate(out):
                trace[t, c].copy_(v)

    # -- gossip ---------------------------------------------------------- #
    def _epoch_mode(self, epoch_idx: int) -> int:
        """0 = no gossip (before ``epoch_cons_num``, or a single node),
        1 = this configuration's mixing, 2 = the Gossip-PGA exact average
        (every ``global_avg_every``-th consensus epoch)."""
        if len(self.node_names) <= 1 or epoch_idx + 1 < self.epoch_cons_num:
            return 0
        consensus_epochs = epoch_idx + 1 - self.epoch_cons_num
        if (self.global_avg_every is not None
                and consensus_epochs % self.global_avg_every == self.global_avg_every - 1):
            return 2
        return 1

    def _adaptive_times_host(self, t: int) -> int:
        """The residual-adaptive round budget ``clip(round(t * (1 + gain
        * (res / target - 1))), min_times, max_times)`` in float32, fed by
        the previous epoch's post-mix residual; the reference's float32
        order of operations.  gain=0 returns ``t`` exactly."""
        c = self._adaptive_cfg
        mult = np.float32(1.0) + np.float32(c["gain"]) * (
            np.float32(self._adaptive_res) / np.float32(c["target"]) - np.float32(1.0)
        )
        te = np.floor(np.float32(t) * mult + np.float32(0.5))
        return int(np.clip(te, c["min_times"], c["max_times"]))

    def _plan(self, epoch_idx: int) -> _Plan:
        """Resolve epoch ``epoch_idx``'s gossip on the host (the
        reference's ``_gossip`` and ``_superstep_sched``): its mode, its
        scheduled round count, and under a ``topology_schedule`` its
        matrix and Chebyshev weights.  Every consensus epoch calls and
        validates ``mix_times_schedule`` once, a Gossip-PGA epoch too
        (it then runs its one exact average); the adaptive controller
        modulates the count later, when the previous residual is known
        (:meth:`_times`)."""
        mode = self._epoch_mode(epoch_idx)
        if mode == 0:
            return _Plan(0, 0)
        times = self.mix_times
        if self.mix_times_schedule is not None:
            times = int(self.mix_times_schedule(epoch_idx))
            if times < 1:
                raise ValueError(
                    f"mix_times_schedule({epoch_idx}) returned {times}; must "
                    "be >= 1 (0 would silently skip gossip while reporting a "
                    "mixed epoch)"
                )
        if mode == 2:
            return _Plan(2, 1)
        if self._async_sim is not None:
            return _Plan(1, times, tau=self._async_tau(epoch_idx))
        W = omegas = None
        if self.topology_schedule is not None:
            W_e = resolve_mixing_matrix(self.topology_schedule(epoch_idx), self.node_names)
            W = np.asarray(W_e, dtype=np.float32)
            if self.chebyshev:
                g_e = mixing_gamma(W_e)
                if not (0.0 <= g_e < 1.0):
                    raise ValueError(
                        f"topology_schedule({epoch_idx}) produced a graph with "
                        f"gamma={g_e}; Chebyshev acceleration needs a connected "
                        "graph with gamma < 1"
                    )
                omegas = chebyshev_omegas(g_e, times).astype(np.float32)
        elif self.chebyshev:
            omegas = chebyshev_omegas(self.engine.gamma, times).astype(np.float32)
        return _Plan(1, times, W, omegas)

    def _async_tau(self, epoch_idx: int) -> int:
        """This epoch's staleness bound: the static int, or the schedule
        resolved at ``epoch_idx`` and validated (>= 0)."""
        tau = self._async_sim["tau"]
        if callable(tau):
            tau = int(tau(epoch_idx))
            if tau < 0:
                raise ValueError(f"staleness_bound({epoch_idx}) returned {tau}; must be >= 0")
        return int(tau)

    def _times(self, plan: _Plan) -> int:
        """The plan's round count, modulated by the adaptive controller
        from the previous epoch's residual (for eps configurations, the
        round floor)."""
        if plan.mode == 1 and self._adaptive_cfg is not None:
            return self._adaptive_times_host(plan.times)
        return plan.times

    def _spare_sets(self):
        """The gossip's spare buffer sets, drawn once (two for Chebyshev)."""
        if self._spare is None:
            self._spare = self.engine.spare_for(self._buffers, 2 if self.chebyshev else 1)
        return self._spare

    @torch.no_grad()
    def _run_gossip(self, mode: int, times: int, W: Optional[torch.Tensor],
                    omegas: Optional[torch.Tensor], tau=0) -> int:
        """One epoch's consensus phase in place on the fused buffer, with
        the epoch's matrix and Chebyshev weights as device tensors (with
        compression: ``times`` CHOCO rounds on the fixed-address
        estimates; a Gossip-PGA epoch zeroes them; with ``async_gossip``:
        async rounds on the fixed-address carry under the staleness bound
        ``tau``, an int or a 0-dim device tensor; with ``robust_mixing``:
        the robust rounds, their redirected mass written into
        ``_robust_mass``); returns the rounds run.  Reads nothing back to
        the host unless eps stopping decides the count."""
        buffers, eng, layout = self._buffers, self.engine, self._param_layout
        if mode == 0:
            return 0
        if self._async_sim is not None or self._robust_cfg is not None:
            spare = self._spare_sets()
            mass = self._robust_mass
            if mass is not None:
                mass.zero_()
            if self._async_sim is None:
                eng.mix_robust_(buffers, self._robust_cfg, times, mass=mass, spare=spare,
                                layout=layout)
            elif self._robust_cfg is None:
                eng.mix_async_(buffers, self._async_state, tau, times,
                               periods=self._async_sim["periods"], spare=spare, layout=layout)
            else:
                eng.mix_async_robust_(buffers, self._async_state, self._robust_cfg, tau, times,
                                      periods=self._async_sim["periods"], mass=mass, spare=spare,
                                      layout=layout)
            return times
        if mode == 2:
            eng.global_average_(buffers, layout=layout)
            if self._choco is not None:
                # The estimates tracked the iterates before the exact
                # average; kept, they would push the now-equal iterates
                # apart again.  The generator is reset on the host
                # (_gossip_done), outside any captured graph.
                self._choco_xhat.zero_()
                if self._choco_ef is not None:
                    self._choco_ef.zero_()
            return 1
        if self._choco is not None:
            ef = None if self._choco_ef is None else {"float32": self._choco_ef}
            for _ in range(times):
                self._choco.round_(buffers, {"float32": self._choco_xhat}, ef,
                                   self._choco_layout, self._choco_gen)
            return times
        spare = self._spare_sets()
        if self.chebyshev:
            eng.mix_chebyshev_(buffers, times, W=W, omegas=omegas, spare=spare, layout=layout)
        elif self.mix_eps is not None:
            rounds, _ = eng.mix_until_with_(buffers, W, eps=self.mix_eps, min_times=times,
                                            spare=spare, layout=layout)
            return rounds
        else:
            eng.mix_with_(buffers, W, times, spare=spare, layout=layout)
        return times

    def _gossip_done(self, mode: int) -> None:
        """The host's part of an epoch's gossip, after it ran (eagerly or
        as a replay): a Gossip-PGA epoch resets the CHOCO generator to
        ``seed + 2`` (a registered generator cannot be re-seeded inside a
        capture) and leaves no estimates; a CHOCO epoch leaves some."""
        if self._choco is None or mode == 0:
            return
        if mode == 2:
            self._choco_gen.manual_seed(int(self.seed) + 2)
        self._choco_present = mode == 1

    def _gossip(self, epoch_idx: Optional[int] = None, plan: Optional[_Plan] = None) -> int:
        """One epoch's consensus phase (epoch ``epoch_idx``, by default the
        next one; ``plan`` if it was resolved already), in place on the
        fused buffer; returns the rounds run."""
        if plan is None:
            plan = self._plan(self._epochs_done if epoch_idx is None else epoch_idx)
        W = plan.W
        if W is not None and self.mesh is None:
            W = torch.as_tensor(W, device=self.device)
        om = None if plan.omegas is None else torch.as_tensor(plan.omegas, device=self.device)
        rounds = self._run_gossip(plan.mode, self._times(plan), W, om, plan.tau)
        self._gossip_done(plan.mode)
        return rounds

    @torch.no_grad()
    def _eval_accuracy(self) -> np.ndarray:
        """Per-node test accuracy over the test set in batches of
        ``eval_batch_size``: the SUM of per-example scores over the seen
        examples, divided by their count.  The reference pads the ragged
        tail and masks it out so one compiled program serves every batch;
        eagerly the tail simply runs at its own size."""
        X, y = self.test_data
        n = len(self._local)
        self.model.eval()  # running statistics, no dropout
        total = torch.zeros(n, dtype=torch.float64, device=self.device)
        for s in range(0, len(X), self.eval_batch_size):
            xb = X[s: s + self.eval_batch_size]
            yb = y[s: s + self.eval_batch_size]
            xs = xb.unsqueeze(0).expand(n, *xb.shape)
            ys = yb.unsqueeze(0).expand(n, *yb.shape)
            per = self.metric_fn(self.model(xs), ys)  # (n, b)
            total += per.sum(dim=1).to(torch.float64)
        return self._agents_last(total / max(len(X), 1)).cpu().numpy()

    # -- observability ---------------------------------------------------- #
    def _span(self, name: str):
        """Wall-clock span on the trainer's tracer (a no-op with obs off)."""
        if self._obs_tracer is None:
            return contextlib.nullcontext()
        return self._obs_tracer.span(name)

    def _count_dispatch(self, n: int = 1) -> None:
        """``trainer.dispatches``: the train path's host dispatches, an
        eager program or a graph replay (an epoch's steps, its gossip, its
        deviation readout; eval and checkpoints are reporting)."""
        if self._obs_registry is not None:
            self._obs_registry.inc("trainer.dispatches", n)

    def _observe_epoch(self, deviation: float, mode: int, rounds: int,
                       mass: Optional[float]) -> None:
        """One epoch's consensus series and counters (the reference's)."""
        reg = self._obs_registry
        if reg is None:
            return
        reg.observe("consensus.residual", deviation, step=self._global_step)
        if mode:
            reg.inc("consensus.rounds_run", rounds)
            if mass is not None:
                # The defense's detection signal: ~0 in honest runs.
                reg.inc("consensus.robust.clipped_mass", mass)
                reg.observe("consensus.robust.mass", mass, step=self._global_step)

    def _observe_eval(self, test_accs: Optional[np.ndarray]) -> None:
        if test_accs is not None and self._obs_registry is not None:
            self._obs_registry.observe("eval.test_acc", float(np.mean(test_accs)),
                                       step=self._global_step)

    def _flush(self, host: np.ndarray) -> Dict[str, np.ndarray]:
        """The chunk's ``(..., steps, 3, n)`` traces, read to the host
        once already, through ``flush_chunk``: the ``train.*`` series."""
        return flush_chunk(
            self._obs_registry,
            {"loss": host[..., 0, :], "acc": host[..., 1, :], "grad_norm": host[..., 2, :]},
            step0=self._global_step, node_names=self.node_names)

    def cost_profile(self, k: Optional[int] = None):
        """:class:`~distributed_learning_tpu_torch.obs.cost.CostProfile` of
        one training step (forward and backward of every agent on the
        next epoch's first batch), registered process-wide as
        ``trainer.epoch`` (``k`` None or 1) or ``trainer.superstep<k>``:
        the loop body of either, whose ``loop_steps`` (``epoch_len``, or
        ``k * epoch_len``) the timer passes.  The step RUNS once, counted
        by ``obs.cost.FlopCounter`` (the flash kernels by their analytic
        count), on a snapshot: the gradients, the running statistics and
        every generator are restored after it, the optimizer is not
        stepped, and its kernel launches and obs hooks do not count.  So
        a later step is bit-identical to one without the profile.

        What the count includes: every aten matrix product of the step
        (projections, the head, the MoE gate and expert GEMMs over all
        ``E * C`` capacity slots, filled or not, and the drop-free path's
        every-expert products), flash attention at 4 (forward) and 10
        (backward) FLOPs per live pair and head dimension over the H query
        heads (under GQA the K/V heads repeated up to H, as the kernels
        run them), and with ``remat`` the recomputed forward; no
        elementwise, normalisation, routing, gather or optimizer work."""
        if self._opt is None:
            self.initialize_nodes()
        name = "trainer.epoch" if k is None or int(k) <= 1 else f"trainer.superstep{int(k)}"
        return profile_fn(self._profile_step, name=name, registry=self._obs_registry,
                          platform=self.device.type)

    def _profile_step(self) -> None:
        model = self.model
        idx = torch.as_tensor(self._epoch_perm(self._epochs_done)[0][self._local]
                              .astype(np.int64), device=self.device)
        snap = StateSnapshot(lambda: [model.flat_grads, model.flat_stats],
                             self._train_generators)
        try:
            with fa.record_launches(), muted():
                x, y = self._Xs[self._agent, idx], self._ys[self._agent, idx]
                model.train()
                if self.augment:
                    x = self._augment(x)
                model.flat_grads.zero_()
                loss, _ = self._loss(x, y)
                with warnings.catch_warnings():
                    warnings.filterwarnings("ignore", message="grad and param do not obey")
                    loss.sum().backward()
        finally:
            snap.restore()

    def _maybe_profile_costs(self, k: Optional[int] = None) -> None:
        """Register this program's cost profile once (``profile_costs``)."""
        key = "epoch" if k is None or int(k) <= 1 else f"superstep{int(k)}"
        if not self.profile_costs or key in self._cost_profiled:
            return
        self._cost_profiled.add(key)
        self.cost_profile(k)

    # -- epochs ----------------------------------------------------------- #
    def train_epoch(self) -> Dict[str, Any]:
        """One epoch: local SGD on every node, then (maybe) gossip."""
        with self._span("trainer.epoch"):
            return self._train_epoch()

    def _train_epoch(self) -> Dict[str, Any]:
        if self._opt is None:
            self.initialize_nodes()
        self._maybe_profile_costs()
        epoch_idx = self._epochs_done
        plan = self._plan(epoch_idx)  # a schedule that raises leaves the state as it was
        mode = plan.mode
        lr = self._lr_slots(1)
        trace = torch.empty(self.epoch_len, 3, len(self._local), device=self.device)
        timer = self._cost_timer
        sampled = timer.tick() if timer is not None else False
        with self._span("trainer.chunk"):
            t0 = timer.start(self.device) if sampled else None
            self._run_steps(self._indices(epoch_idx, 1)[0], None if lr is None else lr[0], trace)
            self._count_dispatch()
            self._opt_steps += self.epoch_len
            mix_rounds = 0
            if mode:
                with self._span("trainer.mix"):
                    mix_rounds = self._gossip(epoch_idx, plan)
                self._count_dispatch()
            if sampled:
                # The declared 1-in-N sync, at the boundary the flush reads.
                timer.measure(t0, name="trainer.epoch", loop_steps=self.epoch_len,
                              step=self._global_step)
            # One host read for the epoch's (steps, 3, n) traces.
            arrs = self._flush(self._agents_last(trace).cpu().numpy())
        losses, accs, gnorms = arrs["loss"], arrs["acc"], arrs["grad_norm"]
        mass = None
        if mode and self._robust_mass is not None:
            mass = float(self._robust_mass)
            self._robust_masses.append(mass)
        self._record_stats(losses, accs)
        test_accs = self._eval_and_record()
        self._count_dispatch()  # the deviation readout
        payload = self._payload(epoch_idx, mode, losses, accs, gnorms, test_accs,
                                mix_rounds, self.parameter_deviation())
        if self._adaptive_cfg is not None:
            self._adaptive_res = np.float32(payload["deviation"])
        self._observe_epoch(payload["deviation"], mode, mix_rounds, mass)
        self._observe_eval(test_accs)
        self._telemetry([payload], sampled)
        return payload

    def _record_stats(self, losses: np.ndarray, accs: np.ndarray) -> None:
        """Per-node curves every ``stat_step`` batches of one epoch's
        (steps, n) traces."""
        for s in range(0, losses.shape[0], self.stat_step):
            chunk = slice(s, min(s + self.stat_step, losses.shape[0]))
            for a, name in enumerate(self.node_names):
                node = self.network[name]
                node.stats.steps.append(self._global_step + chunk.stop)
                node.stats.train_loss.append(float(losses[chunk, a].mean()))
                node.stats.train_acc.append(float(accs[chunk, a].mean()))
        self._global_step += losses.shape[0]
        self._epochs_done += 1

    def _eval_and_record(self) -> Optional[np.ndarray]:
        if self.test_data is None:
            return None
        with self._span("trainer.eval"):
            test_accs = self._eval_accuracy()
        for a, name in enumerate(self.node_names):
            node = self.network[name]
            node.stats.test_acc.append(float(test_accs[a]))
            node.stats.test_epochs.append(self._global_step)
        return test_accs

    @staticmethod
    def _payload(epoch_idx, mode, losses, accs, gnorms, test_accs, mix_rounds, deviation):
        return {
            "epoch": epoch_idx,
            "mixed": mode != 0,
            "train_loss": losses.mean(axis=0),
            "train_acc": accs.mean(axis=0),
            "grad_norm": gnorms.mean(axis=0),
            "test_acc": test_accs,
            "mix_rounds": int(mix_rounds),
            "deviation": float(deviation),
        }

    def _telemetry(self, payloads: List[Dict[str, Any]], sampled: bool) -> None:
        """Per-node payloads to the telemetry processor; with the timer
        configured they carry ``step_time_s`` and ``mfu`` (None on a
        chunk the timer did not sample)."""
        if self.telemetry is None:
            return
        timer = self._cost_timer
        cost_keys = {} if timer is None else {
            "step_time_s": timer.last_step_time_s if sampled else None,
            "mfu": timer.last_mfu if sampled else None,
        }
        with self._span("trainer.telemetry"):
            for p in payloads:
                for a, name in enumerate(self.node_names):
                    self.telemetry.process(
                        name,
                        {
                            "epoch": p["epoch"],
                            "train_loss": float(p["train_loss"][a]),
                            "train_acc": float(p["train_acc"][a]),
                            "grad_norm": float(p["grad_norm"][a]),
                            "test_acc": (None if p["test_acc"] is None
                                         else float(p["test_acc"][a])),
                            "mix_rounds": p["mix_rounds"],
                            "deviation": p["deviation"],
                            **cost_keys,
                        },
                    )

    # -- the epoch superstep ---------------------------------------------- #
    @property
    def _cut(self) -> bool:
        """Whether a superstep's gossip runs eagerly between the training
        replays: its round count depends on a device value (eps stopping,
        the adaptive controller, with host reads), or it crosses ranks
        (a mesh: gloo cannot be captured)."""
        return (self.mix_eps is not None or self._adaptive_cfg is not None
                or self.mesh is not None)

    def _state_tensors(self) -> List[torch.Tensor]:
        """Every tensor a training step or a gossip program writes that
        outlives it: what a warm-up must give back."""
        out = [self.model.flat_params, self.model.flat_grads, self.model.flat_stats]
        if self._choco is not None:
            out += [self._choco_xhat] + ([self._choco_ef] if self._choco_ef is not None else [])
        for st in self._opt.state.values():
            out.extend(v for v in st.values() if isinstance(v, torch.Tensor))
        if self._lr is not None:
            out.append(self._lr)
        if self._async_state is not None:
            out += [self._async_state.pub["float32"], self._async_state.age,
                    self._async_state.rnd]
        if self._robust_mass is not None:
            out.append(self._robust_mass)
        return out

    def _capture(self, keys: Sequence[Tuple]) -> None:
        """Capture the graphs in ``keys`` that do not exist yet: the
        training epoch ``("train",)`` and the gossip programs ``("gossip",
        mode, rounds)`` (each ending with the post-mix deviation).  The
        warm-ups run against the real state, which is restored after."""
        if self._graphs is None:
            n, steps, dev = len(self._local), self.epoch_len, self.device
            self._graphs = GraphSet(dev, self._generators)
            self._static = _Static(
                idx=torch.zeros(steps, n, self.batch_size, dtype=torch.long, device=dev),
                lr=(torch.zeros(steps, dtype=torch.float32, device=dev)
                    if self._make_opt.schedule is not None else None),
                trace=torch.zeros(steps, 3, n, device=dev),
                W=torch.as_tensor(self.engine.W, dtype=torch.float32, device=dev).clone(),
                omegas={}, tau=torch.zeros((), dtype=torch.int32, device=dev),
                dev=torch.zeros((), device=dev))
        todo = [k for k in keys if k not in self._graphs]
        if not todo:
            return
        st, graphs = self._static, self._graphs
        if self._choco is None:
            self._spare_sets()  # outside the graphs' pool
        snap = StateSnapshot(self._state_tensors, graphs.generators)
        try:
            for key in todo:
                if key[0] == "train":
                    graphs.capture(key, lambda: self._run_steps(st.idx, st.lr, st.trace))
                    continue
                _, mode, times = key
                if self.chebyshev and mode == 1 and times not in st.omegas:
                    st.omegas[times] = torch.zeros(times, device=self.device)
                W = st.W if self.topology_schedule is not None else None
                om = st.omegas.get(times) if self.chebyshev and mode == 1 else None

                def gossip(mode=mode, times=times, W=W, om=om):
                    self._run_gossip(mode, times, W, om, st.tau)
                    self.engine.max_deviation_(self._buffers, st.dev)

                graphs.capture(key, gossip)
        except Exception as err:
            raise RuntimeError(
                f"CUDA graph capture of the superstep failed ({err}); "
                "train_epochs does not fall back to the eager loop"
            ) from err
        finally:
            snap.restore()

    def _stage_inputs(self, j: int, idx: torch.Tensor, lr: Optional[torch.Tensor]) -> None:
        """Copy epoch ``j``'s indices and rates into the training graph's
        fixed-address inputs (device to device)."""
        self._static.idx.copy_(idx[j])
        if lr is not None:
            self._static.lr.copy_(lr[j])

    def train_epochs(self, k: int) -> List[Dict[str, Any]]:
        """Run ``k`` epochs as one superstep; returns the per-epoch
        payloads (the schema of :meth:`train_epoch`).

        The trajectory equals ``k`` calls of :meth:`train_epoch`: the same
        shuffle streams, random streams, steps and gossip.  The indices of
        all ``k`` epochs go to the device in one copy and the schedules
        are resolved on the host first; the per-step traces and each
        epoch's post-mix deviation stay on the device until one flush at
        the end.  The test set is evaluated once, at the boundary: earlier
        payloads carry ``test_acc=None``.  On the card each epoch is one
        replay of the captured training graph and one of the gossip
        program's graph for its round count, with no host synchronisation
        (``superstep_host_syncs`` records the count); ``mix_eps`` and
        ``adaptive_comm`` run their gossip eagerly between the replays,
        reading the residual back.  A capture that fails raises.
        """
        k = int(k)
        if k < 1:
            raise ValueError(f"train_epochs needs k >= 1, got {k}")
        if k == 1:
            return [self.train_epoch()]
        with self._span("trainer.superstep"):
            return self._train_superstep(k)

    def _train_superstep(self, k: int) -> List[Dict[str, Any]]:
        if self._opt is None:
            self.initialize_nodes()
        self._maybe_profile_costs(k)
        epoch0, n, steps = self._epochs_done, len(self.node_names), self.epoch_len
        n_local = len(self._local)
        # Every epoch's schedule is called and validated before anything
        # trains: one that raises leaves the state as it was.
        plans = [self._plan(epoch0 + j) for j in range(k)]
        cut = self._cut
        idx = self._indices(epoch0, k)
        lr = self._lr_slots(k)
        W_all = om_all = None
        if self.topology_schedule is not None:
            W_all = torch.as_tensor(np.stack(
                [p.W if p.W is not None else np.eye(n, dtype=np.float32) for p in plans]),
                device=self.device)
        if self.chebyshev:
            om = np.zeros((k, max(p.times for p in plans)), dtype=np.float32)
            for j, p in enumerate(plans):
                if p.omegas is not None:
                    om[j, : len(p.omegas)] = p.omegas
            om_all = torch.as_tensor(om, device=self.device)
        # Each epoch's staleness bound (0 on an epoch without gossip).
        tau_all = torch.as_tensor(np.asarray([p.tau for p in plans], dtype=np.int32),
                                  device=self.device)
        # Everything the host reads at the end, in one buffer: the
        # (k, steps, 3, n) traces, the (k,) post-mix deviations and the
        # (k,) robust masses.
        flush = torch.zeros(k, steps * 3 * n_local + 2, device=self.device)
        traces = flush[:, :-2].view(k, steps, 3, n_local)
        devs, masses = flush[:, -2], flush[:, -1]
        graphs = self.device.type == "cuda"
        timer = self._cost_timer
        sampled = timer.tick() if timer is not None else False
        with self._span("trainer.chunk"):
            if graphs:
                keys = [("train",)]
                if not cut:
                    keys += sorted({("gossip", p.mode, p.times) for p in plans})
                self._capture(keys)
            t0 = timer.start(self.device) if sampled else None
            rounds = [0] * k
            with count_host_syncs(self.device) as syncs:
                for j in range(k):
                    if graphs:
                        self._stage_inputs(j, idx, lr)
                        self._graphs.replay(("train",))
                        traces[j].copy_(self._static.trace)
                    else:
                        self._run_steps(idx[j], None if lr is None else lr[j], traces[j])
                    self._count_dispatch()
                    self._opt_steps += steps
                    p = plans[j]
                    W = None if W_all is None else W_all[j]
                    om = None if om_all is None else om_all[j, : p.times]
                    if cut:  # eps / adaptive: the count needs the residual
                        if j > 0 and self._adaptive_cfg is not None:
                            self._adaptive_res = np.float32(float(devs[j - 1]))
                        rounds[j] = self._run_gossip(p.mode, self._times(p), W, om, tau_all[j])
                        self._gossip_done(p.mode)
                        self.engine.max_deviation_(self._buffers, devs[j])
                        self._count_dispatch(2 if p.mode else 1)
                    else:
                        rounds[j] = p.times if p.mode else 0
                        if graphs:
                            st = self._static
                            if W is not None:
                                st.W.copy_(W)
                            if om is not None and p.mode == 1:
                                st.omegas[p.times].copy_(om)
                            st.tau.copy_(tau_all[j])
                            self._graphs.replay(("gossip", p.mode, p.times))
                            devs[j].copy_(st.dev)
                        else:
                            self._run_gossip(p.mode, p.times, W, om, tau_all[j])
                            self.engine.max_deviation_(self._buffers, devs[j])
                        self._gossip_done(p.mode)
                        self._count_dispatch()  # the gossip program, its deviation included
                    if p.mode and self._robust_mass is not None:
                        masses[j].copy_(self._robust_mass)
            if sampled:
                # One sample covers the whole k-epoch chunk: the declared
                # sync, after the superstep's replays, at the flush.
                timer.measure(t0, name="trainer.superstep",
                              profile=get_profile(f"trainer.superstep{k}"),
                              loop_steps=k * steps, step=self._global_step)
            tr = None if self.mesh is None else self._agents_last(traces).cpu().numpy()
            host = flush.cpu().numpy()
            if graphs:
                self.superstep_host_syncs.append(syncs[0])
            if tr is None:
                tr = host[:, :-2].reshape(k, steps, 3, n)
            arrs = self._flush(tr)  # the (k, steps, n) traces as one k*steps-step chunk
        devs_host = host[:, -2]
        if self._adaptive_cfg is not None:
            self._adaptive_res = np.float32(devs_host[-1])
        payloads = []
        test_accs = None
        for j in range(k):
            self._record_stats(arrs["loss"][j], arrs["acc"][j])
            if j == k - 1:
                test_accs = self._eval_and_record()
            payloads.append(self._payload(epoch0 + j, plans[j].mode, arrs["loss"][j],
                                          arrs["acc"][j], arrs["grad_norm"][j], test_accs,
                                          rounds[j], devs_host[j]))
            mass = None
            if plans[j].mode and self._robust_mass is not None:
                mass = float(host[j, -1])
                self._robust_masses.append(mass)
            self._observe_epoch(float(devs_host[j]), plans[j].mode, rounds[j], mass)
        self._observe_eval(test_accs)
        self._telemetry(payloads, sampled)
        return payloads

    def start_consensus(self) -> List[Dict[str, Any]]:
        """Run the full training schedule (parity: ``master.start_consensus()``),
        in :meth:`train_epochs` chunks of ``superstep`` epochs."""
        results: List[Dict[str, Any]] = []
        while self._epochs_done < self.num_epochs:
            k = min(self.superstep, self.num_epochs - self._epochs_done)
            results.extend(self.train_epochs(k))
        return results

    # ------------------------------------------------------------------ #
    def node_parameters(self) -> Dict[Hashable, Dict[str, torch.Tensor]]:
        """``{node: {param name: tensor}}`` — views of each node's slice
        (on a mesh this rank's node only)."""
        stacked = self.model.stacked_parameters()
        return {
            self.node_names[g]: {k: v[a] for k, v in stacked.items()}
            for a, g in enumerate(self._local)
        }

    def node_batch_stats(self) -> Dict[Hashable, Dict[str, torch.Tensor]]:
        """``{node: {statistic name: tensor}}`` — views of each node's
        BatchNorm running statistics (empty for models without any; on a
        mesh this rank's node only)."""
        stacked = self.model.stacked_stats()
        return {
            self.node_names[g]: {k: v[a] for k, v in stacked.items()}
            for a, g in enumerate(self._local)
        }

    def parameter_deviation(self) -> float:
        return float(self.engine.max_deviation(self._buffers))

    # -- checkpointing ------------------------------------------------- #
    def save_checkpoint(self, path: str) -> None:
        """Write what a resumed run needs to the file ``path``
        (``training/checkpoint.py``): the parameters, the running
        statistics, the optimizer state, every training generator's state
        (the reference's ``rng``), ``epochs_done`` and the step counters,
        and with compression a ``choco`` subtree.  Like the reference, no
        adaptive-controller residual (a resumed adaptive run starts its
        controller at the target) and no async carry (``pub``, ages,
        round counter)."""
        if self._opt is None:
            self.initialize_nodes()
        tree = {
            "params": _host(self.model.flat_params),
            "batch_stats": _host(self.model.flat_stats),
            "opt_state": {k: _host(v) if isinstance(v, torch.Tensor) else v
                          for k, v in self._opt.state[self.model.flat_params].items()},
            "generators": [g.get_state() for g in self._train_generators],
            "epochs_done": self._epochs_done,
            "global_step": self._global_step,
            "opt_steps": self._opt_steps,
        }
        if self._choco is not None:
            # Resuming with fresh estimates would re-converge, but the
            # trajectory would silently leave the uninterrupted one.
            tree["choco"] = self._choco_tree()
        ckpt.save_checkpoint(path, tree)

    def _choco_tree(self) -> Dict[str, Any]:
        """CHOCO state as a checkpoint subtree, as the reference builds
        it: ``present`` says whether estimates exist yet (no CHOCO round
        has run since the last reset); without them the subtree holds the
        fresh state (zeros, the generator at ``seed + 2``)."""
        zeros = torch.zeros(self._choco_xhat.shape, dtype=self._choco_xhat.dtype)
        present = self._choco_present
        gen = self._choco_gen if present else torch.Generator(self.device).manual_seed(
            int(self.seed) + 2)
        tree = {"present": int(present),
                "xhat": _host(self._choco_xhat) if present else zeros,
                "generator": gen.get_state()}
        if self._choco_ef is not None:
            tree["ef"] = _host(self._choco_ef) if present else zeros.clone()
        return tree

    @torch.no_grad()
    def restore_checkpoint(self, path: str) -> None:
        """Read a :meth:`save_checkpoint` file back into this trainer's
        own tensors with ``copy_``, so captured graphs stay valid.  A
        compressed trainer reading a checkpoint without CHOCO state resets
        its estimates; a dense trainer ignores a ``choco`` subtree; both
        warn, with the reference's texts.  As in the reference, the async
        carry is left as it is: the checkpoint holds none."""
        if self._opt is None:
            self.initialize_nodes()
        tree = ckpt.restore_checkpoint(path)
        choco = tree.pop("choco", None)
        flat, stats = self.model.flat_params, self.model.flat_stats
        ckpt.check_structure(
            {k: tree.get(k) for k in ("params", "batch_stats")},
            {"params": torch.empty_like(flat, device="meta"),
             "batch_stats": torch.empty_like(stats, device="meta")})
        gens = self._train_generators
        if len(tree["generators"]) != len(gens):
            raise ValueError(f"checkpoint has {len(tree['generators'])} generator states, "
                             f"this trainer {len(gens)}")
        flat.copy_(tree["params"])
        stats.copy_(tree["batch_stats"])
        state = self._opt.state[flat]
        for key, v in tree["opt_state"].items():
            cur = state.get(key)
            if isinstance(cur, torch.Tensor):
                if cur.shape != v.shape:
                    raise ValueError(f"optimizer state {key!r}: checkpoint {tuple(v.shape)}, "
                                     f"trainer {tuple(cur.shape)}")
                cur.copy_(v)
            else:
                state[key] = v.to(flat.device) if isinstance(v, torch.Tensor) else v
        for g, st in zip(gens, tree["generators"]):
            g.set_state(st)
        self._epochs_done = int(tree["epochs_done"])
        self._global_step = int(tree["global_step"])
        self._opt_steps = int(tree["opt_steps"])
        if self._choco is not None:
            if choco is None or ("ef" in choco) != (self._choco_ef is not None):
                warnings.warn(
                    "checkpoint has no CHOCO state (saved by an older version or a dense "
                    "trainer); estimates reset to zero and error feedback re-converges "
                    "over the next few epochs", stacklevel=2)
                self._reset_choco()
            else:
                self._choco_xhat.copy_(choco["xhat"])
                if self._choco_ef is not None:
                    self._choco_ef.copy_(choco["ef"])
                self._choco_gen.set_state(choco["generator"])
                self._choco_present = bool(int(choco["present"]))
        elif choco is not None:
            warnings.warn("checkpoint contains CHOCO state but this trainer has no "
                          "compression; the estimates are ignored", stacklevel=2)


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
