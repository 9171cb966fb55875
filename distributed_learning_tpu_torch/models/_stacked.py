"""The agent-stacked base that every model of the port shares.

Every parameter carries a leading agent axis ``N`` and is a view into ONE
contiguous ``(N, P)`` float32 buffer (:attr:`StackedModel.flat_params`),
every gradient a view into a twin buffer (:attr:`StackedModel.flat_grads`):
a gossip round is then one ``W @ X`` GEMM on the buffer, the optimizer
steps one tensor, and the per-agent gradient norm is one reduction.
BatchNorm running statistics, where a model has them, are ``(N, C)``
buffers bound the same way into :attr:`StackedModel.flat_stats`, outside
the parameter buffer, so the gossip never touches them.

Parameter and statistic names are the flax tree's paths joined with dots
where the model mirrors a flax tree (``convert.py``).

Dropout draws each agent's mask from that agent's own ``torch.Generator``
(:class:`Dropout`, shared by the vision zoo and the transformer).  Under
activation checkpointing (the trainer's ``remat``) the recompute of a
checkpointed forward must see the masks the forward drew and must not
update BatchNorm running statistics again: :func:`remat_tape` records a
forward's masks and replays them in its recompute, and
:func:`recomputing` tells a layer that the forward it runs is such a
recompute.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["Dense", "Dropout", "StackedModel", "add_child", "dense", "recomputing", "remat_tape"]


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Per-agent ``x @ w (+ b)`` in ``dtype``: x (N, ..., in), w (N, in, out)."""
    N = x.shape[0]
    y = torch.bmm(x.reshape(N, -1, x.shape[-1]), w.to(dtype))
    if b is not None:
        y = y + b.to(dtype)[:, None, :]
    return y.reshape(*x.shape[:-1], w.shape[-1])


class Dense(nn.Module):
    """flax ``nn.Dense`` per agent: kernel (N, in, out), bias (N, out)."""

    def __init__(self, n: int, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n, d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(n, d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias, x.dtype)


class _Tape:
    """The dropout masks one checkpointed forward drew, in draw order;
    ``replay`` iterates over them while its recompute runs."""

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.replay: Optional[Iterator[torch.Tensor]] = None


# Open tapes, innermost last (see remat_tape).
_TAPES: List[_Tape] = []


def remat_tape() -> Tuple[Callable, Callable]:
    """A fresh tape's two context managers, ``(forward, recompute)``, as
    ``torch.utils.checkpoint``'s ``context_fn`` wants them: inside
    ``forward()`` every dropout mask drawn is recorded; inside
    ``recompute()`` the masks are handed back in the same order instead of
    drawn (the generators do not advance again) and :func:`recomputing`
    is true."""
    tape = _Tape()

    @contextlib.contextmanager
    def forward():
        _TAPES.append(tape)
        try:
            yield
        finally:
            _TAPES.pop()

    @contextlib.contextmanager
    def recompute():
        tape.replay = iter(tape.masks)
        _TAPES.append(tape)
        try:
            yield
        finally:
            _TAPES.pop()
            tape.replay = None

    return forward, recompute


def recomputing() -> bool:
    """Whether the forward running now recomputes a checkpointed one."""
    return bool(_TAPES) and _TAPES[-1].replay is not None


def _mask(draw: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``draw()``, recorded on an open tape, or the tape's next mask while
    its recompute runs."""
    if not _TAPES:
        return draw()
    tape = _TAPES[-1]
    if tape.replay is not None:
        return next(tape.replay)
    m = draw()
    tape.masks.append(m)
    return m


class Dropout(nn.Module):
    """Per-agent dropout: agent ``a`` draws its keep mask from
    ``generators[a]``, keeps a unit with probability ``1 - rate`` and
    scales it by ``1 / (1 - rate)`` (flax ``nn.Dropout``).  Takes a list
    of per-agent tensors (the vision zoo) or one agent-stacked tensor
    (the transformer).  Identity in eval mode and when ``enabled`` is
    false."""

    def __init__(self, rate: float, generators: List[torch.Generator]):
        super().__init__()
        self.rate, self.generators, self.enabled = float(rate), generators, True

    def forward(self, xs):
        if not (self.training and self.enabled) or self.rate == 0.0:
            return xs
        keep = 1.0 - self.rate

        def draw(x, g):
            return lambda: torch.empty_like(x).bernoulli_(keep, generator=g).bool()

        if isinstance(xs, torch.Tensor):
            mask = _mask(lambda: torch.stack(
                [draw(x, g)() for x, g in zip(xs.unbind(0), self.generators)]))
            return torch.where(mask, xs / keep, 0.0)
        return [torch.where(_mask(draw(x, g)), x / keep, 0.0)
                for x, g in zip(xs, self.generators)]


def add_child(parent: nn.Module, kind: str, module: nn.Module) -> nn.Module:
    """Register ``module`` under flax's automatic name ``{kind}_{i}``, ``i``
    counting the ``kind`` children ``parent`` has so far, so the port's
    names follow the flax tree's paths by construction."""
    i = sum(1 for name in parent._modules if name.rpartition("_")[0] == kind)
    parent.add_module(f"{kind}_{i}", module)
    return module


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(v, dtype=np.float32))


def _rebind(module: nn.Module, named, flat: torch.Tensor, grads: Optional[torch.Tensor]):
    """Copy each named tensor into its slice of ``flat`` and register the
    slice in its place (a parameter when ``grads`` is given, whose
    ``.grad`` is the twin slice of ``grads``; else a buffer).  Returns
    ``{name: (offset, size)}``."""
    slices: Dict[str, Tuple[int, int]] = {}
    off = 0
    for name, t in named:
        size = t[0].numel()
        view = flat[:, off: off + size].view(t.shape)
        view.copy_(t.detach())
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        if grads is None:
            mod.register_buffer(leaf, view)
        else:
            new = nn.Parameter(view)
            new.grad = grads[:, off: off + size].view(t.shape)
            setattr(mod, leaf, new)
        slices[name] = (off, size)
        off += size
    return slices


class StackedModel(nn.Module):
    """Base of the agent-stacked models: subclasses build their modules
    with a leading ``n_agents`` axis on every parameter (and statistic),
    then call :meth:`_bind_flat`."""

    n_agents: int

    # -- init ---------------------------------------------------------- #
    def _init_std(self, name: str, shape: Tuple[int, ...]) -> float:
        """Standard deviation of the normal init of one agent's ``shape``
        (flax's LeCun-normal family): ``1/sqrt(fan_in)``, where the fan-in
        of a conv kernel ``(out, in, kh, kw)`` is ``in*kh*kw`` and of a
        dense kernel ``(in, out)`` its first axis."""
        fan_in = math.prod(shape[1:]) if len(shape) == 4 else shape[0]
        return 1.0 / math.sqrt(fan_in)

    def _full_shape(self, name: str, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """One agent's whole ``name`` (a model that holds a block of some
        parameters, as a model-parallel rank does, draws the whole and
        keeps its block)."""
        return shape

    def _local_block(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This model's block of one agent's whole ``name``."""
        return full

    def reset_parameters(self, seed: int) -> None:
        """One init (normal kernels, zero biases, unit norm scales)
        broadcast to every agent.  Values differ from flax's draws; tests
        load converted flax weights when they compare."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                shape = p.shape[1:]
                if name.endswith("scale"):
                    p.fill_(1.0)
                    continue
                if name.endswith("bias"):
                    p.fill_(0.0)
                    continue
                full = self._full_shape(name, tuple(shape))
                std = self._init_std(name, tuple(full))
                draw = self._local_block(name, torch.randn(full, generator=gen) * std)
                p.copy_(draw.expand_as(p))

    def reset_stats(self) -> None:
        """Running statistics at mean 0 and variance 1 for every agent
        (flax BatchNorm's init)."""
        with torch.no_grad():
            for name, b in self.stacked_stats().items():
                b.fill_(1.0 if name.endswith("var") else 0.0)

    def _bind_flat(self, device: torch.device) -> None:
        """Move every parameter into one (N, P) float32 buffer (every
        gradient into a twin buffer) and every buffer — the running
        statistics — into one (N, S) buffer, and re-register each as a
        view."""
        n = self.n_agents
        named = list(self.named_parameters())
        total = sum(p[0].numel() for _, p in named)
        self.flat_params = torch.empty(n, total, dtype=torch.float32, device=device)
        self.flat_grads = torch.zeros(n, total, dtype=torch.float32, device=device)
        self.param_slices = _rebind(self, named, self.flat_params, self.flat_grads)
        stats = list(self.named_buffers())
        self.flat_stats = torch.empty(
            n, sum(b[0].numel() for _, b in stats), dtype=torch.float32, device=device)
        self.stat_slices = _rebind(self, stats, self.flat_stats, None)

    # -- access -------------------------------------------------------- #
    def stacked_parameters(self) -> Dict[str, torch.Tensor]:
        """``{name: (N, ...)}`` views of the parameters, in layout order."""
        return {name: p for name, p in self.named_parameters()}

    def stacked_stats(self) -> Dict[str, torch.Tensor]:
        """``{name: (N, C)}`` views of the running statistics."""
        return {name: self.get_buffer(name) for name in self.stat_slices}

    @staticmethod
    def _load(own: Dict[str, torch.Tensor], values, what: str) -> None:
        missing = set(own) - set(values)
        extra = set(values) - set(own)
        if missing or extra:
            raise KeyError(f"{what} names differ: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        with torch.no_grad():
            for name, p in own.items():
                v = _as_tensor(values[name])
                p.copy_(v.expand_as(p) if v.shape != p.shape else v)

    def load_stacked(self, params) -> None:
        """Copy ``{name: (N, ...) or (...)}`` values into the parameters
        (an unstacked value is broadcast to every agent)."""
        self._load(self.stacked_parameters(), params, "parameter")

    def load_stats(self, stats) -> None:
        """Copy ``{name: (N, C) or (C,)}`` values into the running
        statistics (an unstacked value is broadcast to every agent)."""
        self._load(self.stacked_stats(), stats, "statistic")

    # -- dropout ------------------------------------------------------- #
    def _make_generators(self, device: torch.device, seed: int) -> None:
        """One dropout generator per agent on ``device``, seeded."""
        self.generators = [torch.Generator(device) for _ in range(self.n_agents)]
        self.seed_dropout(seed)

    def seed_dropout(self, seed: int, first_agent: int = 0) -> None:
        """Reseed every agent's dropout generator from ``seed`` (a model
        without dropout generators has nothing to reseed); the stack's
        agents are agents ``first_agent, first_agent + 1, ...`` of the run
        (a rank of a sharded trainer holds one agent of many)."""
        for a, g in enumerate(getattr(self, "generators", ())):
            g.manual_seed(int(np.random.SeedSequence(
                [int(seed), 0, int(first_agent) + a]).generate_state(1)[0]))

    def set_dropout(self, enabled: bool) -> None:
        for m in self.modules():
            if isinstance(m, Dropout):
                m.enabled = bool(enabled)

    def param_count(self) -> int:
        """Parameters of ONE agent."""
        return self.flat_params.shape[1]
