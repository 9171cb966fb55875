"""Gossip-average existing ``torch.nn.Module`` replicas in place (port of
``distributed_learning_tpu/interop.py``).

Migration path for users of the reference, whose models are all torch
(``utils/consensus_simple/mixer.py`` flattens their parameters to numpy
and mixes with a dense loop on the host).  :class:`TorchModelMixer` keeps
their models and training loops untouched.  The reference's version takes
each replica through numpy and gossips it in JAX; this one gossips the
replicas on their own device: each mix gathers every replica's
``named_parameters()`` into fused ``(N, P)`` buffers (one per parameter
dtype, owned by a :class:`~.parallel.consensus.Mixer`), runs the
:class:`~.parallel.consensus.ConsensusEngine` rounds there, and writes
the result back with ``copy_`` under ``torch.no_grad()``.  Parameters
keep their identity, so optimizer state keyed by parameter (momentum
buffers) survives a mix.

Only the *parameters* are averaged; buffers (BatchNorm running
statistics, ``num_batches_tracked``) stay per agent.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Mapping, Optional, Sequence

import torch

from distributed_learning_tpu_torch.parallel.consensus import Mixer

__all__ = ["TorchModelMixer"]


class TorchModelMixer:
    """Gossip-average the parameters of N torch model replicas.

    Parameters
    ----------
    models:
        ``{token: torch.nn.Module}``, replicas of one architecture, all on
        one device (which the mixing runs on; replicas on different
        devices raise).
    topology:
        The reference's ``{agent: {neighbor: weight}}`` dict or an (n, n)
        mixing matrix.
    tokens / logger / max_rounds:
        Forwarded to the :class:`~.parallel.consensus.Mixer` that owns the
        fused buffers.

    ``mix(times, eps)`` has the reference ``Mixer.mix`` contract: run
    ``times`` rounds, or with ``eps`` keep going until the max
    across-agent deviation drops below it; it returns the rounds run.
    """

    def __init__(self, models: Mapping[Hashable, torch.nn.Module], topology, *,
                 tokens: Optional[Sequence[Hashable]] = None, logger=None,
                 max_rounds: int = 10_000):
        self.models = dict(models)
        if not self.models:
            raise ValueError("models must be a non-empty mapping")
        first = next(iter(self.models.values()))
        sig = [(n, tuple(p.shape)) for n, p in first.named_parameters()]
        for tok, m in self.models.items():
            have = [(n, tuple(p.shape)) for n, p in m.named_parameters()]
            if have != sig:
                diff = [f"{a[0]}{a[1]} vs {b[0]}{b[1]}" for a, b in zip(sig, have) if a != b
                        ] or [f"{len(sig)} vs {len(have)} parameters"]
                raise ValueError(
                    f"model {tok!r} parameters differ from the first replica "
                    f"({'; '.join(diff[:3])}) — are these the same architecture?")
        devices = {p.device for m in self.models.values() for p in m.parameters()}
        if len(devices) != 1:
            raise ValueError(f"replicas live on several devices {sorted(map(str, devices))}; "
                             "move them to one device first")
        self._mixer = Mixer(
            {tok: {n: p.detach() for n, p in m.named_parameters()}
             for tok, m in self.models.items()},
            topology, tokens=tokens, device=devices.pop(), logger=logger, max_rounds=max_rounds)
        self.tokens = self._mixer.tokens
        self.engine = self._mixer.engine
        # Per replica: each parameter and its view into the fused buffers.
        buffers, layout = self._mixer.fused_state()
        self._views: List[List[tuple]] = []
        for a, tok in enumerate(self.tokens):
            params = dict(self.models[tok].named_parameters())
            self._views.append([
                (params[s.name], buffers[s.bucket][a, s.offset: s.offset + s.size])
                for s in layout.slots])

    def _gather(self) -> None:
        """Copy the live parameters into the buffers: the user trains
        between mixes, so every operation starts from the models."""
        with torch.no_grad():
            for views in self._views:
                for p, row in views:
                    row.copy_(p.reshape(-1))

    def _scatter(self) -> None:
        with torch.no_grad():
            for views in self._views:
                for p, row in views:
                    p.copy_(row.view(p.shape))

    def mix(self, times: int = 1, eps: Optional[float] = None) -> int:
        """Gather the current parameters, gossip on their device, write
        them back in place; returns the rounds run."""
        self._gather()
        done = self._mixer.mix(times, eps)
        self._scatter()
        return done

    def get_parameters_deviation(self) -> Dict[Hashable, float]:
        """Across-agent L2 deviation of the *current* parameters."""
        self._gather()
        return self._mixer.get_parameters_deviation()

    def get_max_parameters_std(self) -> float:
        """Max across-agent std (population) of the current parameters."""
        self._gather()
        return self._mixer.get_max_parameters_std()
