"""Agent-stacked top-k mixture-of-experts MLP (port of
``distributed_learning_tpu/models/moe.py``).

Routing follows the reference (``moe.py:134-256``): a float32 softmax
router; top-k by repeated argmax with the earlier choices masked out;
top-1 keeps the raw router probability as its combine weight, top-2
renormalises the chosen gates to sum to one; each expert takes at most
``C = ceil(S / E * capacity_factor)`` of an agent's ``S`` tokens, a later
choice queueing behind every earlier one (GShard's priority), and the
overflow is dropped (its MoE output is zero); the expert MLPs run in
float32.  The load-balance auxiliary ``E * sum_e f_e * P_e``
(arXiv:2101.03961 eq. 4: ``f_e`` the fraction of tokens first-routed to
expert ``e``, ``P_e`` the mean router probability) and the dropped
fraction are kept on the module after each forward, per agent, until
:func:`collect_load_balance_loss` takes the aux.

The reference writes dispatch and combine as einsums against one-hot
``(S, E, C)`` float32 tensors, which XLA partitions.  Here a token's slot
comes from a ``cumsum`` over its expert's one-hot column, and the tokens
move by index: a gather into an ``(E, C, d)`` buffer per agent, and a
gather of each choice's expert output back.  Nothing reads a device value
on the host and every shape is static, so a step with MoE blocks captures
in a CUDA graph.  Each slot holds at most one token, so the backward's
scatter-adds into a token sum at most ``top_k`` terms and, for
``top_k <= 2``, the same in any order.

The drop-free path (``drop_tokens=False``, ``_dense_dropfree`` in the
reference) runs every expert on every token and combines with the top-k
gate weights; decode uses it, since capacity drops depend on the other
tokens in the batch.

Parameters are float32 masters like every parameter of the port (the
reference declares the expert kernels in ``dtype``); the gate is
computed in the model's ``dtype``, as flax's ``nn.Dense(dtype=...)``
does.  Expert sharding (``shard_moe_params``, ``moe_param_spec``) waits
for the sharded engine (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models._stacked import dense

__all__ = ["MoEMLP", "collect_load_balance_loss", "moe_param_spec", "shard_moe_params"]

_EXPERT_SHARDING = ('expert sharding has no port yet: ROADMAP.md item "5. tp / pp / fsdp" '
                    '(with the model\'s manual expert-parallel mode, the reference\'s '
                    'moe_param_spec and shard_moe_params, models/moe.py:310-329)')


def moe_param_spec(path, leaf, expert_axis: str = "expert"):
    """The reference's per-leaf expert placement; not ported yet (every
    agent of the port holds all its experts), so it raises."""
    raise ValueError(_EXPERT_SHARDING)


def shard_moe_params(params, mesh, expert_axis: str = "expert"):
    """The reference's expert-sharded placement of an MoE parameter tree;
    not ported yet, so it raises."""
    raise ValueError(_EXPERT_SHARDING)


def collect_load_balance_loss(model: nn.Module) -> Optional[torch.Tensor]:
    """Mean over the model's MoE blocks of their last forward's (N,)
    load-balance loss, or ``None`` for a model without MoE blocks (the
    Switch convention: one coefficient whatever the depth).

    Collecting takes the values from the blocks (their ``aux`` is
    ``None`` after it), as the reference's step builders take the sown
    ``moe_stats`` from ``apply``: a block that kept its aux would keep the
    forward's autograd graph alive, and with it the parameters' gradient
    accumulators, which then run on the stream of the forward that made
    them (a CUDA-graph capture on another stream cannot wait on that)."""
    blocks = [m for m in model.modules() if isinstance(m, MoEMLP)]
    if not blocks:
        return None
    aux = [m.aux for m in blocks]
    for m in blocks:
        m.aux = None
    total = aux[0]
    for a in aux[1:]:
        total = total + a
    return total / len(aux)


class MoEMLP(nn.Module):
    """Top-k MoE feed-forward for ``n`` stacked agents: per agent a gate
    ``(d, E)``, expert kernels ``w_up (E, d, h)``, ``w_dn (E, h, d)`` and
    biases ``b_up (E, h)``, ``b_dn (E, d)``, ``h = mlp_ratio * d``.

    Parameters live on ``device`` (the card unless ``"cpu"`` is asked
    for; a ``TransformerLM`` builds its blocks on the CPU and moves them
    into its own flat buffer).  ``forward(x, drop_tokens=True)`` takes
    (N, B, T, d) and returns the same shape and dtype; it sets ``aux``
    (N,) and ``dropped_fraction`` (N,), the share of (token, choice)
    pairs that found no slot (0 on the drop-free path)."""

    def __init__(self, n: int, d: int, num_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, top_k: int = 1, *, device=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} not in [1, {num_experts}]")
        E, h = int(num_experts), int(mlp_ratio) * d
        self.num_experts, self.top_k = E, int(top_k)
        self.capacity_factor = float(capacity_factor)
        dev = resolve_device(device)
        self.gate = nn.Parameter(torch.zeros(n, d, E, device=dev))
        self.w_up = nn.Parameter(torch.zeros(n, E, d, h, device=dev))
        self.b_up = nn.Parameter(torch.zeros(n, E, h, device=dev))
        self.w_dn = nn.Parameter(torch.zeros(n, E, h, d, device=dev))
        self.b_dn = nn.Parameter(torch.zeros(n, E, d, device=dev))
        self.aux: Optional[torch.Tensor] = None
        self.dropped_fraction: Optional[torch.Tensor] = None

    def capacity(self, tokens: int) -> int:
        """Slots per expert for ``tokens`` tokens of one agent."""
        return max(1, math.ceil(tokens / self.num_experts * self.capacity_factor))

    def _choose(self, probs: torch.Tensor):
        """The top-k experts of every token, k of (N, S): each the first
        maximum (as ``jnp.argmax``) with the earlier choices masked out."""
        masked, choices = probs.detach(), []
        for _ in range(self.top_k):
            e = masked.argmax(dim=-1, keepdim=True)
            choices.append(e.squeeze(-1))
            masked = masked.scatter(-1, e, 0.0)
        return choices

    def _route(self, tokens: torch.Tensor):
        """``(probs, choices, gates)``: the float32 router probabilities
        (N, S, E), the top-k experts (k of (N, S)) and their combine
        weights (k of (N, S) float32)."""
        probs = torch.softmax(dense(tokens, self.gate, None, tokens.dtype).float(), dim=-1)
        choices = self._choose(probs)
        gates = [probs.gather(-1, e[..., None]).squeeze(-1) for e in choices]
        if self.top_k > 1:
            gsum = gates[0]
            for g in gates[1:]:
                gsum = gsum + g
            gsum = gsum.clamp_min(1e-9)
            gates = [g / gsum for g in gates]
        return probs, choices, gates

    def forward(self, x: torch.Tensor, drop_tokens: bool = True) -> torch.Tensor:
        N, B, T, d = x.shape
        E = self.num_experts
        S = B * T
        tokens = x.reshape(N, S, d)
        probs, choices, gates = self._route(tokens)
        experts = torch.arange(E, device=x.device)
        first = (choices[0][..., None] == experts).to(torch.float32)  # (N, S, E)
        self.aux = E * (first.mean(dim=1) * probs.mean(dim=1)).sum(dim=-1)
        if drop_tokens:
            out = self._dispatch(tokens, choices, gates, experts)
        else:
            out = self._dense_dropfree(tokens, choices, gates, experts)
        return out.reshape(N, B, T, d).to(x.dtype)

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """The expert MLPs in float32 on ``buf`` (N*E, C, d)."""
        N, E = self.w_up.shape[:2]
        act = torch.bmm(buf, self.w_up.reshape(N * E, *self.w_up.shape[2:]))
        act = F.gelu(act + self.b_up.reshape(N * E, 1, -1), approximate="tanh")
        out = torch.bmm(act, self.w_dn.reshape(N * E, *self.w_dn.shape[2:]))
        return out + self.b_dn.reshape(N * E, 1, -1)

    def _dispatch(self, tokens, choices, gates, experts):
        N, S, d = tokens.shape
        E, k = self.num_experts, self.top_k
        C = self.capacity(S)
        agent = torch.arange(N, device=tokens.device)[:, None]
        token_ids = torch.arange(S, device=tokens.device).expand(N, S)
        # Which token each slot holds (S: none, a zero row); choice j's
        # dropped tokens write into overflow slots of their own, past E*C.
        slot_token = torch.full((N, E * C + k * S), S, dtype=torch.long, device=tokens.device)
        occupancy = torch.zeros(N, E, dtype=torch.long, device=tokens.device)
        slots, kept = [], []
        for j, e in enumerate(choices):
            onehot = (e[..., None] == experts).to(torch.long)     # (N, S, E)
            ahead = (onehot.cumsum(dim=1) - onehot).gather(-1, e[..., None]).squeeze(-1)
            pos = ahead + occupancy.gather(-1, e)                 # queue behind earlier choices
            keep = pos < C
            slot = torch.where(keep, e * C + pos, E * C + j * S + token_ids)
            slot_token.scatter_(1, slot, token_ids)
            occupancy = occupancy + onehot.sum(dim=1)
            slots.append(torch.where(keep, slot, E * C))          # E*C: a zero row below
            kept.append(keep)
        padded = torch.cat([tokens.float(), tokens.new_zeros(N, 1, d, dtype=torch.float32)], 1)
        buf = padded[agent, slot_token[:, :E * C]].reshape(N * E, C, d)
        out_e = self._experts(buf).reshape(N, E * C, d)
        out_e = torch.cat([out_e, out_e.new_zeros(N, 1, d)], 1)
        out = None
        for g, keep, slot in zip(gates, kept, slots):
            term = (g * keep)[..., None] * out_e[agent, slot]
            out = term if out is None else out + term
        n_kept = kept[0].sum(dim=1)
        for keep in kept[1:]:
            n_kept = n_kept + keep.sum(dim=1)
        self.dropped_fraction = 1.0 - n_kept.to(torch.float32) / (S * k)
        return out

    def _dense_dropfree(self, tokens, choices, gates, experts):
        N, S, d = tokens.shape
        xt = tokens.float()
        act = torch.einsum("nsd,nedh->nseh", xt, self.w_up) + self.b_up[:, None]
        act = F.gelu(act, approximate="tanh")
        out_e = torch.einsum("nseh,nehd->nsed", act, self.w_dn) + self.b_dn[:, None]
        weight = None
        for g, e in zip(gates, choices):
            term = g[..., None] * (e[..., None] == experts).to(torch.float32)
            weight = term if weight is None else weight + term
        self.dropped_fraction = torch.zeros(N, device=tokens.device)
        return torch.einsum("nse,nsed->nsd", weight, out_e)
