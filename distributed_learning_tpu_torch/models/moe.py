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
does.

Expert parallelism (the reference's manual ``expert_axis`` mode,
``moe.py:110-131``): with ``expert_mesh`` (an ``AgentMesh`` of the expert
axis) the module holds the ``E/n`` experts of its rank, routes against
the global expert set from the replicated gate, runs its experts on the
(replicated) tokens, keeps its experts' columns of the dispatch and the
combine weights, and combines with one ``all_reduce`` over the axis.  The
tokens and the combine weights enter the experts' region through
Megatron's f (their gradient summed over the axis), so the routing and
its load-balance term stay replicated.  :func:`moe_param_spec` and
:func:`shard_moe_params` place the stacked expert kernels over the axis.
With ``batch_mesh`` (the axis a step splits the batch over) the module
routes the batch gathered over it and keeps its own rows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models._stacked import dense
from distributed_learning_tpu_torch.parallel.multihost import (
    PartitionSpec,
    copy_to_axis,
    gather_along_axis,
    local_shard,
    path_names,
    reduce_from_axis,
    tree_map_with_path,
)

__all__ = ["MoEMLP", "collect_load_balance_loss", "moe_param_spec", "shard_moe_params"]


def moe_param_spec(path, leaf, expert_axis: str = "expert") -> PartitionSpec:
    """Stacked expert kernels and biases split their leading expert axis
    over ``expert_axis``; the gate and everything else stay whole
    (``moe.py:310``)."""
    names = path_names(path)
    if names and names[-1] in ("w_up", "b_up", "w_dn", "b_dn"):
        return PartitionSpec(expert_axis, *([None] * (len(leaf.shape) - 1)))
    return PartitionSpec()


def shard_moe_params(params, mesh, expert_axis: str = "expert"):
    """This rank's block of every leaf of an MoE-bearing parameter tree
    (nested mappings, or ``{dotted name: array}``) under
    :func:`moe_param_spec` on ``mesh`` (``moe.py:319``)."""
    return tree_map_with_path(
        lambda path, leaf: local_shard(leaf, moe_param_spec(path, leaf, expert_axis), mesh),
        params)


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
                 capacity_factor: float = 1.25, top_k: int = 1, *, device=None,
                 expert_mesh=None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} not in [1, {num_experts}]")
        E, h = int(num_experts), int(mlp_ratio) * d
        self.num_experts, self.top_k = E, int(top_k)
        self.capacity_factor = float(capacity_factor)
        E_loc = E
        if expert_mesh is not None:
            if E % expert_mesh.size:
                raise ValueError(f"num_experts {E} must be divisible by the "
                                 f"{expert_mesh.axis_name!r} axis size {expert_mesh.size}")
            E_loc = E // expert_mesh.size
        dev = resolve_device(device)
        self.gate = nn.Parameter(torch.zeros(n, d, E, device=dev))
        self.w_up = nn.Parameter(torch.zeros(n, E_loc, d, h, device=dev))
        self.b_up = nn.Parameter(torch.zeros(n, E_loc, h, device=dev))
        self.w_dn = nn.Parameter(torch.zeros(n, E_loc, h, d, device=dev))
        self.b_dn = nn.Parameter(torch.zeros(n, E_loc, d, device=dev))
        self.aux: Optional[torch.Tensor] = None
        self.dropped_fraction: Optional[torch.Tensor] = None
        # The axis the batch is split over, and the expert axis (this
        # rank's experts are E_loc = w_up.shape[1] from agent * E_loc).
        self.batch_mesh = None
        self.ep = expert_mesh

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

    def _local_experts(self):
        """``(E_loc, e0)``: how many experts this rank holds and the first
        one's global index."""
        E_loc = self.w_up.shape[1]
        return E_loc, (self.ep.agent * E_loc if self.ep is not None else 0)

    def forward(self, x: torch.Tensor, drop_tokens: bool = True) -> torch.Tensor:
        rows = None
        bm = self.batch_mesh
        if bm is not None and bm.size > 1:
            # Route the global batch, as the reference's partitioner does.
            rows = slice(bm.agent * x.shape[1], (bm.agent + 1) * x.shape[1])
            x = gather_along_axis(x, bm, 1)
        N, B, T, d = x.shape
        E = self.num_experts
        S = B * T
        tokens = x.reshape(N, S, d)
        probs, choices, gates = self._route(tokens)
        experts = torch.arange(E, device=x.device)
        first = (choices[0][..., None] == experts).to(torch.float32)  # (N, S, E)
        self.aux = E * (first.mean(dim=1) * probs.mean(dim=1)).sum(dim=-1)
        if self.ep is not None:
            # Enter the experts' region: each rank's experts see the same
            # tokens and gates, whose gradients are summed over the axis.
            tokens = copy_to_axis(tokens, self.ep)
            gates = list(copy_to_axis(torch.stack(gates), self.ep).unbind(0))
        if drop_tokens:
            out = self._dispatch(tokens, choices, gates, experts)
        else:
            out = self._dense_dropfree(tokens, choices, gates, experts)
        if self.ep is not None:
            out = reduce_from_axis(out, self.ep)
        out = out.reshape(N, B, T, d).to(x.dtype)
        return out if rows is None else out[:, rows]

    def _experts(self, buf: torch.Tensor) -> torch.Tensor:
        """The expert MLPs in float32 on ``buf`` (N*E_loc, C, d)."""
        N, E = self.w_up.shape[:2]
        act = torch.bmm(buf, self.w_up.reshape(N * E, *self.w_up.shape[2:]))
        act = F.gelu(act + self.b_up.reshape(N * E, 1, -1), approximate="tanh")
        out = torch.bmm(act, self.w_dn.reshape(N * E, *self.w_dn.shape[2:]))
        return out + self.b_dn.reshape(N * E, 1, -1)

    def _dispatch(self, tokens, choices, gates, experts):
        N, S, d = tokens.shape
        E, k = self.num_experts, self.top_k
        E_loc, e0 = self._local_experts()
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
        # This rank's experts' slots (all of them without an expert axis).
        buf = padded[agent, slot_token[:, e0 * C:(e0 + E_loc) * C]].reshape(N * E_loc, C, d)
        out_e = self._experts(buf).reshape(N, E_loc * C, d)
        out_e = torch.cat([out_e, out_e.new_zeros(N, 1, d)], 1)
        out = None
        for g, keep, slot, e in zip(gates, kept, slots, choices):
            if E_loc != E:
                keep = keep & (e >= e0) & (e < e0 + E_loc)
                slot = torch.where(keep, slot - e0 * C, E_loc * C)
            term = (g * keep)[..., None] * out_e[agent, slot]
            out = term if out is None else out + term
        n_kept = kept[0].sum(dim=1)  # global: every expert's kept tokens
        for keep in kept[1:]:
            n_kept = n_kept + keep.sum(dim=1)
        self.dropped_fraction = 1.0 - n_kept.to(torch.float32) / (S * k)
        return out

    def _dense_dropfree(self, tokens, choices, gates, experts):
        N, S, d = tokens.shape
        E_loc, e0 = self._local_experts()
        xt = tokens.float()
        act = torch.einsum("nsd,nedh->nseh", xt, self.w_up) + self.b_up[:, None]
        act = F.gelu(act, approximate="tanh")
        out_e = torch.einsum("nseh,nehd->nsed", act, self.w_dn) + self.b_dn[:, None]
        weight = None
        for g, e in zip(gates, choices):
            term = g[..., None] * (e[..., None] == experts).to(torch.float32)
            weight = term if weight is None else weight + term
        # (N, S, E) over the global experts: this rank's columns.
        weight = weight[..., e0:e0 + E_loc]
        self.dropped_fraction = torch.zeros(N, device=tokens.device)
        return torch.einsum("nse,nsed->nsd", weight, out_e)
