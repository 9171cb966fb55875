"""Gossip x FSDP and gossip x tensor parallelism (port of
``distributed_learning_tpu/training/gossip_fsdp.py``).

An ``(agents, data)`` or ``(agents, model)``
:class:`~distributed_learning_tpu_torch.parallel.multihost.GridMesh`:
each row of ranks holds one gossip agent, its replica split over the
row's ranks by ``training/fsdp.py``'s largest-divisible-dimension rule or
by the megatron rules of ``training/tp.py``.  One step runs the row's
ZeRO-3 or tensor-parallel step (each agent with its own optimizer), then
one synchronous gossip round: every rank gathers its block from the
ranks that hold the same block of the other agents (one ``all_gather``
along ``agents``) and takes ``W[a] @ gathered`` in the leaf's dtype
(float32), the reference's ``einsum("ab,b...->a...", W, x)``
(``gossip_fsdp.py:122-125``).  Mixing commutes with the row's split, so
no block is resharded.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from distributed_learning_tpu_torch.parallel.multihost import (
    PartitionSpec as P,
    local_shard,
    tree_map_with_path,
)
from distributed_learning_tpu_torch.training.fsdp import (
    fsdp_spec,
    make_fsdp_train_step,
    reject_dropout_model,
)

__all__ = ["make_gossip_fsdp_step", "shard_stacked_fsdp", "make_gossip_tp_step",
           "shard_stacked_tp"]


def _meta(shape) -> torch.Tensor:
    return torch.empty(tuple(shape), device="meta")


def _stacked_spec(leaf, n_data: int, agents_axis: str, data_axis: str) -> P:
    """One stacked (N, ...) leaf: agents on dim 0, the largest divisible
    remaining dimension on ``data_axis``."""
    return P(agents_axis, *fsdp_spec(_meta(leaf.shape[1:]), n_data, data_axis))


def shard_stacked_fsdp(tree: Any, mesh, agents_axis: str = "agents",
                       data_axis: str = "data") -> Any:
    """This rank's (1, ...) block of every stacked per-agent leaf: its
    agent's row, split over ``data_axis``."""
    n = mesh.shape[data_axis]
    return tree_map_with_path(
        lambda _p, a: local_shard(a, _stacked_spec(a, n, agents_axis, data_axis), mesh), tree)


def _stacked_megatron_spec(path, leaf, mesh, agents_axis: str, model_axis: str) -> P:
    """One stacked (N, ...) leaf: agents on dim 0, the megatron rules
    (with the divisibility fallback) on the rest."""
    from distributed_learning_tpu_torch.training.tp import (
        divisible_or_replicated,
        transformer_tp_rules,
    )

    inner_leaf = _meta(leaf.shape[1:])
    inner = transformer_tp_rules(path, inner_leaf, model_axis)
    inner = divisible_or_replicated(inner, inner_leaf, mesh, model_axis)
    return P(agents_axis, *inner)


def shard_stacked_tp(params: Any, mesh, agents_axis: str = "agents",
                     model_axis: str = "model") -> Any:
    """This rank's (1, ...) block of every stacked per-agent leaf of a
    TransformerLM tree (flax paths): its agent's row under the megatron
    rules."""
    return tree_map_with_path(
        lambda path, a: local_shard(
            a, _stacked_megatron_spec(path, a, mesh, agents_axis, model_axis), mesh),
        params)


def _gossip(mesh, mixing_matrix, agents_axis: str):
    """``mix_(flat)``: one round on this rank's (1, P) block, in place;
    and the agents' line."""
    agents = mesh[agents_axis]
    N = agents.size
    W = torch.as_tensor(np.asarray(mixing_matrix), dtype=torch.float32)
    if tuple(W.shape) != (N, N):
        raise ValueError(f"mixing matrix {tuple(W.shape)} != ({N}, {N}) mesh agents")
    row = W[agents.agent:agents.agent + 1]

    @torch.no_grad()
    def mix_(flat: torch.Tensor) -> None:
        gathered = agents.all_gather(flat[0])                        # (N, P)
        flat.copy_(row.to(device=flat.device, dtype=flat.dtype) @ gathered)

    return mix_, agents


def _agent_batch(x: torch.Tensor, agents) -> torch.Tensor:
    if x.shape[0] != agents.size:
        raise ValueError(f"batch carries {x.shape[0]} agents, the mesh {agents.size}")
    return x[agents.agent]


def make_gossip_fsdp_step(mesh, model, tx, mixing_matrix, *, agents_axis: str = "agents",
                          data_axis: str = "data",
                          moe_aux_coef: float = 0.01) -> Callable[..., torch.Tensor]:
    """``step(x, y) -> mean loss`` on an ``(agents, data)`` grid: ``model``
    is this rank's one-replica TransformerLM at its agent's init (the
    step keeps its ``data`` block, as :func:`make_fsdp_train_step`
    does), ``tx`` an optimizer factory (each agent its own moments),
    ``mixing_matrix`` the (N, N) gossip matrix.  ``x`` / ``y`` are the
    ``(N, B, T)`` token batches, one per agent, B divisible by the data
    axis.  One round applies per step, after the optimizer's update; the
    loss is the mean over the agents of each agent's global mean."""
    reject_dropout_model(model)
    mix_, agents = _gossip(mesh, mixing_matrix, agents_axis)
    inner = make_fsdp_train_step(mesh, model, tx, data_axis=data_axis, moe_aux_coef=moe_aux_coef)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = inner(_agent_batch(x, agents), _agent_batch(y, agents))
        mix_(inner.flat)
        return agents.all_reduce(loss.reshape(1).clone(), "sum")[0] / agents.size

    step.inner, step.mix_ = inner, mix_
    return step


def make_gossip_tp_step(mesh, model, tx, mixing_matrix, *, agents_axis: str = "agents",
                        model_axis: str = "model",
                        moe_aux_coef: float = 0.01) -> Callable[..., torch.Tensor]:
    """Gossip x tensor parallelism on an ``(agents, model)`` grid: the
    contract of :func:`make_gossip_fsdp_step` with this rank's ``model`` a
    ``TransformerLM(tp_axis=model_axis, mesh=mesh)`` holding its agent's
    blocks; every rank of a row takes its agent's whole batch."""
    from distributed_learning_tpu_torch.training.tp import build_tp_step

    reject_dropout_model(model)
    mix_, agents = _gossip(mesh, mixing_matrix, agents_axis)
    inner = build_tp_step(mesh, model, tx, data_axis=None, model_axis=model_axis,
                          moe_aux_coef=moe_aux_coef)

    def step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = inner(_agent_batch(x, agents), _agent_batch(y, agents))
        mix_(model.flat_params)
        return agents.all_reduce(loss.reshape(1).clone(), "sum")[0] / agents.size

    step.inner, step.mix_ = inner, mix_
    return step
