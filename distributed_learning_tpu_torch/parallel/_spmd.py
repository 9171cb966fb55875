"""Shared plumbing of the iterative decentralized-optimizer engines
(gradient tracking, EXTRA), dense and sharded (port of
``distributed_learning_tpu/parallel/_spmd.py``).

A state tree is an ``(n, ...)`` tensor or a ``{name: (n, ...)}`` dict of
them, the agents stacked on the leading axis on one device; on a mesh
(the engine's ``mesh``, one agent a rank) it is this rank's agent as a
stack of one.  Three contracts live here, once:

* the gradient oracle comes in two forms.  The reference's per-agent
  oracle ``grad_fn(x_i, agent_idx, step)`` is ``jax.vmap``-ed there; here
  it is looped over the agents, or on a mesh called once with this
  rank's agent index (``torch.func.vmap`` cannot batch the
  hand-written kernels' ``autograd.Function``s).  A *stacked* oracle
  ``grad_fn(x, step)`` returns all n agents' gradients at once — what one
  forward/backward of an agent-stacked model (``models/_stacked.py``)
  computes — and is selected with ``stacked_grads=True``;
* one gossip round is one float32 ``W @ X`` GEMM per tensor
  (:func:`ops.dense_mix`, TF32 off), or on a mesh the consensus engine's
  matching exchanges with this rank's weights
  (``ConsensusEngine._local_mix_once``);
* the per-step consensus residual is the max agent deviation (on a mesh
  an ``all_reduce(MAX)`` of each rank's), written into a preallocated
  ``(steps,)`` device tensor, so a dense run reads nothing back to the
  host (the reference keeps it on the device by running the whole run as
  one ``lax.scan``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple, TypeVar, Union

import torch

from distributed_learning_tpu_torch.ops import mixing as ops

__all__ = ["Tree", "tree_map", "own", "per_agent_grads", "mix_once", "residual", "run_steps",
           "place", "agent_sum"]

Tree = Union[torch.Tensor, Dict[str, torch.Tensor]]
S = TypeVar("S")


def tree_map(fn: Callable[..., torch.Tensor], *trees: Tree) -> Tree:
    """``fn`` applied tensor by tensor over trees of one structure."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def leaves(tree: Tree) -> List[torch.Tensor]:
    return list(tree.values()) if isinstance(tree, dict) else [tree]


def _as_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    return tree if isinstance(tree, dict) else {"": tree}


def own(tree: Tree, device) -> Tree:
    """A copy of ``tree`` on ``device`` that an engine may keep."""
    return tree_map(lambda v: torch.as_tensor(v).to(device=device, copy=True), tree)


def per_agent_grads(engine, grad_fn: Callable, x: Tree, step: int, *,
                    stacked: bool = False) -> Tree:
    """Stacked per-agent gradients at ``x``: ``grad_fn(x, step)`` for a
    stacked oracle, copied (the engine keeps them, and the oracle may
    return a buffer it reuses, such as a model's ``flat_grads``); else
    ``grad_fn(x_i, i, step)`` for each agent ``i``, stacked on the
    leading axis (on a mesh once, with this rank's agent index)."""
    if stacked:
        return own(grad_fn(x, step), engine.device)
    mesh = engine.engine.mesh
    if mesh is not None:
        return ops.stack_trees([grad_fn(tree_map(lambda v: v[0], x), mesh.agent, step)])
    per = [grad_fn(xi, i, step) for i, xi in enumerate(ops.unstack_tree(x, engine.n))]
    return ops.stack_trees(per)


def mix_once(engine, t: Tree) -> Tree:
    """One gossip round ``W @ t`` in float32 (on a mesh the matching
    exchanges) into fresh tensors of ``t``'s dtypes."""
    out = tree_map(lambda v: torch.empty_like(v, memory_format=torch.contiguous_format), t)
    if engine.mesh is not None:
        engine._local_mix_once(_as_dict(t), _as_dict(out))
    else:
        ops.dense_mix(_as_dict(t), engine._W_dev, out=_as_dict(out))
    return out


def residual(x: Tree, engine=None) -> torch.Tensor:
    """Max agent deviation of ``x`` (a 0-dim device tensor); with a
    sharded consensus ``engine`` the ``all_reduce(MAX)`` over its ranks."""
    if engine is not None and engine.mesh is not None:
        return engine._local_residual(_as_dict(x))
    return ops.max_deviation(_as_dict(x))


def run_steps(engine, state: S, steps: int, step_fn: Callable[[S], S]) -> Tuple[S, torch.Tensor]:
    """``steps`` iterations of ``step_fn``; returns the final state and
    the ``(steps,)`` float32 residual trace of ``state.x``, written on the
    device step by step (no host read on the dense route)."""
    trace = torch.empty(int(steps), dtype=torch.float32, device=engine.device)
    for t in range(int(steps)):
        state = step_fn(state)
        trace[t] = residual(state.x, engine.engine)
    return state, trace


def place(engine, x0: Tree) -> Tree:
    """The engine's copy of an initial state: on a mesh this rank's agent
    of the stacked ``x0`` (a stack of one), else all of it."""
    if engine.engine.mesh is not None:
        return engine.engine.shard(x0)
    return own(x0, engine.device)


def agent_sum(engine, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the agent axis: on a mesh the local stack's
    sum, all-reduced over the ranks."""
    total = t.sum(dim=0)
    mesh = engine.engine.mesh
    return total if mesh is None else mesh.all_reduce(total.contiguous(), "sum")
