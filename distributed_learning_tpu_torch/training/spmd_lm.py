"""Agents x sequence-parallel LM training on ``torch.distributed`` (port
of ``distributed_learning_tpu/training/spmd_lm.py``).

The mesh has two axes (:class:`~distributed_learning_tpu_torch.parallel.
multihost.GridMesh`, ``{"agents": A, "seq": S}``): each row of ranks is
one gossip agent, its replica held whole on every rank of the row and
its token batch split along the sequence across the row.  One step
(:func:`make_gossip_lm_step`) does

1. the forward and backward with a sequence-parallel attention
   (``TransformerLM(attn_impl="ring" | "ring_flash" | "ulysses",
   mesh=grid)``), the K/V blocks rotating along ``seq``;
2. the loss and the gradient summed over ``seq`` (the loss normalised by
   the global token count, so the sum is the gradient of the global
   mean; one ``all_reduce`` of the flat gradient buffer), the MoE
   load-balance term divided by the ``seq`` size;
3. the optimizer's update (the port's ``Adam`` or any optimizer over the
   model's flat parameter buffer), the same on every rank of a row;
4. one Metropolis round on the agents ring, ``x <- (1 - 2w) x + w left +
   w right`` with ``w = self_weight or 1/3``: one exchange with both
   ring neighbours along ``agents``.

Each rank holds its agent's replica as an ``n_agents=1`` model;
:func:`stack_agent_states` gives it the shared (broadcast) init and its
optimizer, the reference's stacked parameters and ``vmap``-ped optimizer
state.  Targets arrive shifted by the caller: the shift crosses block
boundaries, so it happens on the global sequence.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
import torch.nn.functional as F

from distributed_learning_tpu_torch.models.moe import collect_load_balance_loss
from distributed_learning_tpu_torch.training.fsdp import reject_dropout_model

__all__ = ["make_gossip_lm_step", "reject_dropout_model", "stack_agent_states"]


def stack_agent_states(model, tx: Callable[[torch.Tensor], torch.optim.Optimizer], *,
                       seed: int = 0, params: Optional[Mapping[str, Any]] = None,
                       agent: int = 0) -> torch.optim.Optimizer:
    """This rank's replica at the shared init, and its optimizer: the
    model's parameters from ``seed`` (every rank draws the same) or, with
    ``params`` (``{name: (n_agents, ...)}`` stacked), agent ``agent``'s
    row; returns ``tx(model.flat_params)`` with the gradient buffer bound
    (``tx`` is a factory such as the trainer's ``make_optimizer``
    gives)."""
    if params is None:
        model.reset_parameters(seed)
    else:
        model.load_stacked({k: torch.as_tensor(v)[agent:agent + 1] for k, v in params.items()})
    model.flat_grads.zero_()
    model.flat_params.grad = model.flat_grads
    return tx(model.flat_params)


def make_gossip_lm_step(mesh, model, optimizer: torch.optim.Optimizer, *,
                        agents_axis: str = "agents", seq_axis: str = "seq",
                        self_weight: Optional[float] = None,
                        moe_aux_coef: float = 0.01) -> Callable[..., torch.Tensor]:
    """Build the step on ``mesh`` (a ``GridMesh`` with ``agents_axis`` and
    ``seq_axis``) for this rank's ``model`` (an ``n_agents=1``
    ``TransformerLM`` with a sequence-parallel ``attn_impl`` on the same
    mesh) and its ``optimizer``.

    Returns ``step(x_tok, y_tok) -> loss``: ``x_tok`` and ``y_tok`` are
    this rank's ``(B, T/S)`` token and (pre-shifted) target block of its
    agent's batch; the model's parameters and the optimizer's state are
    updated in place, and ``loss`` (a 0-dim float32 tensor, the same on
    every rank) is the mean over the agents of each agent's global
    per-token loss, as the reference's step returns."""
    reject_dropout_model(model)
    agents, seq = mesh[agents_axis], mesh[seq_axis]
    if getattr(model, "seq_mesh", None) is not seq:
        raise ValueError(f"model's sequence-parallel attention must run on the mesh's "
                         f"{seq_axis!r} axis (TransformerLM(attn_impl=..., mesh=mesh))")
    w = float(self_weight) if self_weight is not None else 1.0 / 3.0
    n, a = agents.size, agents.agent
    nxt, prv = (a + 1) % n, (a - 1) % n
    flat, grads = model.flat_params, model.flat_grads

    def step(x_tok: torch.Tensor, y_tok: torch.Tensor) -> torch.Tensor:
        x, y = x_tok.to(flat.device), y_tok.to(flat.device)
        grads.zero_()
        logits = model(x[None])[0]                                   # (B, T/S, V)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1).long(),
                             reduction="sum")
        # Normalised by the GLOBAL token count: the sum over seq is then the
        # gradient of the agent's global mean.
        loss = ce / (y.numel() * seq.size)
        aux = collect_load_balance_loss(model)
        if aux is not None:
            # Each block routed its own tokens: the per-shard statistic,
            # averaged over the row by the sum below.
            loss = loss + moe_aux_coef * aux[0] / seq.size
        loss.backward()
        total = seq.all_reduce(loss.detach().reshape(1).clone(), "sum")
        seq.all_reduce(grads, "sum")
        optimizer.step()
        with torch.no_grad():
            # The Metropolis round on the agents ring (both neighbours at
            # once; with two agents they are the same rank).
            left, right = torch.empty_like(flat), torch.empty_like(flat)
            agents.exchange([(nxt, flat), (prv, flat)], [(prv, left), (nxt, right)])
            flat.copy_(flat * (1.0 - 2.0 * w) + left * w + right * w)
        return agents.all_reduce(total, "sum")[0] / n

    return step
