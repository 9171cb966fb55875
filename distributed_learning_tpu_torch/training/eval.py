"""LM evaluation: next-token cross entropy and perplexity (port of
``distributed_learning_tpu/training/eval.py``).

The classification side evaluates through the trainer's ``metric_fn``;
language models report perplexity.  Here the sequences run through the
port's agent-stacked ``TransformerLM`` in batches under
``torch.no_grad()``: on the card through the flash forward (kernel A,
without the logsumexp), on the CPU through its plain version.  Every
agent scores the same sequences; the per-position cross entropies are
summed in float32, as the reference's scan carries them.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["lm_cross_entropy", "perplexity"]

PerAgent = Union[float, np.ndarray]


@torch.no_grad()
def lm_cross_entropy(
    model,
    tokens,
    *,
    batch_size: Optional[int] = None,
) -> Tuple[PerAgent, int]:
    """Mean next-token cross entropy of ``model`` on ``tokens``.

    ``tokens`` is (N, T) integers (array or tensor); position ``t`` is
    scored against the prediction from positions ``<= t-1`` (T-1 scored
    positions per sequence).  With ``batch_size`` the sequences run in
    batches of that many (N must divide); otherwise in one batch.  The
    model holds its own parameters (the reference passes a ``params``
    tree).  Returns ``(mean_ce_nats, n_positions)``: the mean a float
    for a one-agent model, an ``(n_agents,)`` array otherwise (each
    agent's mean over the same sequences).
    """
    tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(tokens, torch.Tensor) else tokens)
    N, T = tokens.shape
    if T < 2:
        raise ValueError(f"need sequences of length >= 2, got T={T}")
    b = N if batch_size is None else int(batch_size)
    if b < 1:
        raise ValueError(f"batch_size must be >= 1, got {b}")
    if N % b:
        raise ValueError(f"N={N} must divide by batch_size={b}")
    device = model.flat_params.device
    tokens = tokens.to(device=device, dtype=torch.long)
    A = model.n_agents
    was_training = model.training
    model.eval()
    try:
        total = torch.zeros(A, dtype=torch.float32, device=device)
        for s in range(0, N, b):
            batch = tokens[s: s + b]
            logits = model(batch.unsqueeze(0).expand(A, b, T))  # (A, b, T, V) float32
            V = logits.shape[-1]
            target = batch[:, 1:].unsqueeze(0).expand(A, b, T - 1)
            ce = F.cross_entropy(logits[:, :, :-1].reshape(-1, V), target.reshape(-1),
                                 reduction="none")
            total += ce.reshape(A, -1).sum(dim=1)
    finally:
        model.train(was_training)
    mean = total.cpu().numpy().astype(np.float64) / (N * (T - 1))
    return (float(mean[0]) if A == 1 else mean), N * (T - 1)


def perplexity(
    model,
    tokens,
    *,
    batch_size: Optional[int] = None,
) -> PerAgent:
    """``exp(mean next-token cross entropy)`` — bounded above by the
    vocabulary size for any calibrated model (uniform logits hit it).
    A float for a one-agent model, an ``(n_agents,)`` array otherwise."""
    ce, _ = lm_cross_entropy(model, tokens, batch_size=batch_size)
    return float(np.exp(ce)) if np.isscalar(ce) else np.exp(ce)
