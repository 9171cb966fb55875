"""Plain full attention (port of ``attention_reference`` from
``distributed_learning_tpu/ops/ring_attention.py``).

It is the transformer's ``attn_impl="full"`` path and the oracle the flash
kernels are held against.  The ring, Ulysses and ring-flash strategies of
the reference wait for the ``torch.distributed`` route (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention_reference"]


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain full attention on (B, T, H, D).

    ``window`` (requires ``causal``) restricts row ``r`` to keys in
    ``[r - window + 1, r]`` — causal sliding-window attention."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if window is not None and not causal:
        raise ValueError("window requires causal=True")
    if causal:
        T, S = q.shape[1], k.shape[1]
        ones = torch.ones((T, S), dtype=torch.bool, device=q.device)
        mask = torch.tril(ones, diagonal=S - T)
        if window is not None:
            mask &= ~torch.tril(ones, diagonal=S - T - window)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
