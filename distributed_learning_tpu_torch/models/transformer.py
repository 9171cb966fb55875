"""Agent-stacked decoder-only transformer (port of
``distributed_learning_tpu/models/transformer.py``).

The reference trains N gossip agents by ``jax.vmap``-ing one flax model
over a leading agent axis.  ``torch.func.vmap`` cannot batch an opaque
ctypes kernel launch, so this model is written agent-stacked instead:
every weight carries the leading ``N`` axis, projections are batched
matrix products over it, and attention sees ``(N*B, T, H, Dh)`` — each
flash kernel launches once per layer for all agents.

Every parameter is a view into ONE contiguous ``(N, P)`` float32 buffer
(:attr:`TransformerLM.flat_params`), and every gradient a view into a
twin buffer (:attr:`TransformerLM.flat_grads`): a gossip round is then one
``W @ X`` GEMM on the buffer, the optimizer steps one tensor, and the
per-agent gradient norm is one reduction — none of them flattens or
unflattens anything.

Parameter names and per-agent shapes follow the flax tree (kernels are
``(in, out)``, the QKV kernel ``(d, 3, H, Dh)``), so ``convert.py`` maps
the two trees by name alone.  Parity with flax: LayerNorm epsilon 1e-6
with statistics in float32, tanh-approximate GELU, compute in ``dtype``
over float32 parameters, logits cast to float32.

Ported: dense MLP, learned positions, ``attn_impl`` ``"full"`` / ``"flash"``,
``attn_window``, ``dtype``.  RoPE, GQA, MoE, dropout, decode/``generate``
and the sequence-parallel attentions wait (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.ops.flash_attention import flash_attention
from distributed_learning_tpu_torch.ops.ring_attention import attention_reference

__all__ = ["TransformerLM"]

_LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def _dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Per-agent ``x @ w (+ b)`` in ``dtype``: x (N, ..., in), w (N, in, out)."""
    N = x.shape[0]
    y = torch.bmm(x.reshape(N, -1, x.shape[-1]), w.to(dtype))
    if b is not None:
        y = y + b.to(dtype)[:, None, :]
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)`` per agent: float32 statistics,
    output cast to the compute dtype."""

    def __init__(self, n: int, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, d))
        self.bias = nn.Parameter(torch.zeros(n, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, d = self.scale.shape
        y = F.layer_norm(x.to(torch.float32), (d,), eps=_LN_EPS)
        shape = (N,) + (1,) * (x.dim() - 2) + (d,)
        y = y * self.scale.reshape(shape) + self.bias.reshape(shape)
        return y.to(x.dtype)


class _Dense(nn.Module):
    def __init__(self, n: int, d_in: int, d_out: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(n, d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(n, d_out)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(x, self.kernel, self.bias, x.dtype)


class _Attention(nn.Module):
    def __init__(self, n, d, num_heads, head_dim, attn_impl, window):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, head_dim
        self.attn_impl, self.window = attn_impl, window
        # flax DenseGeneral_0 (d, 3, H, Dh) and DenseGeneral_1 (H, Dh, d).
        self.qkv = nn.Parameter(torch.zeros(n, d, 3, num_heads, head_dim))
        self.out = nn.Parameter(torch.zeros(n, num_heads, head_dim, d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, B, T, d = x.shape
        H, Dh = self.num_heads, self.head_dim
        qkv = _dense(x, self.qkv.reshape(N, d, 3 * H * Dh), None, x.dtype)
        qkv = qkv.reshape(N * B, T, 3, H, Dh)
        # Strided views: the kernels read them in place.
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if self.attn_impl == "full":
            out = attention_reference(q, k, v, causal=True, window=self.window)
        else:
            out = flash_attention(q, k, v, causal=True, window=self.window)
        out = out.reshape(N, B, T, H * Dh)
        return _dense(out, self.out.reshape(N, H * Dh, d), None, x.dtype)


class _Block(nn.Module):
    def __init__(self, n, d, num_heads, head_dim, mlp_ratio, attn_impl, window):
        super().__init__()
        self.ln1 = _LayerNorm(n, d)
        self.attn = _Attention(n, d, num_heads, head_dim, attn_impl, window)
        self.ln2 = _LayerNorm(n, d)
        self.fc1 = _Dense(n, d, mlp_ratio * d)
        self.fc2 = _Dense(n, mlp_ratio * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        h = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(h)


class TransformerLM(nn.Module):
    """Causal LM for ``n_agents`` stacked replicas: token embedding +
    learned positions + ``num_layers`` blocks.

    ``forward(tokens)`` takes (N, B, T) integer tokens and returns
    (N, B, T, vocab) float32 logits; agent ``a``'s logits depend only on
    agent ``a``'s parameters.  All agents start from one shared init
    drawn from ``seed`` (the trainer's shared-init contract).
    """

    def __init__(
        self,
        vocab_size: int = 256,
        num_layers: int = 2,
        num_heads: int = 4,
        head_dim: int = 16,
        max_len: int = 1024,
        mlp_ratio: int = 4,
        attn_impl: str = "full",
        attn_window: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        *,
        n_agents: int = 1,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        if attn_impl not in ("full", "flash"):
            raise NotImplementedError(
                f"attn_impl {attn_impl!r} is not ported yet (ring/ring_flash/"
                "ulysses wait for the torch.distributed route, ROADMAP.md)"
            )
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim = num_heads, head_dim
        self.max_len, self.mlp_ratio = max_len, mlp_ratio
        self.attn_impl, self.attn_window = attn_impl, attn_window
        self.dtype, self.n_agents = dtype, int(n_agents)
        d = num_heads * head_dim
        n = self.n_agents
        self.embed = nn.Parameter(torch.zeros(n, vocab_size, d))      # Embed_0
        self.pos_embed = nn.Parameter(torch.zeros(n, max_len, d))     # Embed_1
        self.blocks = nn.ModuleList(
            _Block(n, d, num_heads, head_dim, mlp_ratio, attn_impl, attn_window)
            for _ in range(num_layers)
        )
        self.ln_f = _LayerNorm(n, d)                                  # LayerNorm_0
        self.head = _Dense(n, d, vocab_size)                          # Dense_0
        self.reset_parameters(seed)
        self._bind_flat(resolve_device(device))

    # -- parameters ---------------------------------------------------- #
    def reset_parameters(self, seed: int) -> None:
        """One init (flax's families: normal embeddings, LeCun-normal
        kernels, zero biases, unit LayerNorm scales) broadcast to every
        agent.  Values differ from flax's draws; tests load converted flax
        weights when they compare."""
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
                if name in ("embed", "pos_embed"):
                    std = 1.0 / math.sqrt(shape[-1])
                else:
                    # Kernels are (in..., out); the out-projection contracts
                    # (H, Dh), every other kernel its first axis.
                    fan_in = math.prod(shape[:-1]) if name.endswith("attn.out") else shape[0]
                    std = 1.0 / math.sqrt(fan_in)
                p.copy_((torch.randn(shape, generator=gen) * std).expand_as(p))

    def _bind_flat(self, device: torch.device) -> None:
        """Move every parameter into one (N, P) float32 buffer (and every
        gradient into a twin buffer) and re-register it as a view."""
        named = list(self.named_parameters())
        n = self.n_agents
        total = sum(p[0].numel() for _, p in named)
        self.flat_params = torch.empty(n, total, dtype=torch.float32, device=device)
        self.flat_grads = torch.zeros(n, total, dtype=torch.float32, device=device)
        self.param_slices: Dict[str, Tuple[int, int]] = {}
        off = 0
        for name, p in named:
            size = p[0].numel()
            view = self.flat_params[:, off: off + size].view(p.shape)
            view.copy_(p.detach())
            new = nn.Parameter(view)
            new.grad = self.flat_grads[:, off: off + size].view(p.shape)
            owner, _, leaf = name.rpartition(".")
            setattr(self.get_submodule(owner) if owner else self, leaf, new)
            self.param_slices[name] = (off, size)
            off += size

    def stacked_parameters(self) -> Dict[str, torch.Tensor]:
        """``{name: (N, ...)}`` views of the parameters, in layout order."""
        return {name: p for name, p in self.named_parameters()}

    def load_stacked(self, params: Dict[str, torch.Tensor]) -> None:
        """Copy ``{name: (N, ...) or (...)}`` values into the parameters
        (an unstacked value is broadcast to every agent)."""
        own = self.stacked_parameters()
        missing = set(own) - set(params)
        extra = set(params) - set(own)
        if missing or extra:
            raise KeyError(f"parameter names differ: missing {sorted(missing)}, "
                           f"unexpected {sorted(extra)}")
        with torch.no_grad():
            for name, p in own.items():
                v = params[name]
                if not isinstance(v, torch.Tensor):
                    v = torch.from_numpy(np.array(v, dtype=np.float32))
                p.copy_(v.expand_as(p) if v.shape != p.shape else v)

    # -- forward ------------------------------------------------------- #
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        N, B, T = tokens.shape
        if N != self.n_agents:
            raise ValueError(f"tokens carry {N} agents, model has {self.n_agents}")
        if T > self.max_len:
            raise ValueError(
                f"sequence length {T} exceeds max_len {self.max_len}; "
                "out-of-range positions would silently clamp"
            )
        emb = self.embed.to(self.dtype)
        agent = torch.arange(N, device=tokens.device)[:, None, None]
        x = emb[agent, tokens]                                        # (N, B, T, d)
        x = x + self.pos_embed[:, :T].to(self.dtype)[:, None]
        for blk in self.blocks:
            x = blk(x)
        logits = self.head(self.ln_f(x))
        return logits.to(torch.float32)

    def param_count(self) -> int:
        """Parameters of ONE agent."""
        return self.flat_params.shape[1]

