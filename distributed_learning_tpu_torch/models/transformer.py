"""Agent-stacked decoder-only transformer (port of
``distributed_learning_tpu/models/transformer.py``).

The reference trains N gossip agents by ``jax.vmap``-ing one flax model
over a leading agent axis.  ``torch.func.vmap`` cannot batch an opaque
ctypes kernel launch, so this model is written agent-stacked instead:
every weight carries the leading ``N`` axis, projections are batched
matrix products over it, and attention sees ``(N*B, T, H, Dh)`` — each
flash kernel launches once per layer for all agents.

Every parameter is a view into ONE contiguous ``(N, P)`` float32 buffer
and every gradient a view into a twin buffer (``models/_stacked.py``,
shared with the vision models).

Parameter names and per-agent shapes follow the flax tree (kernels are
``(in, out)``, the QKV kernel ``(d, 3, H, Dh)``), so ``convert.py`` maps
the two trees by name alone.  Parity with flax: LayerNorm epsilon 1e-6
with statistics in float32, tanh-approximate GELU, compute in ``dtype``
over float32 parameters, logits cast to float32.

Knobs, as the reference's: ``attn_impl`` ``"full"`` / ``"flash"``, or the
sequence-parallel ``"ring"`` / ``"ring_flash"`` / ``"ulysses"``
(``ops/ring_attention.py``) over the ``seq_axis`` of ``mesh`` (a
:class:`~distributed_learning_tpu_torch.parallel.multihost.GridMesh`, or
the axis's own ``AgentMesh``): each rank of the axis holds one block of
every sequence, and its positions are global (``rank * T_local +
arange(T_local)``, for the learned table and for rope); ``attn_window``; ``pos_emb`` ``"learned"`` or ``"rope"`` (rotary Q/K at
global positions, no position table); ``num_kv_heads`` (grouped-query
attention: ``q_proj`` / ``kv_proj`` replace the fused QKV kernel, and K/V
are repeated up to H heads just before attention, so the flash kernels
keep their ``q.shape == k.shape`` contract); ``mlp="moe"`` with
``num_experts``, ``moe_top_k``, ``moe_capacity_factor``
(``models/moe.py``); ``dropout_rate`` (residual-branch dropout in train
mode, each agent's masks from its own generator); ``dtype``.

Decode: ``forward(tokens, cache=model.init_cache(B))`` is the reference's
``decode=True`` mode.  The static :class:`KVCache` holds
``(N*B, max_len, Hkv, Dh)`` keys and values per layer in ``dtype`` and
its write index as a device tensor.  A step attends against the whole
cache with a position mask (queries grouped as ``(B, T, Hkv, g, Dh)``
against the Hkv-head cache, no expanded copy); the first call on a fresh
cache (the prefill) goes through :func:`flash_attention` when
``attn_impl="flash"``, the same causal function over the prompt.  MoE
blocks run drop-free in decode.  :func:`generate` drives it; decode with
a sequence-parallel ``attn_impl`` raises, as the reference's does.

Model parallelism inside one replica (one replica a rank, ``n_agents=1``,
on the axes of a :class:`~distributed_learning_tpu_torch.parallel.
multihost.GridMesh`):

* ``tp_axis`` is the Megatron split (arXiv:1909.08053), laid out by
  ``training/tp.py``'s ``transformer_tp_rules`` with its divisibility
  fallback, so a rank holds the block of each parameter that the
  reference's GSPMD placement puts on the device of its index: the QKV
  kernel's (or ``q_proj``'s) ``H/n`` heads and the out-projection's rows,
  ``kv_proj``'s ``Hkv/n`` heads (the whole ``kv_proj`` when ``Hkv`` does
  not divide: every rank then picks its query heads' groups out of all
  ``Hkv``), the MLP's ``4d/n`` up columns and down rows.  Attention runs
  on the local heads (the flash kernels on ``(B, T, H/n, Dh)``); each
  region opens with Megatron's f (identity, gradient summed over the
  axis) and closes with g (one ``all_reduce`` of the partial product,
  then the replicated bias).  ``Dense_0``'s bias stays whole, as the
  rules replicate 1-D leaves, and each rank adds its columns' slice; its
  gradient (and a replicated ``kv_proj``'s) is partial on each rank, so
  the step sums :attr:`TransformerLM.tp_partial_grads` over the axis.
  MoE blocks run replicated, as the rules leave expert kernels whole.
  Decode keeps the local ``Hkv/n`` heads (or all ``Hkv`` under the
  fallback) in the cache.  The reference's manual mode raises for decode
  and MoE (``transformer.py:115``, ``:339``) because ``pp_lm`` runs it
  inside pipeline stages; the port's pipeline comes with ROADMAP item 5b,
  and this mode serves ``training/tp.py``'s step and ``make_tp_generate``.
* ``moe_expert_axis`` holds ``E/n`` experts a rank (``models/moe.py``'s
  expert-parallel mode, placed by ``moe_param_spec``).

Either model draws its init at the whole shapes from ``seed`` and keeps
its block, so it equals the sharded one-process model of that seed.
:meth:`TransformerLM.set_batch_mesh` names the axis a step splits the
batch over: MoE blocks then route the gathered global batch, as the
reference's partitioner computes the routing of a data-sharded batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models._stacked import Dense, Dropout, StackedModel, dense
from distributed_learning_tpu_torch.models.moe import MoEMLP
from distributed_learning_tpu_torch.ops import ring_attention as ra
from distributed_learning_tpu_torch.parallel.multihost import (
    MeshPosition,
    copy_to_axis,
    local_shard,
    reduce_from_axis,
)
from distributed_learning_tpu_torch.ops.flash_attention import flash_attention
from distributed_learning_tpu_torch.ops.ring_attention import attention_reference

_SEQ_PARALLEL = {"ring": ra.ring_attention, "ring_flash": ra.ring_flash_attention,
                 "ulysses": ra.ulysses_attention}

__all__ = ["KVCache", "TransformerLM", "generate", "sample_fn", "truncate_logits",
           "validate_sampling"]

_LN_EPS = 1e-6  # flax LayerNorm's default (torch's is 1e-5)


def _rope(x: torch.Tensor, positions: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the head dim, in the half-split
    (GPT-NeoX) layout: dimension ``j`` pairs with ``j + Dh/2`` and the
    pair rotates by ``pos / base^(2j/Dh)``, computed in float32 and cast
    back to ``x``'s dtype.  ``x`` is (B, T, H, Dh) with even Dh;
    ``positions`` is (T,) global token positions on ``x``'s device (in
    decode, the cache's write index onwards)."""
    Dh = x.shape[-1]
    if Dh % 2:
        raise ValueError(f"rope needs an even head_dim, got {Dh}")
    half = Dh // 2
    inv = base ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    freqs = positions[:, None].to(torch.float32) / inv                # (T, half)
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    """The decode state of one :class:`TransformerLM`: per layer the keys
    and values ``(N*B, L, Hkv, Dh)`` in the model's dtype, the next write
    slot ``index`` (a 0-dim int64 device tensor: the tokens seen so far),
    and ``fresh``, true until the first call writes (the host knows
    it, so the prefill can take the flash path without reading
    ``index``)."""

    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    index: torch.Tensor
    fresh: bool = True

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.keys + self.values)


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


class _Attention(nn.Module):
    def __init__(self, n, d, num_heads, head_dim, attn_impl, window, num_kv_heads, rope,
                 seq_mesh=None):
        super().__init__()
        self.seq_mesh = seq_mesh
        H, Hkv = num_heads, num_kv_heads
        if H % Hkv:
            raise ValueError(f"num_heads {H} must divide by num_kv_heads {Hkv}")
        self.num_heads, self.num_kv_heads, self.head_dim = H, Hkv, head_dim
        self.attn_impl, self.window, self.rope = attn_impl, window, rope
        # The heads this rank holds (all of them unless the model splits
        # them over its tp axis, :meth:`shard_heads`).
        self.tp = None
        self.h_local, self.kv_local = H, Hkv
        self.kv_index: Optional[List[int]] = None
        self._kv_index_t: Optional[torch.Tensor] = None
        if Hkv == H:
            # flax DenseGeneral_0 (d, 3, H, Dh).
            self.qkv = nn.Parameter(torch.zeros(n, d, 3, H, head_dim))
        else:
            self.q_proj = nn.Parameter(torch.zeros(n, d, H, head_dim))
            self.kv_proj = nn.Parameter(torch.zeros(n, d, 2, Hkv, head_dim))
        # flax DenseGeneral_1 (H, Dh, d).
        self.out = nn.Parameter(torch.zeros(n, H, head_dim, d))

    def shard_heads(self, tp, kv_sharded: bool) -> None:
        """Run on this rank's ``H/n`` query heads of ``tp``'s axis (the
        parameters already hold them), with ``Hkv/n`` K/V heads or, when
        ``kv_sharded`` is false, all ``Hkv``: local query head ``j`` then
        reads K/V head ``(agent * H/n + j) // (H/Hkv)``."""
        H, Hkv = self.num_heads, self.num_kv_heads
        self.tp = tp
        self.h_local = H // tp.size
        if kv_sharded:
            self.kv_local = Hkv // tp.size
        else:
            g = H // Hkv
            self.kv_index = [(tp.agent * self.h_local + j) // g for j in range(self.h_local)]

    def _project(self, x):
        N, B, T, d = x.shape
        H, Hkv, Dh = self.h_local, self.kv_local, self.head_dim
        if self.num_kv_heads == self.num_heads:
            qkv = dense(x, self.qkv.reshape(N, d, 3 * H * Dh), None, x.dtype)
            qkv = qkv.reshape(N * B, T, 3, H, Dh)
            # Strided views: the kernels read them in place.
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = dense(x, self.q_proj.reshape(N, d, H * Dh), None, x.dtype).reshape(N * B, T, H, Dh)
        kv = dense(x, self.kv_proj.reshape(N, d, 2 * Hkv * Dh), None, x.dtype)
        kv = kv.reshape(N * B, T, 2, Hkv, Dh)
        return q, kv[:, :, 0], kv[:, :, 1]

    def _rotate(self, q, k, positions):
        """Rotary Q and K (one rope for both modes: ``positions`` are
        global)."""
        return _rope(q, positions), _rope(k, positions)

    def _expand_kv(self, k, v):
        """Repeat each of the Hkv K/V heads for its group of H/Hkv query
        heads (a no-op without GQA); under the replicated-K/V fallback,
        pick each local query head's K/V head."""
        if self.kv_index is not None:
            if self._kv_index_t is None or self._kv_index_t.device != k.device:
                self._kv_index_t = torch.tensor(self.kv_index, dtype=torch.long, device=k.device)
            return k.index_select(2, self._kv_index_t), v.index_select(2, self._kv_index_t)
        g = self.h_local // self.kv_local
        if g == 1:
            return k, v
        return k.repeat_interleave(g, dim=2), v.repeat_interleave(g, dim=2)

    def forward(self, x, positions, cache: Optional[KVCache] = None, layer: int = 0):
        N, B, T, d = x.shape
        H, Dh = self.h_local, self.head_dim
        if self.tp is not None:
            x = copy_to_axis(x, self.tp)
        q, k, v = self._project(x)
        if self.rope:
            q, k = self._rotate(q, k, positions)
        if cache is not None:
            out = self._decode(q, k, v, cache, layer)
        else:
            k, v = self._expand_kv(k, v)
            if self.attn_impl == "full":
                out = attention_reference(q, k, v, causal=True, window=self.window)
            elif self.attn_impl == "flash":
                out = flash_attention(q, k, v, causal=True, window=self.window)
            else:
                out = _SEQ_PARALLEL[self.attn_impl](q, k, v, mesh=self.seq_mesh, causal=True)
        out = out.reshape(N, B, T, H * Dh)
        y = dense(out, self.out.reshape(N, H * Dh, d), None, x.dtype)
        # The local heads' partial product, totalled over the tp axis.
        return y if self.tp is None else reduce_from_axis(y, self.tp)

    @staticmethod
    def _write_cache(ck, cv, k, v, i):
        """K/V of this call into slots ``[i, i+T)`` of the layer's cache."""
        L, T = ck.shape[1], k.shape[1]
        slots = i.clamp(max=L - T) + torch.arange(T, device=k.device)
        ck.index_copy_(1, slots, k.to(ck.dtype))
        cv.index_copy_(1, slots, v.to(cv.dtype))

    def _decode(self, q, k, v, cache: KVCache, layer: int):
        """Write this call's K/V at slots ``[i, i+T)`` of the layer's cache
        (``i`` the cache index; the start clamps to ``L - T`` as the
        reference's ``dynamic_update_slice`` does) and attend: query row
        ``t`` sees cached positions ``<= i + t`` (inside the window).  A
        call that reaches past the cache returns NaN, as the reference's
        guard does: its write was clamped."""
        NB, T, H, Dh = q.shape
        ck, cv = cache.keys[layer], cache.values[layer]
        L = ck.shape[1]
        if T > L:
            raise ValueError(
                f"prefill length {T} exceeds the cache ({L}); a longer "
                "prompt would silently clamp the cache write"
            )
        i = cache.index
        self._write_cache(ck, cv, k, v, i)
        if self.kv_index is not None:
            # The replicated cache holds every K/V head: read the local
            # query heads' ones.
            ck, cv = self._expand_kv(ck, cv)
        if cache.fresh and self.attn_impl == "flash":
            # The prefill: causal attention over the prompt, what the
            # masked product over the cache's first T slots computes.
            ke, ve = self._expand_kv(k, v)
            out = flash_attention(q, ke, ve, causal=True, window=self.window)
        else:
            Hkv = ck.shape[2]
            g = H // Hkv
            qg = q.reshape(NB, T, Hkv, g, Dh)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck).to(torch.float32) * (1.0 / Dh ** 0.5)
            qpos = i + torch.arange(T, device=q.device)
            kpos = torch.arange(L, device=q.device)
            live = kpos[None, :] <= qpos[:, None]                       # (T, L)
            if self.window is not None:
                live &= kpos[None, :] > qpos[:, None] - self.window
            s = s.masked_fill(~live, float("-inf"))
            p = torch.softmax(s, dim=-1)
            out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(cv.dtype), cv).reshape(NB, T, H, Dh)
        return torch.where(i + T > L, float("nan"), out)


class _Block(nn.Module):
    def __init__(self, n, d, num_heads, head_dim, mlp_ratio, attn_impl, window, num_kv_heads,
                 rope, mlp, num_experts, moe_top_k, moe_capacity_factor, dropout_rate,
                 generators, seq_mesh=None):
        super().__init__()
        self.ln1 = _LayerNorm(n, d)
        self.attn = _Attention(n, d, num_heads, head_dim, attn_impl, window, num_kv_heads, rope,
                               seq_mesh)
        self.ln2 = _LayerNorm(n, d)
        if mlp == "moe":
            # On the CPU, as every block parameter, until the model binds
            # them into its flat buffer on its device.
            self.moe = MoEMLP(n, d, num_experts, mlp_ratio, moe_capacity_factor, moe_top_k,
                              device="cpu")
        else:
            self.fc1 = Dense(n, d, mlp_ratio * d)
            self.fc2 = Dense(n, mlp_ratio * d, d)
        # Residual-branch dropout (the GPT placement), train mode only.
        self.drop = Dropout(dropout_rate, generators) if dropout_rate > 0 else None
        # The tp axis when the MLP holds its columns and rows of it.
        self.mlp_tp = None

    def _drop(self, h):
        return h if self.drop is None else self.drop(h)

    def forward(self, x, positions, cache=None, layer=0):
        x = x + self._drop(self.attn(self.ln1(x), positions, cache, layer))
        h = self.ln2(x)
        if hasattr(self, "moe"):
            return x + self._drop(self.moe(h, drop_tokens=cache is None))
        if self.mlp_tp is None:
            h = F.gelu(self.fc1(h), approximate="tanh")
            return x + self._drop(self.fc2(h))
        # Megatron's column-then-row MLP: this rank's up columns (and its
        # slice of the whole up bias), gelu, its down rows, one all_reduce,
        # then the down bias once.
        tp = self.mlp_tp
        cols = self.fc1.kernel.shape[-1]
        h = copy_to_axis(h, tp)
        bias = self.fc1.bias[:, tp.agent * cols:(tp.agent + 1) * cols]
        h = F.gelu(dense(h, self.fc1.kernel, bias, h.dtype), approximate="tanh")
        y = reduce_from_axis(dense(h, self.fc2.kernel, None, h.dtype), tp)
        return x + self._drop(y + self.fc2.bias.to(y.dtype)[:, None, None, :])


class TransformerLM(StackedModel):
    """Causal LM for ``n_agents`` stacked replicas: token embedding,
    learned positions or rotary Q/K, and ``num_layers`` blocks.

    ``forward(tokens)`` takes (N, B, T) integer tokens and returns
    (N, B, T, vocab) float32 logits; agent ``a``'s logits depend only on
    agent ``a``'s parameters (and, with dropout in train mode, its own
    generator).  ``forward(tokens, cache)`` is decode mode (see the
    module docstring).  All agents start from one shared init drawn from
    ``seed`` (the trainer's shared-init contract).  With a
    sequence-parallel ``attn_impl`` the tokens are this rank's block of T
    along ``mesh``'s ``seq_axis``, and every rank of the axis must run the
    same calls.
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
        mlp: str = "dense",
        num_experts: int = 4,
        moe_top_k: int = 1,
        moe_capacity_factor: float = 1.25,
        dropout_rate: float = 0.0,
        pos_emb: str = "learned",
        num_kv_heads: Optional[int] = None,
        seq_axis: str = "seq",
        tp_axis: Optional[str] = None,
        moe_expert_axis: Optional[str] = None,
        *,
        mesh=None,
        n_agents: int = 1,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        if attn_impl not in ("full", "flash") and attn_impl not in _SEQ_PARALLEL:
            raise ValueError(f"unknown attn_impl {attn_impl!r}")
        self.seq_axis = seq_axis
        self.seq_mesh = None
        if attn_impl in _SEQ_PARALLEL:
            if attn_window is not None:
                raise ValueError(f"window is only supported for full/flash attention, "
                                 f"not {attn_impl!r}")
            if mesh is None:
                raise ValueError(f"attn_impl {attn_impl!r} needs mesh= (its {seq_axis!r} axis)")
            self.seq_mesh = mesh[seq_axis] if hasattr(mesh, "axes") else mesh
        # The model-parallel axes (one replica a rank).
        self.tp_axis, self.moe_expert_axis = tp_axis, moe_expert_axis
        self.parallel = {}
        for axis in (tp_axis, moe_expert_axis):
            if axis is None:
                continue
            if mesh is None:
                raise ValueError(f"model-parallel axis {axis!r} needs mesh=")
            self.parallel[axis] = mesh[axis] if hasattr(mesh, "axes") else mesh
        if self.parallel and int(n_agents) != 1:
            raise ValueError("tp_axis / moe_expert_axis hold one replica a rank (n_agents=1)")
        if pos_emb not in ("learned", "rope"):
            raise ValueError(f"unknown pos_emb {pos_emb!r} (want learned|rope)")
        if mlp not in ("dense", "moe"):
            raise ValueError(f"unknown mlp {mlp!r} (want dense|moe)")
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_heads if num_kv_heads is None else int(num_kv_heads)
        self.max_len, self.mlp_ratio = max_len, mlp_ratio
        self.attn_impl, self.attn_window = attn_impl, attn_window
        self.pos_emb, self.mlp, self.dropout_rate = pos_emb, mlp, float(dropout_rate)
        self.dtype, self.n_agents = dtype, int(n_agents)
        device = resolve_device(device)
        self._make_generators(device, seed)
        d = num_heads * head_dim
        n = self.n_agents
        self.embed = nn.Parameter(torch.zeros(n, vocab_size, d))      # Embed_0
        if pos_emb == "learned":
            self.pos_embed = nn.Parameter(torch.zeros(n, max_len, d))  # Embed_1
        self.blocks = nn.ModuleList(
            _Block(n, d, num_heads, head_dim, mlp_ratio, attn_impl, attn_window,
                   self.num_kv_heads, pos_emb == "rope", mlp, num_experts, moe_top_k,
                   moe_capacity_factor, self.dropout_rate, self.generators, self.seq_mesh)
            for _ in range(num_layers)
        )
        self.ln_f = _LayerNorm(n, d)                                  # LayerNorm_0
        self.head = Dense(n, d, vocab_size)                          # Dense_0
        self.layout, self.full_shapes, self.tp_partial_grads = {}, {}, []
        if self.parallel:
            self._shard_to_layout()
        self.reset_parameters(seed)
        self._bind_flat(device)

    # -- model parallelism --------------------------------------------- #
    def _shard_to_layout(self) -> None:
        """Place every parameter as the reference's rules do (the tp rules
        with their divisibility fallback, then the expert rule), keep this
        rank's block of each, and set each module's mode from it."""
        from distributed_learning_tpu_torch.convert import lm_flax_path
        from distributed_learning_tpu_torch.models.moe import moe_param_spec
        from distributed_learning_tpu_torch.training.tp import (
            divisible_or_replicated,
            transformer_tp_rules,
        )

        tp = self.parallel.get(self.tp_axis)
        ep = self.parallel.get(self.moe_expert_axis)
        self.position = MeshPosition({k: m.size for k, m in self.parallel.items()},
                                      {k: m.agent for k, m in self.parallel.items()})
        sharded = set()
        for name, p in list(self.named_parameters()):
            full = tuple(p.shape[1:])
            leaf = torch.empty(full, device="meta")
            path = lm_flax_path(name)
            spec = ()
            if tp is not None:
                spec = divisible_or_replicated(transformer_tp_rules(path, leaf, self.tp_axis),
                                               leaf, self.position, self.tp_axis)
            if ep is not None and not any(spec):
                spec = moe_param_spec(path, leaf, self.moe_expert_axis)
            self.full_shapes[name] = full
            self.layout[name] = spec
            if any(spec):
                sharded.add(name)
                owner, _, attr = name.rpartition(".")
                block = local_shard(p.detach(), spec, self.position, offset=1)
                setattr(self.get_submodule(owner), attr, nn.Parameter(block.clone()))
        for i, blk in enumerate(self.blocks):
            pre = f"blocks.{i}."
            attn = blk.attn
            heads = pre + ("attn.qkv" if hasattr(attn, "qkv") else "attn.q_proj")
            if heads in sharded:
                kv_sharded = hasattr(attn, "qkv") or pre + "attn.kv_proj" in sharded
                attn.shard_heads(tp, kv_sharded)
                if not kv_sharded:
                    self.tp_partial_grads.append(pre + "attn.kv_proj")
            if pre + "fc1.kernel" in sharded:
                blk.mlp_tp = tp
                self.tp_partial_grads.append(pre + "fc1.bias")
            if pre + "moe.w_up" in sharded:
                blk.moe.ep = ep

    def _full_shape(self, name, shape):
        return self.full_shapes.get(name, shape)

    def _local_block(self, name, full):
        spec = self.layout.get(name)
        return local_shard(full, spec, self.position) if spec and any(spec) else full

    def set_batch_mesh(self, mesh) -> None:
        """The batch is split over ``mesh`` (an ``AgentMesh``, or None):
        MoE blocks route the batch gathered over it and keep their rows
        of the result, as the reference routes a data-sharded batch (the
        capacity queue and the load-balance statistics are the global
        batch's)."""
        for m in self.modules():
            if isinstance(m, MoEMLP):
                m.batch_mesh = mesh

    def _init_std(self, name, shape):
        """Normal embeddings (std ``1/sqrt(d)``), LeCun-normal kernels
        (fan-in: the contracted axes), zero expert biases.  Kernels are
        (in..., out): the out-projection contracts (H, Dh), an expert
        kernel (E, in, out) its second axis, every other kernel its
        first."""
        if name in ("embed", "pos_embed"):
            return 1.0 / math.sqrt(shape[-1])
        if name.endswith(("moe.b_up", "moe.b_dn")):
            return 0.0
        if name.endswith("attn.out"):
            fan_in = math.prod(shape[:-1])
        elif name.endswith(("moe.w_up", "moe.w_dn")):
            fan_in = shape[1]
        else:
            fan_in = shape[0]
        return 1.0 / math.sqrt(fan_in)

    def init_cache(self, batch_size: int) -> KVCache:
        """A fresh decode cache for (N, ``batch_size``) sequences of up to
        ``max_len`` tokens."""
        kv_heads = self.blocks[0].attn.kv_local if len(self.blocks) else self.num_kv_heads
        shape = (self.n_agents * batch_size, self.max_len, kv_heads, self.head_dim)
        dev = self.flat_params.device
        return KVCache(
            keys=[torch.zeros(shape, dtype=self.dtype, device=dev) for _ in self.blocks],
            values=[torch.zeros(shape, dtype=self.dtype, device=dev) for _ in self.blocks],
            index=torch.zeros((), dtype=torch.long, device=dev))

    # -- forward ------------------------------------------------------- #
    def embed_tokens(self, embed, pos_embed, tokens, positions, decode: bool = False):
        """The token embedding (and the learned positions) of ``tokens``
        (N, B, T) at ``positions`` with the tables given (the model's own,
        or gathered ones), in the compute dtype."""
        N, T = tokens.shape[0], tokens.shape[-1]
        agent = torch.arange(N, device=tokens.device)[:, None, None]
        x = embed.to(self.dtype)[agent, tokens]                       # (N, B, T, d)
        if self.pos_emb == "learned":
            table = pos_embed.to(self.dtype)
            if not decode and self.seq_mesh is None:
                x = x + table[:, :T][:, None]
            elif not decode:
                x = x + table[:, positions][:, None]
            else:
                # A step past the table reads its last row; the attention's
                # guard makes that step's output NaN anyway.
                x = x + table[:, positions.clamp(max=self.max_len - 1)][:, None]
        return x

    def forward(self, tokens: torch.Tensor, cache: Optional[KVCache] = None) -> torch.Tensor:
        N, B, T = tokens.shape
        if N != self.n_agents:
            raise ValueError(f"tokens carry {N} agents, model has {self.n_agents}")
        if cache is not None and self.seq_mesh is not None:
            raise ValueError("decode mode requires full/flash attention")
        if cache is not None:
            positions = cache.index + torch.arange(T, device=tokens.device)
        elif self.seq_mesh is not None:
            n_shards = self.seq_mesh.size
            if T * n_shards > self.max_len:
                raise ValueError(
                    f"global sequence length {T * n_shards} (local {T} x "
                    f"{n_shards} shards) exceeds max_len {self.max_len}"
                )
            positions = self.seq_mesh.agent * T + torch.arange(T, device=tokens.device)
        else:
            if T > self.max_len:
                raise ValueError(
                    f"sequence length {T} exceeds max_len {self.max_len}; "
                    "out-of-range positions would silently clamp"
                )
            positions = torch.arange(T, device=tokens.device)
        x = self.embed_tokens(self.embed, getattr(self, "pos_embed", None), tokens, positions,
                              cache is not None)
        for layer, blk in enumerate(self.blocks):
            x = blk(x, positions, cache, layer)
        if cache is not None:
            cache.index += T
            cache.fresh = False
        logits = self.head(self.ln_f(x))
        return logits.to(torch.float32)


# ---------------------------------------------------------------------- #
# Generation                                                             #
# ---------------------------------------------------------------------- #
def validate_sampling(model: TransformerLM, prompt_len: int, steps: int, key,
                      temperature: float, top_k: Optional[int],
                      top_p: Optional[float]) -> None:
    """The :func:`generate` argument contract (the reference's, with its
    texts; ``key`` is a ``torch.Generator`` here)."""
    if prompt_len + steps > model.max_len:
        raise ValueError(
            f"prompt ({prompt_len}) + steps ({steps}) exceeds max_len "
            f"{model.max_len}"
        )
    if temperature > 0.0 and key is None:
        raise ValueError("sampling (temperature > 0) requires a PRNG key")
    if (top_k is not None or top_p is not None) and temperature <= 0.0:
        raise ValueError(
            "top_k/top_p shape the SAMPLING distribution; greedy decoding "
            "(temperature=0) ignores them — pass temperature > 0"
        )
    if top_k is not None and not 1 <= top_k <= model.vocab_size:
        raise ValueError(
            f"top_k must be in [1, vocab_size={model.vocab_size}], "
            f"got {top_k}"
        )
    if top_p is not None and not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


def truncate_logits(logits: torch.Tensor, temperature: float, top_k: Optional[int] = None,
                    top_p: Optional[float] = None) -> torch.Tensor:
    """``logits / temperature`` with the candidates outside the top-k and
    then outside the nucleus set to -inf, exactly as the reference's
    ``pick`` (``transformer.py:558-583``): top-k keeps every logit not
    below the k-th largest; top-p ranks by probability and keeps each
    token whose EXCLUSIVE prefix mass is below p (so the top token always
    survives), masking by the kept set's smallest logit."""
    scaled = logits / temperature
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    if top_p is not None:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        n_keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
        thresh = srt.gather(-1, n_keep - 1)
        scaled = scaled.masked_fill(scaled < thresh, float("-inf"))
    return scaled


def sample_fn(temperature: float, top_k: Optional[int] = None, top_p: Optional[float] = None):
    """``pick(logits, generator, dtype) -> token``: greedy argmax at
    temperature 0, else a draw from ``softmax`` of the truncated logits
    (:func:`truncate_logits`) by the Gumbel-max rule with uniforms from
    ``generator``.  The draws cannot follow the reference's
    ``jax.random.categorical`` bits: the same distribution, other
    samples.  Nothing is read back to the host.  With ``rows`` (a slice
    of the batch axis, dim 1) the logits are those rows of a ``batch``-row
    batch: the uniforms are drawn for the whole batch and the rows kept,
    so a rank holding some rows draws what one process would."""

    def pick(logits, generator, dtype, rows=None, batch=None):
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(dtype)
        scaled = truncate_logits(logits, temperature, top_k, top_p)
        shape = scaled.shape if rows is None else (scaled.shape[0], batch) + scaled.shape[2:]
        u = torch.rand(shape, generator=generator, device=scaled.device)
        if rows is not None:
            u = u[:, rows]
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        return (scaled + gumbel).argmax(dim=-1).to(dtype)

    return pick


@torch.no_grad()
def generate(model: TransformerLM, prompt: torch.Tensor, steps: int, *,
             key: Optional[torch.Generator] = None, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """Autoregressive generation with a KV cache: one prefill forward
    over the prompt, then ``steps`` single-token forwards, in eval mode
    (no dropout).

    ``prompt`` is (N, B, Tp) integer tokens for an ``n_agents=N`` model
    (agent ``a`` decodes from its own parameters); returns the (N, B,
    steps) generated tokens on the model's device, in the prompt's dtype.
    ``temperature=0`` is greedy argmax; otherwise tokens are sampled from
    the temperature-scaled, top-k- then top-p-truncated distribution with
    draws from ``key``, a ``torch.Generator`` on the model's device
    (:func:`sample_fn`).  As in the reference, the last step computes one
    token past the returned ones; nothing is read to the host until the
    caller reads the result.
    """
    N, B, Tp = prompt.shape
    validate_sampling(model, Tp, steps, key, temperature, top_k, top_p)
    pick = sample_fn(float(temperature), top_k, top_p)
    dev = model.flat_params.device
    tokens = prompt.to(dev, torch.long)
    was_training = model.training
    model.eval()
    try:
        cache = model.init_cache(B)
        tok = pick(model(tokens, cache)[:, :, -1], key, torch.long)
        out = torch.empty((N, B, steps), dtype=torch.long, device=dev)
        for t in range(steps):
            out[:, :, t] = tok
            tok = pick(model(tok[..., None], cache)[:, :, -1], key, torch.long)
    finally:
        model.train(was_training)
    return out.to(prompt.dtype)
