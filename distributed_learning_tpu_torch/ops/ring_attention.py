"""Sequence parallelism on ``torch.distributed``: ring attention, Ulysses
all-to-all and ring-flash attention (port of
``distributed_learning_tpu/ops/ring_attention.py``).

Each rank of a sequence axis (an :class:`~distributed_learning_tpu_torch.
parallel.multihost.AgentMesh`, ``mesh``) holds one contiguous block of
the sequence, ``(B, T/n, H, D)``, rank ``i`` the tokens ``[i T/n, (i+1)
T/n)``:

* :func:`ring_attention`: the blockwise online-softmax recurrence in
  float32 (the reference's einsums).  Each rank keeps its Q block; the
  K/V block and its source index travel one hop around the ring a step,
  so after ``n - 1`` hops every query has seen every key once.
* :func:`ulysses_attention`: one all-to-all from sequence-sharded to
  head-sharded with the whole sequence, :func:`attention_reference`, and
  the inverse all-to-all (``H % n == 0``).
* :func:`ring_flash_attention`: the ring with the flash kernels as the
  per-block compute (:func:`~distributed_learning_tpu_torch.ops.
  flash_attention.flash_fwd` with the logsumexp): the diagonal block
  causal, a block from the past non-causal, a block from the future
  skipped (no launch).  The blocks combine by the max-shifted recurrence
  with the reference's ``isfinite`` guards.  On the card every live
  block launches kernel A, and the backward runs the pre-pass, B and C
  on it; on the CPU the plain versions run.
* :func:`make_ring_attention`: any of the three over global ``(B, T, H,
  D)`` tensors replicated on the ranks, split along T.

Gradients across ranks: the reference differentiates through
``lax.ppermute``, which transposes itself; gloo's send and recv do not.
The ring is therefore one ``torch.autograd.Function`` per call whose
forward runs every hop and keeps the K/V blocks it saw, and whose
backward moves the K/V gradients home around the ring the other way
(``n - 1`` hops, each rank's contribution added as the accumulator
passes).  A differentiable shift inside the autograd graph would not do:
under causal skipping rank ``r`` uses only the blocks from ranks
``<= r``, so the backward of the later shifts would run on some ranks
and not on others, and the exchanges would no longer pair up.  Here
every rank posts the same exchanges in the same order, forward and
backward, whatever it skipped.  The ring-flash backward recomputes the
block combine under autograd to get each block's output and logsumexp
cotangents, and hands the latter to the backward kernels as ``dadj``, as
the reference's custom VJP receives it.  Ulysses' all-to-alls are one
``Function`` each way, whose backward is the other one.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from distributed_learning_tpu_torch.ops import flash_attention as fa

__all__ = ["attention_reference", "ring_attention", "ulysses_attention",
           "ring_flash_attention", "make_ring_attention"]


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


# --------------------------------------------------------------------- #
# The ring's transport                                                  #
# --------------------------------------------------------------------- #
def _hop(mesh, tensors: Sequence[torch.Tensor], forward: bool = True) -> List[torch.Tensor]:
    """Every tensor moved one hop around the ring in one exchange: to the
    next rank (``forward``) or the previous one, each rank receiving
    from the other side."""
    n, a = mesh.size, mesh.agent
    to, frm = ((a + 1) % n, (a - 1) % n) if forward else ((a - 1) % n, (a + 1) % n)
    out = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    mesh.exchange([(to, t.contiguous()) for t in tensors], [(frm, t) for t in out])
    return out


def _blocks(mesh, k: torch.Tensor, v: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor, int]]:
    """The K/V blocks this rank sees, step by step, with the index of the
    rank each came from: its own first, then ``n - 1`` hops of the block
    and its source index (a one-element tensor, read on the host)."""
    src = torch.full((1,), mesh.agent, dtype=torch.int64, device=k.device)
    out = [(k, v, mesh.agent)]
    for _ in range(mesh.size - 1):
        k, v, src = _hop(mesh, (k, v, src))
        out.append((k, v, int(src[0])))
    return out


def _send_home(mesh, dks: Sequence[torch.Tensor], dvs: Sequence[torch.Tensor]):
    """The gradients of the blocks seen at each step, returned to the rank
    each came from: an accumulator walks the ring backwards (``n - 1``
    hops), each rank adding its step's term as it passes; returns this
    rank's own block's total ``(dk, dv)``."""
    dk, dv = dks[-1], dvs[-1]
    for s in range(len(dks) - 2, -1, -1):
        dk, dv = _hop(mesh, (dk, dv), forward=False)
        dk.add_(dks[s])
        dv.add_(dvs[s])
    return dk, dv


def _positions(t: int, src: int, device) -> torch.Tensor:
    """The global positions of block ``src`` of length ``t``."""
    return src * t + torch.arange(t, device=device)


# --------------------------------------------------------------------- #
# Ring attention (einsum blocks)                                        #
# --------------------------------------------------------------------- #
def _block_accumulate(carry, q, k, v, q_pos, kv_pos, scale, causal):
    """One online-softmax step against a K/V block: ``carry = (acc, l,
    m)``, the running weighted values (B, Tq, H, D), the denominator and
    the row max (B, H, Tq), all float32 (the reference's recurrence and
    guards, op for op)."""
    acc, l, m = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if causal:
        mask = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None], s, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    acc_new = acc * corr.transpose(1, 2)[..., None] + pv
    return acc_new, l_new, m_new


def _ring_outputs(q, blocks, q_pos, scale, causal, t):
    B, _, H, D = q.shape
    acc = torch.zeros((B, t, H, D), dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, t), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, t), -math.inf, dtype=torch.float32, device=q.device)
    for k, v, src in blocks:
        acc, l, m = _block_accumulate((acc, l, m), q, k, v, q_pos,
                                      _positions(t, src, q.device), scale, causal)
    l = torch.clamp_min(l, 1e-30)
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype)


class _Ring(torch.autograd.Function):
    """The einsum ring: the forward rotates K/V and keeps every block; the
    backward recomputes the recurrence under autograd on this rank and
    sends each block's gradient home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale):
        t = q.shape[1]
        blocks = _blocks(mesh, k, v)
        q_pos = _positions(t, mesh.agent, q.device)
        out = _ring_outputs(q, blocks, q_pos, scale, causal, t)
        ctx.mesh, ctx.cfg, ctx.srcs = mesh, (causal, scale), [s for _, _, s in blocks]
        ctx.save_for_backward(q, *[b for k_, v_, _ in blocks for b in (k_, v_)])
        return out

    @staticmethod
    def backward(ctx, dout):
        q, *kv = ctx.saved_tensors
        causal, scale = ctx.cfg
        t = q.shape[1]
        with torch.enable_grad():
            q_ = q.detach().requires_grad_(True)
            ks = [x.detach().requires_grad_(True) for x in kv[0::2]]
            vs = [x.detach().requires_grad_(True) for x in kv[1::2]]
            q_pos = _positions(t, ctx.mesh.agent, q.device)
            out = _ring_outputs(q_, list(zip(ks, vs, ctx.srcs)), q_pos, scale, causal, t)
            grads = torch.autograd.grad(out, [q_] + ks + vs, dout)
        n = len(ks)
        dks = [g.to(torch.float32) for g in grads[1:1 + n]]
        dvs = [g.to(torch.float32) for g in grads[1 + n:]]
        dk, dv = _send_home(ctx.mesh, dks, dvs)
        return grads[0], dk.to(q.dtype), dv.to(q.dtype), None, None, None


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                   causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Exact blockwise ring attention on this rank's (B, T/n, H, D) block
    of a sequence split over ``mesh`` (the sequence axis).  Differentiable
    in ``q``, ``k`` and ``v``; every rank of the axis must call it."""
    return _Ring.apply(q, k, v, mesh, bool(causal), float(_scale(q, sm_scale)))


# --------------------------------------------------------------------- #
# Ulysses (all-to-all)                                                  #
# --------------------------------------------------------------------- #
def _all_to_all(mesh, x: torch.Tensor, split: int, concat: int) -> torch.Tensor:
    """The reference's tiled ``all_to_all``: ``x`` split into ``n`` chunks
    along ``split``, chunk ``j`` to rank ``j``; the chunks received
    concatenated along ``concat`` in rank order."""
    chunks = [c.contiguous() for c in x.chunk(mesh.size, dim=split)]
    return torch.cat(mesh.all_to_all(chunks), dim=concat)


class _SeqToHeads(torch.autograd.Function):
    """(B, T/n, H, D) -> (B, T, H/n, D) for q, k and v together; the
    backward is the inverse exchange of the three gradients."""

    @staticmethod
    def forward(ctx, mesh, *xs):
        ctx.mesh = mesh
        return tuple(_all_to_all(mesh, x, 2, 1) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(_all_to_all(ctx.mesh, g, 1, 2) for g in gs)


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, x):
        ctx.mesh = mesh
        return _all_to_all(mesh, x, 1, 2)

    @staticmethod
    def backward(ctx, g):
        return None, _all_to_all(ctx.mesh, g, 2, 1)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                      causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """All-to-all sequence parallelism: this rank's (B, T/n, H, D) block
    goes head-sharded with the whole sequence (B, T, H/n, D), attends
    with :func:`attention_reference` and comes back.  Needs ``H % n ==
    0``."""
    n, H = mesh.size, q.shape[2]
    if H % n != 0:
        raise ValueError(f"ulysses needs heads ({H}) divisible by axis size ({n})")
    qh, kh, vh = _SeqToHeads.apply(mesh, q, k, v)
    out = attention_reference(qh, kh, vh, causal=causal, sm_scale=sm_scale)
    return _HeadsToSeq.apply(mesh, out)


# --------------------------------------------------------------------- #
# Ring-flash attention (the flash kernels a block)                      #
# --------------------------------------------------------------------- #
def _combine(parts):
    """The reference's max-shifted combine of per-block ``(out_i,
    lse_i)`` in step order: ``(acc, l)`` in float32.  A skipped (future)
    block is left out; in the reference it enters with ``lse = -inf``
    and its guards make it an exact no-op, the diagonal block coming
    first."""
    acc = l = m = None
    for out_i, lse_i in parts:
        o = out_i.to(torch.float32)
        if acc is None:
            acc, l, m = torch.zeros_like(o), torch.zeros_like(lse_i), torch.full_like(
                lse_i, -math.inf)
        m_new = torch.maximum(m, lse_i)
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        beta = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - safe_m), 0.0)
        acc = acc * alpha.transpose(1, 2)[..., None] + o * beta.transpose(1, 2)[..., None]
        l = l * alpha + beta
        m = m_new
    l = torch.clamp_min(l, 1e-30)
    return acc / l.transpose(1, 2)[..., None]


class _RingFlash(torch.autograd.Function):
    """Ring-flash: kernel A a live block in the forward; in the backward
    the combine's cotangents, then the pre-pass, B and C a live block
    with ``dadj`` = the block's logsumexp cotangent, and the K/V
    gradients sent home."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale):
        a = mesh.agent
        live, saved = [], []
        for step, (kb, vb, src) in enumerate(_blocks(mesh, k, v)):
            if causal and src > a:
                continue  # entirely in this block's future: no launch
            diag = causal and src == a
            o_i, lse_i = fa.flash_fwd(q, kb, vb, scale, diag, None, with_lse=True)
            live.append((step, diag))
            saved += [kb, vb, o_i, lse_i]
        out = _combine(list(zip(saved[2::4], saved[3::4]))).to(q.dtype)
        ctx.mesh, ctx.scale, ctx.live = mesh, scale, live
        ctx.save_for_backward(q, *saved)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, *saved = ctx.saved_tensors
        kbs, vbs, outs, lses = saved[0::4], saved[1::4], saved[2::4], saved[3::4]
        with torch.enable_grad():
            os_ = [o.detach().requires_grad_(True) for o in outs]
            ls_ = [x.detach().requires_grad_(True) for x in lses]
            out = _combine(list(zip(os_, ls_))).to(q.dtype)
            grads = torch.autograd.grad(out, os_ + ls_, dout)
        dos, dlses = grads[:len(os_)], grads[len(os_):]
        zeros = torch.zeros(kbs[0].shape, dtype=torch.float32, device=q.device)
        dks, dvs = [zeros] * ctx.mesh.size, [zeros] * ctx.mesh.size
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        for (step, diag), kb, vb, o_i, do_i, lse_i, dlse_i in zip(
                ctx.live, kbs, vbs, outs, dos, lses, dlses):
            dq_i, dk_i, dv_i = fa._layer_backward(q, kb, vb, o_i, do_i.contiguous(), lse_i,
                                                  dlse_i.to(torch.float32).contiguous(),
                                                  ctx.scale, diag, None)
            dq += dq_i
            dks[step], dvs[step] = dk_i.to(torch.float32), dv_i.to(torch.float32)
        dk, dv = _send_home(ctx.mesh, dks, dvs)
        return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), None, None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, mesh,
                         causal: bool = True, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention with the flash kernels as the per-block compute, on
    this rank's (B, T/n, H, D) block of a sequence split over ``mesh``.
    Each live block's ``(out_i, lse_i)`` comes from kernel A and the
    blocks combine exactly (``out = sum_i out_i exp(lse_i - lse)``).
    Differentiable: the backward kernels B and C (after the pre-pass)
    run a live block, the logsumexp's cotangent their ``dadj``."""
    return _RingFlash.apply(q, k, v, mesh, bool(causal), float(_scale(q, sm_scale)))


# --------------------------------------------------------------------- #
# Over global arrays                                                    #
# --------------------------------------------------------------------- #
class _Shard(torch.autograd.Function):
    """This rank's block of a tensor replicated on the ranks (along
    ``dim``); the backward gathers every rank's block gradient, which is
    the gradient of the replicated tensor when every rank computes the
    same loss."""

    @staticmethod
    def forward(ctx, mesh, x, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return x.chunk(mesh.size, dim=dim)[mesh.agent].contiguous()

    @staticmethod
    def backward(ctx, g):
        return None, _gather(ctx.mesh, g, ctx.dim), None


class _Unshard(torch.autograd.Function):
    """Every rank's block concatenated along ``dim`` (the same tensor on
    every rank); the backward keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, mesh, x, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _gather(mesh, x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, g.chunk(ctx.mesh.size, dim=ctx.dim)[ctx.mesh.agent].contiguous(), None


def _gather(mesh, x: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.cat(list(mesh.all_gather(x.contiguous()).unbind(0)), dim=dim)


_STRATEGIES = {"ring": ring_attention, "ulysses": ulysses_attention,
               "ring_flash": ring_flash_attention}


def make_ring_attention(mesh, *, strategy: str = "ring",
                        causal: bool = True) -> Callable[..., torch.Tensor]:
    """Sequence-parallel attention over global tensors: returns ``fn(q,
    k, v) -> out`` taking the full (B, T, H, D) tensors (the same on every
    rank of ``mesh``), running ``strategy`` (``"ring"``, ``"ulysses"`` or
    ``"ring_flash"``) on this rank's block of T, and returning the full
    output on every rank.  Differentiable as one global function when
    every rank computes the same loss."""
    if strategy not in _STRATEGIES:
        raise KeyError(strategy)
    impl = _STRATEGIES[strategy]

    def fn(q, k, v):
        T = q.shape[1]
        if T % mesh.size:
            raise ValueError(f"sequence length {T} does not split over {mesh.size} ranks")
        local = [_Shard.apply(mesh, x, 1) for x in (q, k, v)]
        return _Unshard.apply(mesh, impl(*local, mesh=mesh, causal=causal), 1)

    return fn
