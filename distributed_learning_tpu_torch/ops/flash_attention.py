"""Flash attention on Hopper: forward and backward CUDA kernels with their
plain PyTorch versions (port of ``distributed_learning_tpu/ops/
flash_attention.py``).

Three kernels, in ``csrc/flash_attention.cu``, each behind a wrapper that
counts its launches:

* :data:`flash_fwd` — the online-softmax forward (TPU ``_flash_kernel``),
  with or without the per-row logsumexp ``lse``;
* :data:`flash_bwd_dq` — dQ for one Q tile per block (``_flash_dq_kernel``);
* :data:`flash_bwd_dkv` — dK and dV for one K/V tile per block
  (``_flash_dkv_kernel``).

A wrapper given CUDA tensors launches its kernel (or raises); given CPU
tensors it runs its plain version, which repeats the kernel's arithmetic
with whole-matrix torch ops: float32 scores scaled after the product,
masked scores at the finite -1e30, P rounded to V's dtype only as the P.V
operand, dS rounded to K's / Q's dtype before its products.  There is no
fallback from one to the other.

Layout: the public functions take (B, T, H, D) like the reference's.  The
kernels read Q, K and V in place through their strides (the transformer
passes strided views of its fused QKV projection), and write O, dQ, dK,
dV contiguous in (B, T, H, D); lse and its cotangent are (B, H, T)
float32 — no 128-lane padding, unlike the TPU layout.

Two ``torch.autograd.Function``s bind them, mirroring the reference's two
custom VJPs: :class:`_Flash` (``_flash``: window, no lse consumer, so the
backward passes no ``dadj``) and :class:`_FlashLse` (``_flash_lse``: lse
is an output, its cotangent enters both backward kernels as ``dadj``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from distributed_learning_tpu_torch.ops import _build

__all__ = [
    "flash_attention",
    "flash_attention_with_lse",
    "flash_fwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "plain_fwd",
    "plain_bwd_dq",
    "plain_bwd_dkv",
    "KERNELS",
    "reset_launch_counts",
]

_NEG_INF = -1e30  # large-but-finite, as the TPU kernels
_HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------- #
# Plain versions                                                        #
# --------------------------------------------------------------------- #
def _scores(q, k, scale, causal, window):
    """Scaled float32 scores (B, H, Tq, Tk) with the kernels' masking."""
    s = torch.einsum(
        "bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)
    ) * scale
    if causal:
        T = q.shape[1]
        rows = torch.arange(T, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        keep = cols <= rows
        if window is not None:
            keep &= cols >= rows - (window - 1)
        s = s.masked_fill(~keep, _NEG_INF)
    return s


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round float32 values to ``dtype``'s precision, kept in float32."""
    return x.to(dtype).to(torch.float32)


def plain_fwd(q, k, v, scale, causal, window, with_lse):
    """Plain version of the forward kernel: ``(o, lse or None)``."""
    s = _scores(q, k, scale, causal, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", _round(p, v.dtype), v.to(torch.float32))
    o = (acc / l.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l)).squeeze(-1) if with_lse else None
    return o, lse


def _probs_and_dscores(q, k, v, o, do, lse, dadj, scale, causal, window):
    s = _scores(q, k, scale, causal, window)
    p = torch.exp(s - lse[..., None])  # masked entries -> 0
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1)  # (B, T, H)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(torch.float32), v.to(torch.float32))
    adj = delta.permute(0, 2, 1)[..., None]
    if dadj is not None:
        adj = adj - dadj[..., None]
    return p, p * (dp - adj)


def plain_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window):
    """Plain version of the dQ kernel."""
    _, ds = _probs_and_dscores(q, k, v, o, do, lse, dadj, scale, causal, window)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", _round(ds, k.dtype), k.to(torch.float32))
    return dq.to(q.dtype)


def plain_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window):
    """Plain version of the dK/dV kernel: ``(dk, dv)``."""
    p, ds = _probs_and_dscores(q, k, v, o, do, lse, dadj, scale, causal, window)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, do.dtype), do.to(torch.float32))
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", _round(ds, q.dtype), q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# Kernel wrappers                                                       #
# --------------------------------------------------------------------- #
def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_qkv(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one (B, T, H, D) shape; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(
            f"q, k, v must share a dtype in float32/bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.device.type == "cuda":
        D = q.shape[-1]
        if D not in _HEAD_DIMS:
            raise ValueError(f"head dim {D} not supported by the kernels; want one of {_HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(-1) != 1:
                raise ValueError(f"{name} must be unit-stride in the head dim")
    elif q.device.type != "cpu":
        raise ValueError(f"unsupported device {q.device}")


def _params(q, k, v, scale, causal, window, **ptrs) -> _build.FlashParams:
    B, T, H, D = q.shape
    p = _build.FlashParams()
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    for name, t in ptrs.items():
        setattr(p, name, _ptr(t))
    p.q_sb, p.q_st, p.q_sh = q.stride(0), q.stride(1), q.stride(2)
    p.k_sb, p.k_st, p.k_sh = k.stride(0), k.stride(1), k.stride(2)
    p.v_sb, p.v_st, p.v_sh = v.stride(0), v.stride(1), v.stride(2)
    p.B, p.H, p.T, p.D = B, H, T, D
    p.scale = float(scale)
    p.causal = int(bool(causal))
    p.window = int(window) if window is not None else 0
    p.dtype = _DTYPES[q.dtype]
    return p


class _Kernel:
    """One CUDA entry point with its launch counter.  ``launches`` counts
    calls that launched the kernel; plain-version calls do not count."""

    def __init__(self, name: str, entry: str, replaces: str):
        self.name = name
        self.entry = entry
        self.replaces = replaces
        self.launches = 0

    def launch(self, params: _build.FlashParams, device: torch.device) -> None:
        lib = _build.load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, self.entry)(ctypes.byref(params), ctypes.c_void_p(stream))
        _build.check(code, self.name)
        self.launches += 1


_FWD = _Kernel("flash_fwd", "dlt_flash_fwd",
               "distributed_learning_tpu/ops/flash_attention.py:118")
_DQ = _Kernel("flash_bwd_dq", "dlt_flash_bwd_dq",
              "distributed_learning_tpu/ops/flash_attention.py:178")
_DKV = _Kernel("flash_bwd_dkv", "dlt_flash_bwd_dkv",
               "distributed_learning_tpu/ops/flash_attention.py:234")
KERNELS = {k.name: k for k in (_FWD, _DQ, _DKV)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def flash_fwd(q, k, v, scale, causal, window, with_lse):
    """Forward kernel A: ``(o, lse or None)`` for (B, T, H, D) inputs."""
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return plain_fwd(q, k, v, scale, causal, window, with_lse)
    B, T, H, D = q.shape
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _FWD.launch(_params(q, k, v, scale, causal, window, o=o, lse=lse), q.device)
    return o, lse


def _bwd_inputs(q, o, do, lse, dadj):
    shape = q.shape
    B, T, H, _ = shape
    if o.shape != shape or do.shape != shape:
        raise ValueError("o and do must have q's (B, T, H, D) shape")
    if lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError("lse must be (B, H, T) float32")
    if dadj is not None and (dadj.shape != (B, H, T) or dadj.dtype != torch.float32):
        raise ValueError("dadj must be (B, H, T) float32")
    if q.device.type == "cuda":
        o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
        dadj = None if dadj is None else dadj.contiguous()
    return o, do, lse, dadj


def flash_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window):
    """Backward kernel B: dQ.  ``dadj`` (the lse cotangent) may be None."""
    _check_qkv(q, k, v)
    o, do, lse, dadj = _bwd_inputs(q, o, do, lse, dadj)
    if q.device.type == "cpu":
        return plain_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _DQ.launch(_params(q, k, v, scale, causal, window, o=o, lse=lse, dout=do,
                       dadj=dadj, dq=dq), q.device)
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window):
    """Backward kernel C: ``(dK, dV)``.  ``dadj`` may be None."""
    _check_qkv(q, k, v)
    o, do, lse, dadj = _bwd_inputs(q, o, do, lse, dadj)
    if q.device.type == "cpu":
        return plain_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    _DKV.launch(_params(q, k, v, scale, causal, window, o=o, lse=lse, dout=do,
                        dadj=dadj, dk=dk, dv=dv), q.device)
    return dk, dv


# --------------------------------------------------------------------- #
# Autograd                                                              #
# --------------------------------------------------------------------- #
class _Flash(torch.autograd.Function):
    """``_flash``: the training forward saves lse; the backward passes no
    ``dadj`` (no lse consumer)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window):
        o, lse = flash_fwd(q, k, v, scale, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (scale, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal, window = ctx.cfg
        dq = flash_bwd_dq(q, k, v, o, do, lse, None, scale, causal, window)
        dk, dv = flash_bwd_dkv(q, k, v, o, do, lse, None, scale, causal, window)
        return dq, dk, dv, None, None, None


class _FlashLse(torch.autograd.Function):
    """``_flash_lse``: lse is an output; d loss/d s_rc = p_rc * dlse_r folds
    into both backward kernels as the ``dadj`` row term."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = flash_fwd(q, k, v, scale, causal, None, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (scale, causal)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        scale, causal = ctx.cfg
        dadj = dlse.to(torch.float32)
        dq = flash_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, None)
        dk, dv = flash_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, None)
        return dq, dk, dv, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Fused attention on (B, T, H, D); any T.

    Differentiable through the backward kernels.  Without grad (the eval
    path) the forward kernel runs without writing lse, as the reference's
    primal does.  ``window`` (requires ``causal``) is sliding-window
    attention: row ``r`` attends to keys ``[r - window + 1, r]``, and
    tiles outside the band are skipped in all three kernels.
    """
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
    if not _needs_grad(q, k, v):
        return flash_fwd(q, k, v, scale, causal, window, with_lse=False)[0]
    return _Flash.apply(q, k, v, scale, causal, window)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like :func:`flash_attention` but also returns the per-row logsumexp
    of the scaled scores, shape (B, H, T) float32 — what lets independent
    attention pieces be combined exactly.  Fully differentiable: the lse
    cotangent enters the backward kernels as ``dadj``."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not _needs_grad(q, k, v):
        return flash_fwd(q, k, v, scale, causal, None, with_lse=True)
    return _FlashLse.apply(q, k, v, scale, causal)
