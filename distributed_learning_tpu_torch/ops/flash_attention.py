"""Flash attention on Hopper: forward and backward CUDA kernels with their
plain PyTorch versions (port of ``distributed_learning_tpu/ops/
flash_attention.py``).

Three kernels and a pre-pass, in ``csrc/``, each behind a wrapper that
counts its launches, per body:

* :data:`flash_fwd` — the online-softmax forward (TPU ``_flash_kernel``),
  with or without the per-row logsumexp ``lse``;
* :data:`flash_bwd_dq` — dQ for one Q tile per block (``_flash_dq_kernel``);
* :data:`flash_bwd_dkv` — dK and dV for one K/V tile per block
  (``_flash_dkv_kernel``);
* :data:`flash_bwd_rowterm` — the backward's pre-pass, ``dadj -
  rowsum(dO * O)`` once per row, which the wgmma and the wide dQ and
  dK/dV bodies read (part of their port, not a TPU kernel of its own).

All three kernels have three bodies: ``"wgmma"`` (tensor cores,
TMA-fed, ``csrc/flash_attention_sm90.cu``) for bfloat16 with head dim 32
(64-byte rows), 64, 128 or 256, and for the bfloat16 forward at every
multiple of 128 above 256 (O's columns split across blocks, S formed over
the whole head dim in each); ``"cuda_core"``
(``csrc/flash_attention.cu``) for float32 at head dims up to 256, where
wgmma has no float32-exact product; and
``"cuda_core_wide"`` (the same file) for every multiple of 128 above 256
(float32, and bfloat16 dQ and dK/dV),
which walks the head dim in 128-column chunks and keeps its running O,
dQ, dK and dV rows in a float32 scratch the wrapper allocates, so no head
dim is too large for it.  The kernels take head dims 32, 64,
128, 256 and the multiples of 128 above; a call of another head dim runs
at the next of them (:func:`kernel_head_dim`), as the reference's
``_prep_blocks`` pads to its lanes: Q, K, V (and O, dO)
zero-padded, the scale the caller's (from the true D), O, dQ, dK and dV
sliced back.  Zero columns leave Q.K^T, rowsum(dO * O) and the padded
output columns exactly zero, so the kernels need no change.  The C++
dispatcher picks the body by (kernel, dtype, D) alone; :func:`wgmma_body`
mirrors it.  A bfloat16 view that TMA cannot read (base or a stride not
a multiple of 16 bytes) raises instead of taking another body.  A
layer's backward whose dQ or dK/dV runs the wgmma or the wide body runs
the pre-pass once and hands its result to both backward kernels.

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

Under an open operation counter (``obs/cost.py``, a step's cost
profile) the forward counts as 4 and a layer's backward as 10 FLOPs per
live (query, key) pair per head dimension — each product of the function
once (QK^T and PV; S again, dP, dV, dQ and dK), over the causal (or
windowed) half of the scores, whatever body runs it: aten never sees a
kernel launch, and on the CPU the counter's count of the plain version's
full-score products is replaced.

Two ``torch.autograd.Function``s bind them, mirroring the reference's two
custom VJPs: :class:`_Flash` (``_flash``: window, no lse consumer, so the
backward passes no ``dadj``) and :class:`_FlashLse` (``_flash_lse``: lse
is an output, its cotangent enters both backward kernels as ``dadj``).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import math
from typing import Iterator, List, Optional, Tuple

import torch

from distributed_learning_tpu_torch.obs.cost import counted_as, counting
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
    "plain_bwd_rowterm",
    "flash_bwd_rowterm",
    "wgmma_body",
    "wide_body",
    "kernel_head_dim",
    "padded_fwd",
    "padded_bwd_dq",
    "padded_bwd_dkv",
    "padded_bwd_rowterm",
    "live_pairs",
    "KERNELS",
    "reset_launch_counts",
    "record_launches",
    "count_replays",
]

_NEG_INF = -1e30  # large-but-finite, as the TPU kernels
_HEAD_DIMS = (32, 64, 128, 256)
_WIDE_CHUNK = 128  # the wide bodies' head-dim chunk (kWideChunk)
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


def plain_bwd_rowterm(o, do, dadj):
    """Plain version of the backward's pre-pass: ``dadj - rowsum(dO * O)``
    as (B, H, T) float32 (``-rowsum`` without ``dadj``)."""
    delta = (do.to(torch.float32) * o.to(torch.float32)).sum(-1).permute(0, 2, 1)
    return -delta if dadj is None else dadj - delta


def _probs_and_dscores(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm):
    s = _scores(q, k, scale, causal, window)
    p = torch.exp(s - lse[..., None])  # masked entries -> 0
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(torch.float32), v.to(torch.float32))
    if rowterm is None:
        rowterm = plain_bwd_rowterm(o, do, dadj)
    return p, p * (dp + rowterm[..., None])


def plain_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=None):
    """Plain version of the dQ kernel; ``rowterm``, when given, is the
    pre-pass's result for these ``o``, ``do`` and ``dadj``."""
    _, ds = _probs_and_dscores(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", _round(ds, k.dtype), k.to(torch.float32))
    return dq.to(q.dtype)


def plain_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=None):
    """Plain version of the dK/dV kernel: ``(dk, dv)``; ``rowterm`` as in
    :func:`plain_bwd_dq`."""
    p, ds = _probs_and_dscores(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round(p, do.dtype), do.to(torch.float32))
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", _round(ds, q.dtype), q.to(torch.float32))
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# Kernel wrappers                                                       #
# --------------------------------------------------------------------- #
def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


_KERNEL_NAMES = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def wgmma_body(dtype: torch.dtype, head_dim: int, kernel: Optional[str] = None) -> bool:
    """Whether ``kernel`` (``"flash_fwd"``, ``"flash_bwd_dq"`` or
    ``"flash_bwd_dkv"``) takes its wgmma/TMA body for this input:
    bfloat16 with head dim 32, 64, 128 or 256, whichever the kernel, and
    for the forward also every multiple of 128 above 256.  Without
    ``kernel``, whether all three do.  Mirrors ``uses_wgmma_body`` in
    ``csrc/flash_params.cuh``."""
    if kernel is None:
        return all(wgmma_body(dtype, head_dim, name) for name in _KERNEL_NAMES)
    if kernel not in _KERNEL_NAMES:
        raise ValueError(f"unknown kernel {kernel!r}; expected one of {_KERNEL_NAMES}")
    if dtype != torch.bfloat16:
        return False
    if head_dim in _HEAD_DIMS:
        return True
    return kernel == "flash_fwd" and wide_body(head_dim) and head_dim % _WIDE_CHUNK == 0


def kernel_head_dim(D: int) -> int:
    """The head dim the kernels run a call of head dim ``D`` at: the
    smallest of 32, 64, 128 and 256 that holds it, and above 256 the next
    multiple of 128 (the wide bodies'), as the reference pads any head
    dim to its 128 lanes."""
    for d in _HEAD_DIMS:
        if D <= d:
            return d
    return -(-int(D) // _WIDE_CHUNK) * _WIDE_CHUNK


def wide_body(head_dim: int) -> bool:
    """Whether a kernel head dim is above 256, where dQ, dK/dV and the
    float32 forward run the wide CUDA-core bodies (mirrors ``wide()`` in
    ``csrc/flash_attention.cu``) and the bfloat16 forward its wide wgmma
    body."""
    return head_dim > 256


def _pad(t: torch.Tensor, D: int) -> torch.Tensor:
    """``t`` zero-padded in its last dim up to ``D``."""
    if t.shape[-1] == D:
        return t
    return torch.nn.functional.pad(t, (0, D - t.shape[-1]))


def padded_fwd(fwd, q, k, v, scale, causal, window, with_lse):
    """``fwd`` (a forward with :func:`plain_fwd`'s signature) run at the
    kernels' head dim: Q, K, V zero-padded, O sliced back.  ``scale``
    stays the caller's."""
    D = q.shape[-1]
    Dp = kernel_head_dim(D)
    if Dp == D:
        return fwd(q, k, v, scale, causal, window, with_lse)
    o, lse = fwd(_pad(q, Dp), _pad(k, Dp), _pad(v, Dp), scale, causal, window, with_lse)
    return o[..., :D].contiguous(), lse


def padded_bwd_dq(bwd_dq, q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=None):
    """``bwd_dq`` (:func:`plain_bwd_dq`'s signature) at the kernels' head
    dim: Q, K, V, O and dO zero-padded, dQ sliced back."""
    D = q.shape[-1]
    Dp = kernel_head_dim(D)
    if Dp == D:
        return bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    q, k, v, o, do = (_pad(t, Dp) for t in (q, k, v, o, do))
    return bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window,
                  rowterm)[..., :D].contiguous()


def padded_bwd_dkv(bwd_dkv, q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=None):
    """``bwd_dkv`` (:func:`plain_bwd_dkv`'s signature) at the kernels'
    head dim: dK and dV sliced back."""
    D = q.shape[-1]
    Dp = kernel_head_dim(D)
    if Dp == D:
        return bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    q, k, v, o, do = (_pad(t, Dp) for t in (q, k, v, o, do))
    dk, dv = bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    return dk[..., :D].contiguous(), dv[..., :D].contiguous()


def padded_bwd_rowterm(bwd_rowterm, o, do, dadj):
    """``bwd_rowterm`` (:func:`plain_bwd_rowterm`'s signature) on O and
    dO zero-padded to the kernels' head dim; the row term is per row, so
    nothing is sliced."""
    Dp = kernel_head_dim(o.shape[-1])
    return bwd_rowterm(_pad(o, Dp), _pad(do, Dp), dadj)


def _check_tma(**tensors) -> None:
    """TMA reads a tile from a base and strides that are multiples of 16
    bytes; a view that breaks that raises (no other body is taken)."""
    for name, t in tensors.items():
        nbytes = t.element_size()
        bad = [s for s in t.stride()[:-1] if (s * nbytes) % 16]
        if t.data_ptr() % 16 or bad:
            raise ValueError(
                f"{name}: the wgmma/TMA kernels need a base address and strides that are "
                f"multiples of 16 bytes; got address % 16 = {t.data_ptr() % 16}, strides "
                f"{tuple(t.stride())} of {nbytes}-byte elements"
            )


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


# Open launch records, innermost last (see record_launches).
_RECORDING: List[collections.Counter] = []


@contextlib.contextmanager
def record_launches() -> Iterator[collections.Counter]:
    """Inside the block, each kernel launch is added to the yielded
    ``Counter`` (keyed ``(kernel name, body)``) instead of the kernels'
    counters.  A CUDA graph capture records its launches so, and adds the
    record once per replay (:func:`count_replays`), since a captured
    launch runs only when the graph is replayed; a warm-up whose work is
    undone records into a record it throws away."""
    rec: collections.Counter = collections.Counter()
    _RECORDING.append(rec)
    try:
        yield rec
    finally:
        _RECORDING.pop()  # blocks nest, so this one is the innermost


def count_replays(record: collections.Counter, times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture recorded ``record``:
    each recorded launch counts ``times`` on its kernel and body."""
    for (name, body), n in record.items():
        KERNELS[name].add(body, n * times)


class _Kernel:
    """One CUDA entry point with its launch counters.  ``launches`` counts
    launches that ran the kernel, ``by_body`` the same per body;
    plain-version calls do not count, a launch captured into a CUDA graph
    counts once per replay (:func:`record_launches`), and one captured
    outside a record not at all."""

    def __init__(self, name: str, entry: str, replaces: str, bodies=("cuda_core",)):
        self.name = name
        self.entry = entry
        self.replaces = replaces
        self.launches = 0
        self.by_body = dict.fromkeys(bodies, 0)

    def launch(self, params: _build.FlashParams, device: torch.device,
               body: str = "cuda_core") -> None:
        lib = _build.load_library()
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, self.entry)(ctypes.byref(params), ctypes.c_void_p(stream))
        _build.check(code, self.name)
        if _RECORDING:
            _RECORDING[-1][(self.name, body)] += 1
        elif not torch.cuda.is_current_stream_capturing():
            self.add(body, 1)

    def add(self, body: str, n: int) -> None:
        self.launches += n
        self.by_body[body] += n

    def reset(self) -> None:
        self.launches = 0
        self.by_body = dict.fromkeys(self.by_body, 0)


_TPU = "distributed_learning_tpu/ops/flash_attention.py"
_BODIES = ("wgmma", "cuda_core", "cuda_core_wide")
_FWD = _Kernel("flash_fwd", "dlt_flash_fwd", f"{_TPU}:118", _BODIES)
_DQ = _Kernel("flash_bwd_dq", "dlt_flash_bwd_dq", f"{_TPU}:178", _BODIES)
_DKV = _Kernel("flash_bwd_dkv", "dlt_flash_bwd_dkv", f"{_TPU}:234", _BODIES)
# Part of B's and C's port: the delta that _flash_dkv_kernel computes per
# block (:261), as _flash_dq_kernel does (:212), hoisted out of both
# backward kernels' loops.
_ROWTERM = _Kernel("flash_bwd_rowterm", "dlt_flash_bwd_rowterm", f"{_TPU}:261")
KERNELS = {k.name: k for k in (_FWD, _DQ, _DKV, _ROWTERM)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.reset()


def _body(q, kernel: str) -> str:
    """The body ``kernel`` runs for a call on ``q``, at the kernels' head dim."""
    D = kernel_head_dim(q.shape[-1])
    if wgmma_body(q.dtype, D, kernel):
        return "wgmma"
    return "cuda_core_wide" if wide_body(D) else "cuda_core"


def _needs_rowterm(q) -> bool:
    """Whether a backward on ``q`` reads the pre-pass's row term: when its
    dQ or its dK/dV runs the wgmma or the wide body (the CUDA-core bodies
    compute the row term themselves), whatever body the forward runs."""
    return any(_body(q, name) != "cuda_core" for name in ("flash_bwd_dq", "flash_bwd_dkv"))


def _scratch(q, n: int, body: str):
    """The wide CUDA-core bodies' float32 (B, H, T, D) scratch, ``n`` of
    them (None each for another body)."""
    if body != "cuda_core_wide":
        return (None,) * n
    B, T, H, D = q.shape
    return tuple(torch.empty((B, H, T, D), dtype=torch.float32, device=q.device)
                 for _ in range(n))


def live_pairs(B: int, H: int, Tq: int, Tk: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs the mask keeps, over ``B * H`` (batch, head)s:
    the causal half with its diagonal, ``T (T + 1) / 2`` a head, or a
    window's band."""
    if not causal:
        return B * H * Tq * Tk
    w = Tq if window is None else min(int(window), Tq)
    return B * H * (w * (w + 1) // 2 + (Tq - w) * w)


def _flops(q, causal, window, per_pair: int) -> float:
    """``per_pair`` FLOPs per live pair and head dimension (0 when no
    operation counter is open, which is never asked then)."""
    if not counting():
        return 0.0
    B, T, H, D = q.shape
    return float(per_pair * live_pairs(B, H, T, T, causal, window) * D)


def flash_fwd(q, k, v, scale, causal, window, with_lse):
    """Forward kernel A: ``(o, lse or None)`` for (B, T, H, D) inputs."""
    with counted_as(_flops(q, causal, window, 4)):
        return _flash_fwd(q, k, v, scale, causal, window, with_lse)


def _flash_fwd(q, k, v, scale, causal, window, with_lse):
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return plain_fwd(q, k, v, scale, causal, window, with_lse)
    return padded_fwd(_launch_fwd, q, k, v, scale, causal, window, with_lse)


def _launch_fwd(q, k, v, scale, causal, window, with_lse):
    B, T, H, D = q.shape
    body = _body(q, _FWD.name)
    if body == "wgmma":
        _check_tma(q=q, k=k, v=v)
    o = torch.empty((B, T, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, T), dtype=torch.float32, device=q.device)
           if with_lse else None)
    acc, = _scratch(q, 1, body)
    _FWD.launch(_params(q, k, v, scale, causal, window, o=o, lse=lse, acc=acc), q.device, body)
    return o, lse


def _bwd_inputs(q, o, do, lse, dadj, rowterm):
    shape = q.shape
    B, T, H, _ = shape
    if o.shape != shape or do.shape != shape:
        raise ValueError("o and do must have q's (B, T, H, D) shape")
    for name, t in (("lse", lse), ("dadj", dadj), ("rowterm", rowterm)):
        if t is not None and (t.shape != (B, H, T) or t.dtype != torch.float32):
            raise ValueError(f"{name} must be (B, H, T) float32")
    if q.device.type == "cuda":
        o, do, lse = o.contiguous(), do.contiguous(), lse.contiguous()
        dadj = None if dadj is None else dadj.contiguous()
        rowterm = None if rowterm is None else rowterm.contiguous()
    return o, do, lse, dadj, rowterm


def _bwd_rowterm(q, k, v, o, do, dadj, rowterm, body):
    """The row term a backward kernel on ``body`` reads: on the wgmma body
    (after the TMA rule) and the wide body the pre-pass's result, run here
    unless the caller passes it; on the CUDA-core body None, which
    computes its own."""
    if body == "cuda_core":
        return None
    if body == "wgmma":
        _check_tma(q=q, k=k, v=v, do=do)
    return flash_bwd_rowterm(o, do, dadj) if rowterm is None else rowterm


def flash_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=None):
    """Backward kernel B: dQ.  ``dadj`` (the lse cotangent) may be None.
    ``rowterm`` is the pre-pass's result, as for :func:`flash_bwd_dkv`."""
    _check_qkv(q, k, v)
    o, do, lse, dadj, rowterm = _bwd_inputs(q, o, do, lse, dadj, rowterm)
    if q.device.type == "cpu":
        return plain_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    return padded_bwd_dq(_launch_dq, q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)


def _launch_dq(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm):
    body = _body(q, _DQ.name)
    rowterm = _bwd_rowterm(q, k, v, o, do, dadj, rowterm, body)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    acc, = _scratch(q, 1, body)
    _DQ.launch(_params(q, k, v, scale, causal, window, o=o, lse=lse, dout=do,
                       dadj=dadj, rowterm=rowterm, dq=dq, acc=acc), q.device, body)
    return dq


def flash_bwd_rowterm(o, do, dadj):
    """The backward's pre-pass: ``dadj - rowsum(dO * O)`` as (B, H, T)
    float32 for (B, T, H, D) ``o`` and ``do``; ``dadj`` may be None."""
    if o.device.type == "cpu":
        return plain_bwd_rowterm(o, do, dadj)
    if o.shape != do.shape or o.dim() != 4:
        raise ValueError("o and do must share one (B, T, H, D) shape")
    if o.dtype != do.dtype or o.dtype not in _DTYPES:
        raise TypeError(f"o and do must share a dtype in float32/bfloat16; got {o.dtype}, {do.dtype}")
    B, T, H, _ = o.shape
    if dadj is not None and (dadj.shape != (B, H, T) or dadj.dtype != torch.float32):
        raise ValueError("dadj must be (B, H, T) float32")
    return padded_bwd_rowterm(_launch_rowterm, o, do, dadj)


def _launch_rowterm(o, do, dadj):
    B, T, H, _ = o.shape
    o, do = o.contiguous(), do.contiguous()
    dadj = None if dadj is None else dadj.contiguous()
    _check_tma(o=o, do=do)
    rowterm = torch.empty((B, H, T), dtype=torch.float32, device=o.device)
    _ROWTERM.launch(_params(o, o, o, 1.0, False, None, o=o, dout=do, dadj=dadj,
                            rowterm=rowterm), o.device)
    return rowterm


def flash_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=None):
    """Backward kernel C: ``(dK, dV)``.  ``dadj`` may be None.  The
    wgmma body reads its row term from the pre-pass, run here unless the
    caller passes its result as ``rowterm``; the wide body reads it too,
    and the CUDA-core body computes it in the kernel."""
    _check_qkv(q, k, v)
    o, do, lse, dadj, rowterm = _bwd_inputs(q, o, do, lse, dadj, rowterm)
    if q.device.type == "cpu":
        return plain_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)
    return padded_bwd_dkv(_launch_dkv, q, k, v, o, do, lse, dadj, scale, causal, window, rowterm)


def _launch_dkv(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm):
    body = _body(q, _DKV.name)
    rowterm = _bwd_rowterm(q, k, v, o, do, dadj, rowterm, body)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    acc, acc2 = _scratch(q, 2, body)
    _DKV.launch(_params(q, k, v, scale, causal, window, o=o, lse=lse, dout=do,
                        dadj=dadj, rowterm=rowterm, dk=dk, dv=dv, acc=acc, acc2=acc2),
                q.device, body)
    return dk, dv


def _layer_backward(q, k, v, o, do, lse, dadj, scale, causal, window):
    """``(dq, dk, dv)`` of one attention call: the pre-pass runs once (on
    the CPU its plain version; where dQ and dK/dV both run the CUDA-core
    body not at all) and both backward kernels read its row term."""
    with counted_as(_flops(q, causal, window, 10)):
        rowterm = None
        if q.device.type == "cpu" or _needs_rowterm(q):
            rowterm = flash_bwd_rowterm(o, do, dadj)
        dq = flash_bwd_dq(q, k, v, o, do, lse, dadj, scale, causal, window, rowterm=rowterm)
        dk, dv = flash_bwd_dkv(q, k, v, o, do, lse, dadj, scale, causal, window,
                               rowterm=rowterm)
    return dq, dk, dv


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
        dq, dk, dv = _layer_backward(q, k, v, o, do, lse, None, scale, causal, window)
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
        dq, dk, dv = _layer_backward(q, k, v, o, do, lse, dadj, scale, causal, None)
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
