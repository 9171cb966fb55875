"""The head-dim rule of the flash-attention wrappers, on the CPU through
the plain versions: a call of head dim D runs at ``kernel_head_dim(D)``
(the next of 32, 64, 128 and 256, above 256 the next multiple of 128,
the wide bodies') with Q, K, V, O and dO zero-padded, the
scale taken from the true D, and O, dQ, dK, dV sliced back.  The card
runs the same ``padded_*`` helpers around its launches; here they wrap
the plain versions, which must then equal unpadded plain attention and
autograd of softmax attention, in float32, to 1e-5.  Head dims 192 and
256 (the D-256 body) and 320 and 640 (the wide bodies, at 384 and 640)
are also held against the JAX package's flash attention in interpret
mode, which pads them to its 128 lanes, at 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.ops.flash_attention import flash_attention as jax_flash
from distributed_learning_tpu_torch.ops import flash_attention as fa

TOL = 1e-5  # float32: the padded columns add exact zeros; summation order only


def _inputs(D, seed=0, B=2, T=37, H=2):
    g = torch.Generator().manual_seed(seed + D)
    q, k, v, do = (torch.randn(B, T, H, D, generator=g, dtype=torch.float64).float()
                   for _ in range(4))
    dadj = torch.randn(B, H, T, generator=g, dtype=torch.float64).float()
    return q, k, v, do, dadj


def _softmax_attention(q, k, v, scale, causal, window):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        r = torch.arange(T)[:, None]
        c = torch.arange(T)[None, :]
        keep = c <= r
        if window is not None:
            keep &= c >= r - (window - 1)
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o, lse


def test_kernel_head_dim_rounds_up_and_names_the_roadmap_item_above_128():
    assert [fa.kernel_head_dim(d) for d in (1, 8, 16, 32, 33, 48, 64, 65, 96, 128, 129, 160,
                                            192, 256)] == [
        32, 32, 32, 32, 64, 64, 64, 128, 128, 128, 256, 256, 256, 256]
    # Above 256 the wide bodies take every multiple of 128: no head dim raises.
    assert [fa.kernel_head_dim(d) for d in (257, 320, 384, 385, 1000, 1152)] == [
        384, 384, 384, 512, 1024, 1152]
    assert [fa.wide_body(fa.kernel_head_dim(d)) for d in (256, 257, 1000)] == [
        False, True, True]


@pytest.mark.parametrize("D", [8, 16, 48, 96, 192, 256, 320])
@pytest.mark.parametrize("causal,window,with_dadj", [
    (True, None, False), (True, 5, False), (False, None, True), (True, None, True)])
def test_padded_calls_equal_unpadded_plain_attention(D, causal, window, with_dadj):
    q, k, v, do, dadj = _inputs(D)
    dadj = dadj if with_dadj else None
    scale = 1.0 / math.sqrt(D)  # from the true D, as flash_attention takes it
    o, lse = fa.padded_fwd(fa.plain_fwd, q, k, v, scale, causal, window, True)
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, True)
    assert o.shape == q.shape
    torch.testing.assert_close(o, po, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, plse, atol=TOL, rtol=TOL)
    rt = fa.padded_bwd_rowterm(fa.plain_bwd_rowterm, po, do, dadj)
    torch.testing.assert_close(rt, fa.plain_bwd_rowterm(po, do, dadj), atol=TOL, rtol=TOL)
    args = (po, do, plse, dadj, scale, causal, window)
    dq = fa.padded_bwd_dq(fa.plain_bwd_dq, q, k, v, *args)
    dk, dv = fa.padded_bwd_dkv(fa.plain_bwd_dkv, q, k, v, *args)
    # Against unpadded plain versions and against autograd of softmax attention.
    pdq = fa.plain_bwd_dq(q, k, v, *args)
    pdk, pdv = fa.plain_bwd_dkv(q, k, v, *args)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    ro, rlse = _softmax_attention(qq, kk, vv, scale, causal, window)
    outs, cots = (ro, rlse), (do, dadj if dadj is not None else torch.zeros_like(rlse))
    gq, gk, gv = torch.autograd.grad(outs, (qq, kk, vv), cots)
    torch.testing.assert_close(o, ro.detach(), atol=TOL, rtol=TOL)
    for got, plain, auto in ((dq, pdq, gq), (dk, pdk, gk), (dv, pdv, gv)):
        assert got.shape == q.shape
        torch.testing.assert_close(got, plain, atol=TOL, rtol=TOL)
        torch.testing.assert_close(got, auto, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("D", [8, 16, 48, 96, 192, 256])
def test_padding_puts_exact_zeros_in_the_padded_columns(D):
    """What the rule rests on: the padded output columns and gradients
    are exactly zero, so slicing them off loses nothing."""
    q, k, v, do, dadj = _inputs(D, seed=1)
    Dp = fa.kernel_head_dim(D)
    pad = [fa._pad(t, Dp) for t in (q, k, v, do)]
    o, lse = fa.plain_fwd(*pad[:3], 1.0 / math.sqrt(D), True, None, True)
    assert torch.count_nonzero(o[..., D:]) == 0
    dq = fa.plain_bwd_dq(*pad[:3], o, pad[3], lse, dadj, 1.0 / math.sqrt(D), True, None)
    dk, dv = fa.plain_bwd_dkv(*pad[:3], o, pad[3], lse, dadj, 1.0 / math.sqrt(D), True, None)
    for g in (dq, dk, dv):
        assert torch.count_nonzero(g[..., D:]) == 0


@pytest.fixture
def one_intra_op_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("D", [192, 256, 320, 640])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 5)])
def test_wide_head_dims_match_jax_flash_interpret(D, causal, window, one_intra_op_thread):
    """Output and q/k/v grads of the port's flash attention (its plain
    versions behind the padding rule) against the JAX package's Pallas
    kernels in interpret mode, which pad D to 256 lanes as the card pads
    to its D-256 body; float32, T 32."""
    rng = np.random.default_rng(D)
    q, k, v, co = (rng.normal(size=(1, 32, 2, D)).astype(np.float32) for _ in range(4))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal, window=window)
    (out * torch.tensor(co)).sum().backward()

    def jfn(q, k, v):
        return jax_flash(q, k, v, causal=causal, window=window, block_q=32, block_k=32,
                         interpret=True)

    js = [jnp.asarray(a) for a in (q, k, v)]
    want = jfn(*js)
    want_g = jax.grad(lambda *a: jnp.sum(jfn(*a) * co), argnums=(0, 1, 2))(*js)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=TOL, rtol=TOL)
