"""The head-dim rule of the flash-attention wrappers, on the CPU through
the plain versions: a call of head dim D runs at ``kernel_head_dim(D)``
(the next of 32, 64 and 128) with Q, K, V, O and dO zero-padded, the
scale taken from the true D, and O, dQ, dK, dV sliced back.  The card
runs the same ``padded_*`` helpers around its launches; here they wrap
the plain versions, which must then equal unpadded plain attention and
autograd of softmax attention, in float32, to 1e-5.
"""

import math

import pytest
import torch

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
    assert [fa.kernel_head_dim(d) for d in (1, 8, 16, 32, 33, 48, 64, 65, 96, 128)] == [
        32, 32, 32, 32, 64, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match='"flash attention for head dims above 128" of ROADMAP.md'):
        fa.kernel_head_dim(160)


@pytest.mark.parametrize("D", [8, 16, 48, 96])
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


@pytest.mark.parametrize("D", [8, 16, 48, 96])
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
