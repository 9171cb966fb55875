"""Flash attention of the PyTorch port against the JAX package.

On the CPU the port's wrappers run their plain versions; they are held
against the JAX package's Pallas kernels run with ``interpret=True`` (its
own CPU path), on identical numpy inputs.  Tolerances are the JAX
package's own bars for its kernels (``tests/test_ring_attention.py``):
atol 5e-5 in float32, atol/rtol 0.05 in bfloat16.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/torch_port/test_torch_kernels_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_with_lse as jax_flash_lse,
)
from distributed_learning_tpu.ops.ring_attention import (
    attention_reference as jax_reference,
)
from distributed_learning_tpu_torch.ops import flash_attention as fa
from distributed_learning_tpu_torch.ops.ring_attention import attention_reference

F32_ATOL = 5e-5
BF16_TOL = 0.05


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """Pin torch's intra-op thread count for these comparisons: its CPU
    GEMMs block their sums by thread count, and a worker process of a
    parallel test run starts with whatever count its affinity gives it,
    so the plain versions' float32 sums would otherwise be ordered by the
    machine's load.  Restored afterwards."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, co = (rng.normal(size=shape).astype(np.float32) for _ in range(4))
    return q, k, v, co


def _torch_grads(fn, arrays, dtype, co):
    ts = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out.to(torch.float32) * torch.tensor(co)).sum().backward()
    return out.detach().to(torch.float32).numpy(), [t.grad.to(torch.float32).numpy() for t in ts]


def _jax_grads(fn, arrays, dtype, co):
    js = [jnp.asarray(a, dtype) for a in arrays]

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v).astype(jnp.float32) * co)

    out = np.asarray(fn(*js).astype(jnp.float32))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*js)
    return out, [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize(
    "causal,window,dtype,D",
    [
        (True, None, "float32", 32),
        (False, None, "float32", 32),
        (True, 24, "float32", 32),
        (True, None, "bfloat16", 32),
        (True, 24, "bfloat16", 32),
        # bf16 head dims 16 and 8, run zero-padded to 32: the route that
        # runs the pre-pass and the D-32 dQ and dK/dV bodies on the card.
        (True, None, "bfloat16", 16),
        (False, None, "bfloat16", 8),
    ],
    ids=["True-None-float32", "False-None-float32", "True-24-float32", "True-None-bfloat16",
         "True-24-bfloat16", "True-None-bfloat16-D16", "False-None-bfloat16-D8"],
)
def test_flash_attention_matches_jax_interpret(causal, window, dtype, D):
    """Values and q/k/v grads of the plain path vs the Pallas kernels."""
    shape = (2, 64, 2, D)
    q, k, v, co = _inputs(shape, seed=3)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    got, got_g = _torch_grads(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=causal, window=window),
        (q, k, v), tdt, co,
    )
    want, want_g = _jax_grads(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, window=window,
                                  block_q=32, block_k=32, interpret=True),
        (q, k, v), jdt, co,
    )
    tol = dict(atol=F32_ATOL) if dtype == "float32" else dict(atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(got, want, **tol)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_with_lse_matches_jax_interpret(causal):
    """Output, lse and grads with a non-zero lse cotangent (the ``dadj``
    term of both backward kernels)."""
    shape = (1, 64, 2, 32)
    q, k, v, co = _inputs(shape, seed=5)
    cl = np.random.default_rng(6).normal(size=(1, 2, 64)).astype(np.float32)

    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out, lse = fa.flash_attention_with_lse(*ts, causal=causal)
    ((out * torch.tensor(co)).sum() + (lse * torch.tensor(cl)).sum()).backward()

    def jloss(q, k, v):
        o, l = jax_flash_lse(q, k, v, causal=causal, block_q=32, block_k=32,
                             interpret=True)
        return jnp.sum(o * co) + jnp.sum(l * cl)

    jo, jl = jax_flash_lse(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                           block_q=32, block_k=32, interpret=True)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), atol=F32_ATOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), atol=F32_ATOL)
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=F32_ATOL)


def test_ragged_length_matches_reference():
    """A T that no tile divides: values and grads vs the JAX oracle."""
    shape = (1, 50, 2, 32)
    q, k, v, co = _inputs(shape, seed=8)
    got, got_g = _torch_grads(
        lambda q, k, v: fa.flash_attention(q, k, v, causal=True, window=9),
        (q, k, v), torch.float32, co,
    )
    want, want_g = _jax_grads(
        lambda q, k, v: jax_reference(q, k, v, causal=True, window=9),
        (q, k, v), jnp.float32, co,
    )
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g, w, atol=F32_ATOL)


def test_attention_reference_matches_jax():
    q, k, v, _ = _inputs((2, 32, 2, 16), seed=9)
    for causal, window in ((True, None), (False, None), (True, 5)):
        got = attention_reference(*(torch.tensor(a) for a in (q, k, v)),
                                  causal=causal, window=window)
        want = jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("dtype,D,wgmma", [
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, True),
    (torch.float32, 64, False),
    (torch.float32, 128, False),
    (torch.bfloat16, 256, True),
    (torch.float32, 256, False),
])
def test_body_predicate_routes_by_dtype_and_head_dim(dtype, D, wgmma):
    """bf16 with D 32, 64, 128 or 256 takes the wgmma/TMA body of all
    three kernels (forward, dQ, dK/dV); float32 (no float32-exact wgmma)
    the CUDA-core bodies of all three
    (``test_torch_flash_body_dispatch.py`` holds each kernel's body)."""
    assert fa.wgmma_body(dtype, D) is wgmma


@pytest.mark.parametrize("kernel,wgmma", [
    ("flash_fwd", True),
    ("flash_bwd_dq", True),
    ("flash_bwd_dkv", True),
])
def test_body_predicate_at_head_dim_32_is_per_kernel(kernel, wgmma):
    """bf16 at D 32: the forward, dQ and dK/dV on wgmma (64-byte rows);
    float32 there on CUDA cores for every kernel."""
    assert fa.wgmma_body(torch.bfloat16, 32, kernel) is wgmma
    assert fa.wgmma_body(torch.float32, 32, kernel) is False


def test_tma_rule_rejects_a_view_with_a_stride_off_16_bytes():
    buf = torch.zeros(8192, dtype=torch.bfloat16)
    fused = buf[:2 * 8 * 3 * 2 * 64].view(2, 8, 3, 2, 64)  # the model's fused QKV
    fa._check_tma(q=fused[:, :, 0], k=fused[:, :, 1], v=fused[:, :, 2])
    bad_row = buf.as_strided((1, 8, 2, 64), (8 * 132, 132, 64, 1))  # 264-byte rows
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa._check_tma(q=bad_row)
    bad_base = buf[1:1 + 8 * 2 * 64].view(1, 8, 2, 64)  # 2 bytes past an aligned base
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa._check_tma(k=bad_base)


@pytest.mark.parametrize("with_dadj", [False, True])
def test_plain_rowterm_is_dadj_minus_rowsum_of_do_times_o(with_dadj):
    """The pre-pass's plain version against numpy: dadj - sum_d dO * O, as
    the JAX dK/dV kernel forms it (``dp - delta + adj``)."""
    rng = np.random.default_rng(12)
    B, T, H, D = 2, 40, 3, 16
    o, do = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(2))
    dadj = rng.normal(size=(B, H, T)).astype(np.float32) if with_dadj else None
    got = fa.plain_bwd_rowterm(torch.tensor(o), torch.tensor(do),
                               None if dadj is None else torch.tensor(dadj))
    want = -np.einsum("bthd,bthd->bht", do, o)
    if dadj is not None:
        want = want + dadj
    assert got.shape == (B, H, T) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # flash_bwd_rowterm on the CPU is the plain version.
    same = fa.flash_bwd_rowterm(torch.tensor(o), torch.tensor(do),
                                None if dadj is None else torch.tensor(dadj))
    assert torch.equal(same, got)


def _bwd_case(dtype, with_dadj, seed=13):
    rng = np.random.default_rng(seed)
    B, T, H, D = 2, 48, 2, 32
    q, k, v, do = (torch.tensor(rng.normal(size=(B, T, H, D)).astype(np.float32)).to(dtype)
                   for _ in range(4))
    dadj = (torch.tensor(rng.normal(size=(B, H, T)).astype(np.float32))
            if with_dadj else None)
    scale = D ** -0.5
    o, lse = fa.plain_fwd(q, k, v, scale, True, None, with_lse=True)
    return q, k, v, o, do, lse, dadj, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_dadj", [False, True])
def test_backward_kernels_given_the_row_term_match_their_own(dtype, with_dadj):
    """dQ and dK/dV handed the pre-pass's row term give the same bits as
    the calls that form it themselves."""
    q, k, v, o, do, lse, dadj, scale = _bwd_case(dtype, with_dadj)
    rowterm = fa.plain_bwd_rowterm(o, do, dadj)
    args = (q, k, v, o, do, lse, dadj, scale, True, None)
    assert torch.equal(fa.flash_bwd_dq(*args, rowterm=rowterm), fa.flash_bwd_dq(*args))
    for a, b in zip(fa.flash_bwd_dkv(*args, rowterm=rowterm), fa.flash_bwd_dkv(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_lse", [False, True])
def test_layer_backward_runs_the_pre_pass_once_with_the_same_grads(dtype, with_lse):
    """On the CPU the autograd backward (``_Flash`` and ``_FlashLse``)
    forms the row term once for both backward kernels, and its dQ, dK and
    dV are the plain kernels' own, bit for bit."""
    q, k, v, o, do, lse, dadj, scale = _bwd_case(dtype, with_lse)
    calls = []
    real = fa.flash_bwd_rowterm

    def counted(*a):
        calls.append(1)
        return real(*a)

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    fa.flash_bwd_rowterm = counted
    try:
        if with_lse:
            outs = fa.flash_attention_with_lse(*leaves, causal=True)
            grads = torch.autograd.grad(outs, leaves, (do, dadj))
        else:
            out = fa.flash_attention(*leaves, causal=True)
            grads = torch.autograd.grad(out, leaves, do)
    finally:
        fa.flash_bwd_rowterm = real
    assert len(calls) == 1
    args = (q, k, v, o, do, lse, dadj, scale, True, None)
    want = (fa.plain_bwd_dq(*args), *fa.plain_bwd_dkv(*args))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_cpu_path_counts_no_launch_and_checks_inputs():
    fa.reset_launch_counts()
    q = torch.zeros(1, 8, 1, 32)
    fa.flash_attention(q, q, q)
    assert all(k.launches == 0 for k in fa.KERNELS.values())
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="window requires causal"):
        fa.flash_attention(q, q, q, causal=False, window=4)


def test_launch_counts_see_graph_replays(monkeypatch):
    """A launch counts once when it runs eagerly; inside a launch record
    (a CUDA graph capture) it counts nothing until the record is counted
    once per replay, on the same kernel and body; a launch captured
    outside a record counts nothing.  The library and the stream are
    stand-ins: only the counting is under test."""
    import types

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(fa._build, "load_library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    fwd, dq = fa.KERNELS["flash_fwd"], fa.KERNELS["flash_bwd_dq"]
    fa.reset_launch_counts()
    params = fa._build.FlashParams()
    fwd.launch(params, "cuda", "wgmma")
    with fa.record_launches() as record:
        for _ in range(3):
            fwd.launch(params, "cuda", "wgmma")
        dq.launch(params, "cuda", "cuda_core")
    assert fwd.launches == 1 and dq.launches == 0
    assert record == {("flash_fwd", "wgmma"): 3, ("flash_bwd_dq", "cuda_core"): 1}
    fa.count_replays(record, times=2)
    assert (fwd.launches, fwd.by_body["wgmma"]) == (7, 7)
    assert (dq.launches, dq.by_body) == (2, {"wgmma": 0, "cuda_core": 2, "cuda_core_wide": 0})
    capturing[0] = True
    fwd.launch(params, "cuda", "wgmma")  # captured outside a record
    assert fwd.launches == 7
    fa.reset_launch_counts()
