"""The port's CUDA flash-attention kernels against their plain PyTorch
versions, on the card.  Every test here is marked ``gpu`` and skips
without a CUDA device.  This file imports no JAX, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/torch_port/test_torch_kernels_gpu.py
"""

import pytest
import torch

from distributed_learning_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


# The limits of chip_smoke.py.  bfloat16: a difference of one or two bf16
# ulps is under 2**-6 of the element, inside rtol; atol covers elements
# near zero only, below the values compared (|O|, |dQ| ~0.03 and late-key
# dK, dV ~0.003-0.01 at T 4096); ``tile`` bounds ||a - b|| / ||b|| over
# each 64-row tile of each (batch, head).  float32: summation order only.
TOL = {
    torch.bfloat16: {"o": 5e-3, "grad": 2e-3, "rtol": 2e-2, "tile": 1e-2},
    torch.float32: {"o": 2e-5, "grad": 2e-5, "rtol": 2e-5, "tile": 1e-5},
}


def _max_tile_rel_err(a, b, rows=64):
    a, b = a.float(), b.float()
    pad = (0, 0, 0, 0, 0, (-b.shape[1]) % rows)

    def tiles(x):
        x = torch.nn.functional.pad(x, pad)
        return x.reshape(x.shape[0], -1, rows, *x.shape[2:]).square().sum((2, 4)).sqrt()

    num, den = tiles(a - b), tiles(b)
    return float(torch.where(num == 0, torch.zeros_like(num), num / den).max())


@pytest.mark.gpu
@pytest.mark.parametrize(
    "B,T,H,D,dtype,causal,window,with_dadj",
    [
        (2, 256, 2, 128, torch.bfloat16, True, None, False),
        (2, 200, 2, 64, torch.float32, True, 37, False),
        (1, 130, 3, 32, torch.float32, False, None, True),
        (1, 192, 2, 128, torch.bfloat16, True, None, True),
        # The edges of the wgmma bodies' 128-row tiles.
        (2, 64, 2, 128, torch.bfloat16, True, None, False),
        (2, 129, 2, 128, torch.bfloat16, True, None, False),
        (2, 1000, 2, 128, torch.bfloat16, True, 100, False),
        (2, 384, 2, 64, torch.bfloat16, False, None, True),
        (2, 333, 2, 128, torch.bfloat16, False, None, False),
        # bf16 with head dim 32: the forward, dQ and dK/dV on wgmma
        # (64-byte rows).
        (2, 200, 2, 32, torch.bfloat16, True, 50, True),
        # Other head dims run zero-padded to the next of 32, 64, 128.
        (2, 200, 2, 8, torch.bfloat16, True, None, False),
        (2, 200, 2, 16, torch.bfloat16, True, 50, True),
        (2, 256, 2, 48, torch.bfloat16, True, None, True),
        (2, 333, 2, 96, torch.bfloat16, False, None, False),
        (1, 130, 2, 16, torch.float32, True, None, True),
        (1, 130, 2, 48, torch.float32, False, None, False),
        # Head dim 256: in bf16 the forward (64-key tiles), dQ and dK/dV run
        # their wgmma bodies; float32 all CUDA-core; 192 pads to it.
        (2, 200, 2, 256, torch.bfloat16, True, None, True),
        (1, 130, 2, 256, torch.float32, True, 37, False),
        (2, 333, 2, 192, torch.bfloat16, False, None, False),
        (1, 100, 2, 192, torch.float32, True, None, True),
        # Above 256 the wide bodies, at any multiple of 128; 320 pads to 384.
        (2, 200, 2, 384, torch.bfloat16, True, None, True),
        (1, 130, 2, 512, torch.float32, False, None, False),
        (2, 300, 1, 384, torch.bfloat16, True, 50, False),
        (1, 97, 2, 320, torch.float32, True, None, True),
        (1, 64, 1, 1152, torch.bfloat16, True, None, False),
    ],
)
def test_kernels_match_plain_versions_on_card(card, B, T, H, D, dtype, causal,
                                              window, with_dadj):
    """Forward (with and without lse), dQ and dK/dV kernels against their
    plain versions on the same inputs, element by element and tile by
    tile, at the limits of ``TOL``."""
    g = torch.Generator(device=card).manual_seed(0)
    # Q, K, V as strided views of one packed buffer, as the model passes them.
    qkv = torch.randn(B, T, 3, H, D, generator=g, device=card).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(B, T, H, D, generator=g, device=card).to(dtype)
    dadj = (torch.randn(B, H, T, generator=g, device=card) if with_dadj else None)
    scale = D ** -0.5
    tol = TOL[dtype]

    def close(a, b, kind):
        torch.testing.assert_close(a.float(), b.float(), atol=tol[kind], rtol=tol["rtol"])
        assert _max_tile_rel_err(a, b) <= tol["tile"]

    o, lse = fa.flash_fwd(q, k, v, scale, causal, window, with_lse=True)
    o2, none = fa.flash_fwd(q, k, v, scale, causal, window, with_lse=False)
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    torch.cuda.synchronize()
    assert none is None
    close(o, po, "o")
    close(o2, po, "o")
    torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(fa.flash_bwd_rowterm(po, do, dadj),
                               fa.plain_bwd_rowterm(po, do, dadj), atol=1e-4, rtol=1e-5)
    dq = fa.flash_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, window)
    dk, dv = fa.flash_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, window)
    pdq = fa.plain_bwd_dq(q, k, v, po, do, plse, dadj, scale, causal, window)
    pdk, pdv = fa.plain_bwd_dkv(q, k, v, po, do, plse, dadj, scale, causal, window)
    torch.cuda.synchronize()
    for a, b in ((dq, pdq), (dk, pdk), (dv, pdv)):
        close(a, b, "grad")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,body,bwd_body", [
    ((2, 256, 2, 64), torch.bfloat16, "wgmma", "wgmma"),
    ((2, 512, 2, 128), torch.bfloat16, "wgmma", "wgmma"),
    ((2, 256, 2, 32), torch.float32, "cuda_core", "cuda_core"),
    ((2, 256, 2, 32), torch.bfloat16, "wgmma", "wgmma"),
    ((1, 256, 2, 256), torch.bfloat16, "wgmma", "wgmma"),
    ((1, 160, 2, 384), torch.bfloat16, "wgmma", "cuda_core_wide"),
])
def test_kernels_are_deterministic_and_counted(card, shape, dtype, body, bwd_body):
    """Two runs give the same bits, and every launch is counted once, on
    the body that ``wgmma_body`` names for its kernel: ``body`` for the
    forward, ``bwd_body`` for dQ and dK/dV (the pre-pass runs unless both
    are on CUDA cores)."""
    g = torch.Generator(device=card).manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=g, device=card,
                           dtype=dtype, requires_grad=True) for _ in range(3))
    fa.reset_launch_counts()
    runs = []
    for _ in range(2):
        out = fa.flash_attention(q, k, v)
        grads = torch.autograd.grad(out.float().sum(), (q, k, v))
        runs.append([out.detach()] + list(grads))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert {k.name: k.launches for k in fa.KERNELS.values()} == {
        "flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2,
        "flash_bwd_rowterm": 0 if bwd_body == "cuda_core" else 2,
    }
    for name, b in (("flash_fwd", body), ("flash_bwd_dq", bwd_body),
                    ("flash_bwd_dkv", bwd_body)):
        assert fa.KERNELS[name].by_body == {
            x: 2 * (x == b) for x in ("wgmma", "cuda_core", "cuda_core_wide")}


@pytest.mark.gpu
@pytest.mark.parametrize("D,body,bwd_body", [
    (8, "wgmma", "wgmma"), (16, "wgmma", "wgmma"), (48, "wgmma", "wgmma"),
    (96, "wgmma", "wgmma"), (192, "wgmma", "wgmma"),
    (320, "wgmma", "cuda_core_wide")])
def test_padded_head_dims_train_through_the_kernels(card, D, body, bwd_body):
    """``flash_attention`` at a head dim the kernels do not have: the
    gradients of a bf16 call equal the plain versions' at ``TOL``, every
    kernel launches once on its body at the padded head dim (``body`` for
    the forward, ``bwd_body`` for dQ and dK/dV), and the outputs keep the
    true head dim."""
    g = torch.Generator(device=card).manual_seed(D)
    q, k, v = (torch.randn(2, 256, 2, D, generator=g, device=card).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    fa.reset_launch_counts()
    out = fa.flash_attention(q, k, v)
    do = torch.randn(out.shape, generator=g, device=card).to(torch.bfloat16)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    assert out.shape == dq.shape == q.shape
    scale = D ** -0.5
    po, plse = fa.plain_fwd(q, k, v, scale, True, None, with_lse=True)
    tol = TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), po.float(), atol=tol["o"], rtol=tol["rtol"])
    for got, want in ((dq, fa.plain_bwd_dq(q, k, v, po, do, plse, None, scale, True, None)),
                      *zip((dk, dv), fa.plain_bwd_dkv(q, k, v, po, do, plse, None, scale,
                                                      True, None))):
        torch.testing.assert_close(got.float(), want.float(), atol=tol["grad"], rtol=tol["rtol"])
    assert fa.KERNELS["flash_fwd"].by_body[body] == 1
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.KERNELS[name].by_body[bwd_body] == 1
    assert fa.KERNELS["flash_bwd_rowterm"].launches == (bwd_body != "cuda_core")


@pytest.mark.gpu
def test_head_dim_above_128_raises_and_names_its_roadmap_item(card):
    # The item is closed since the wide bodies: no head dim raises, and
    # D 320 runs at 384 (bf16: the wide wgmma forward) with its own head
    # dim out.
    q = torch.zeros(1, 8, 1, 320, device=card, dtype=torch.bfloat16)
    fa.reset_launch_counts()
    out = fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert out.shape == q.shape and fa.KERNELS["flash_fwd"].by_body["wgmma"] == 1


@pytest.mark.gpu
def test_dispatcher_agrees_with_python_body_predicate(card):
    from distributed_learning_tpu_torch.ops import _build

    lib = _build.load_library()
    for which, name in enumerate(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")):
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            for D in (32, 64, 128, 256, 384, 1152):
                assert bool(lib.dlt_flash_uses_wgmma(which, code, D)) == fa.wgmma_body(dtype, D,
                                                                                       name)
                # A wgmma body has a shared-memory size; no other body does.
                assert (lib.dlt_flash_wgmma_smem_bytes(which, D) > 0) == fa.wgmma_body(
                    torch.bfloat16, D, name)


@pytest.mark.gpu
@pytest.mark.parametrize("D,with_dadj", [(128, False), (64, True), (32, True)])
def test_dq_given_the_row_term_equals_dq_that_runs_the_pre_pass(card, D, with_dadj):
    """The wgmma dQ reads the row term it is handed exactly as the one it
    computes itself: the same bits, and one pre-pass launch fewer."""
    g = torch.Generator(device=card).manual_seed(2)
    B, T, H = 2, 320, 2
    qkv = torch.randn(B, T, 3, H, D, generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(B, T, H, D, generator=g, device=card).to(torch.bfloat16)
    dadj = torch.randn(B, H, T, generator=g, device=card) if with_dadj else None
    scale = D ** -0.5
    o, lse = fa.flash_fwd(q, k, v, scale, True, None, with_lse=True)
    rowterm = fa.flash_bwd_rowterm(o, do, dadj)
    fa.reset_launch_counts()
    given = fa.flash_bwd_dq(q, k, v, o, do, lse, dadj, scale, True, None, rowterm=rowterm)
    assert fa.KERNELS["flash_bwd_rowterm"].launches == 0
    own = fa.flash_bwd_dq(q, k, v, o, do, lse, dadj, scale, True, None)
    assert fa.KERNELS["flash_bwd_rowterm"].launches == 1
    assert fa.KERNELS["flash_bwd_dq"].by_body == {"wgmma": 2, "cuda_core": 0, "cuda_core_wide": 0}
    torch.cuda.synchronize()
    assert torch.equal(given, own)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,causal,window,with_dadj", [
    (2, 129, 2, True, None, False),     # one row past a 128-query tile
    (2, 1000, 2, True, 100, False),     # a window, ragged
    (1, 1000, 2, True, None, True),     # ragged, the lse cotangent
    (2, 129, 2, False, None, True),     # non-causal, ragged, the lse cotangent
    (2, 512, 2, False, None, False),    # non-causal
    (1, 2048, 4, True, 300, False),     # a window over several key blocks
])
def test_d256_backward_wgmma_bodies_match_plain_and_repeat(card, B, T, H, causal, window,
                                                           with_dadj):
    """bf16 dQ and dK/dV at head dim 256 on their wgmma bodies (32-key
    tiles; 64-key blocks with dK and dV split between the consumers):
    within ``TOL`` of the plain versions on the same inputs, and the same
    bits when run again."""
    g = torch.Generator(device=card).manual_seed(T + H)
    qkv = torch.randn(B, T, 3, H, 256, generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(B, T, H, 256, generator=g, device=card).to(torch.bfloat16)
    dadj = torch.randn(B, H, T, generator=g, device=card) if with_dadj else None
    scale = 256 ** -0.5
    tol = TOL[torch.bfloat16]
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    args = (q, k, v, po, do, plse, dadj, scale, causal, window)
    fa.reset_launch_counts()
    runs = [(fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    assert fa.KERNELS["flash_bwd_dq"].by_body["wgmma"] == 2
    assert fa.KERNELS["flash_bwd_dkv"].by_body["wgmma"] == 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = (fa.plain_bwd_dq(*args), *fa.plain_bwd_dkv(*args))
    for got, want in zip(runs[0], plain):
        torch.testing.assert_close(got.float(), want.float(), atol=tol["grad"], rtol=tol["rtol"])
        assert _max_tile_rel_err(got, want) <= tol["tile"]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,causal,window,with_dadj", [
    (2, 512, 4, True, None, False),     # causal
    (2, 129, 2, True, None, False),     # one row past a 128-query tile
    (2, 1000, 2, True, 100, False),     # a window, ragged
    (1, 1000, 2, True, 300, True),      # a window over several key tiles, the lse cotangent
    (1, 1000, 2, True, None, True),     # ragged, the lse cotangent
    (2, 333, 2, False, None, True),     # non-causal, ragged, the lse cotangent
    (2, 512, 2, False, None, False),    # non-causal
    (2, 64, 2, True, None, False),      # under one tile
    (2, 40, 2, False, None, True),      # under one tile, non-causal, the lse cotangent
])
def test_d32_backward_wgmma_bodies_match_plain_and_repeat(card, B, T, H, causal, window,
                                                          with_dadj):
    """bf16 dQ and dK/dV at head dim 32 on their wgmma bodies (64-byte
    rows; 128-key dQ tiles, 128-key dK/dV blocks): within ``TOL`` of the
    plain versions on the same inputs, element by element and tile by
    tile, the same bits when run again, and every launch on wgmma."""
    g = torch.Generator(device=card).manual_seed(T + H + 3)
    qkv = torch.randn(B, T, 3, H, 32, generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    do = torch.randn(B, T, H, 32, generator=g, device=card).to(torch.bfloat16)
    dadj = torch.randn(B, H, T, generator=g, device=card) if with_dadj else None
    scale = 32 ** -0.5
    tol = TOL[torch.bfloat16]
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    args = (q, k, v, po, do, plse, dadj, scale, causal, window)
    fa.reset_launch_counts()
    runs = [(fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args)) for _ in range(2)]
    torch.cuda.synchronize()
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.KERNELS[name].by_body == {"wgmma": 2, "cuda_core": 0, "cuda_core_wide": 0}
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = (fa.plain_bwd_dq(*args), *fa.plain_bwd_dkv(*args))
    for got, want in zip(runs[0], plain):
        torch.testing.assert_close(got.float(), want.float(), atol=tol["grad"], rtol=tol["rtol"])
        assert _max_tile_rel_err(got, want) <= tol["tile"]


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,causal,window,with_lse", [
    (2, 512, 2, True, None, True),      # causal
    (2, 512, 2, True, None, False),
    (2, 1000, 2, True, 100, True),      # a window, ragged
    (1, 1000, 2, True, 300, False),     # a window over several key tiles, ragged
    (2, 333, 2, False, None, True),     # non-causal, ragged
    (2, 129, 2, False, None, False),
])
def test_d256_forward_wgmma_body_matches_plain_and_repeats(card, B, T, H, causal, window,
                                                           with_lse):
    """The bf16 forward at head dim 256 on its wgmma body (64-key tiles):
    O within ``TOL`` of the plain version on the same inputs, element by
    element and tile by tile, lse within 1e-4, and the same bits when run
    again."""
    g = torch.Generator(device=card).manual_seed(T + H + 1)
    qkv = torch.randn(B, T, 3, H, 256, generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 256 ** -0.5
    tol = TOL[torch.bfloat16]
    fa.reset_launch_counts()
    runs = [fa.flash_fwd(q, k, v, scale, causal, window, with_lse=with_lse) for _ in range(2)]
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    torch.cuda.synchronize()
    assert fa.KERNELS["flash_fwd"].by_body == {"wgmma": 2, "cuda_core": 0, "cuda_core_wide": 0}
    (o, lse), (o2, lse2) = runs
    assert torch.equal(o, o2)
    torch.testing.assert_close(o.float(), po.float(), atol=tol["o"], rtol=tol["rtol"])
    assert _max_tile_rel_err(o, po) <= tol["tile"]
    if with_lse:
        assert torch.equal(lse, lse2)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    else:
        assert lse is None and lse2 is None


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,causal,window,with_lse", [
    (2, 512, 4, True, None, True),      # causal
    (2, 512, 4, True, None, False),
    (2, 1000, 2, True, 100, True),      # a window, ragged
    (1, 1000, 2, True, 300, False),     # a window over several key tiles, ragged
    (2, 333, 2, False, None, True),     # non-causal, ragged
    (2, 129, 2, False, None, False),
    (2, 64, 2, True, None, True),       # under one tile
    (2, 64, 2, True, None, False),
])
def test_d32_forward_wgmma_body_matches_plain_and_repeats(card, B, T, H, causal, window,
                                                          with_lse):
    """The bf16 forward at head dim 32 on its wgmma body (64-byte rows and
    swizzle): O within ``TOL`` of the plain version on the same inputs,
    element by element and tile by tile, lse within 1e-4, and the same
    bits when run again."""
    g = torch.Generator(device=card).manual_seed(T + H + 2)
    qkv = torch.randn(B, T, 3, H, 32, generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = 32 ** -0.5
    tol = TOL[torch.bfloat16]
    fa.reset_launch_counts()
    runs = [fa.flash_fwd(q, k, v, scale, causal, window, with_lse=with_lse) for _ in range(2)]
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    torch.cuda.synchronize()
    assert fa.KERNELS["flash_fwd"].by_body == {"wgmma": 2, "cuda_core": 0, "cuda_core_wide": 0}
    (o, lse), (o2, lse2) = runs
    assert torch.equal(o, o2)
    torch.testing.assert_close(o.float(), po.float(), atol=tol["o"], rtol=tol["rtol"])
    assert _max_tile_rel_err(o, po) <= tol["tile"]
    if with_lse:
        assert torch.equal(lse, lse2)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    else:
        assert lse is None and lse2 is None


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,D,causal,window,with_lse", [
    (2, 512, 2, 512, True, None, True),     # causal, two 256-column slices
    (2, 512, 2, 512, True, None, False),
    (2, 129, 2, 384, True, None, True),     # one row past a 128-query tile; a 128-column slice
    (2, 1000, 2, 384, True, 100, True),     # a window, ragged
    (1, 1000, 2, 512, True, 300, False),    # a window over several key tiles, ragged
    (2, 333, 2, 640, False, None, True),    # non-causal, ragged; Q streamed, a 128-column slice
    (1, 300, 1, 1152, True, 50, True),      # a window, ragged, five slices
    (1, 160, 2, 1152, False, None, False),
    (2, 64, 2, 512, True, None, True),      # under one tile
])
def test_wide_forward_wgmma_body_matches_plain_and_repeats(card, B, T, H, D, causal, window,
                                                          with_lse):
    """The bf16 forward above head dim 256 on its wgmma body (O's columns
    split across blocks, S over the whole head dim in each): O within
    ``TOL`` of the plain version on the same inputs, element by element
    and tile by tile, lse within 1e-4, and the same bits when run again."""
    g = torch.Generator(device=card).manual_seed(T + H + D)
    qkv = torch.randn(B, T, 3, H, D, generator=g, device=card).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = D ** -0.5
    tol = TOL[torch.bfloat16]
    fa.reset_launch_counts()
    runs = [fa.flash_fwd(q, k, v, scale, causal, window, with_lse=with_lse) for _ in range(2)]
    po, plse = fa.plain_fwd(q, k, v, scale, causal, window, with_lse=True)
    torch.cuda.synchronize()
    assert fa.KERNELS["flash_fwd"].by_body == {"wgmma": 2, "cuda_core": 0, "cuda_core_wide": 0}
    (o, lse), (o2, lse2) = runs
    assert torch.equal(o, o2)
    torch.testing.assert_close(o.float(), po.float(), atol=tol["o"], rtol=tol["rtol"])
    assert _max_tile_rel_err(o, po) <= tol["tile"]
    if with_lse:
        assert torch.equal(lse, lse2)
        torch.testing.assert_close(lse, plse, atol=1e-4, rtol=1e-5)
    else:
        assert lse is None and lse2 is None


@pytest.mark.gpu
def test_wgmma_body_rejects_a_view_tma_cannot_read(card):
    buf = torch.zeros(4096, device=card, dtype=torch.bfloat16)
    q = buf.as_strided((1, 8, 2, 64), (8 * 132, 132, 64, 1))  # 264-byte rows
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.flash_fwd(q, q, q, 0.125, True, None, with_lse=False)


@pytest.mark.gpu
def test_graph_replays_count_and_match_eager(card):
    """A 2-layer flash LM trained as a superstep of 3 epochs (each epoch's
    steps one graph replay): every captured launch counts once per
    replay on its kernel and body (the warm-up counts nothing), so the
    counts are layers x steps x epochs (plus the boundary eval's
    forwards for A), and the run ends where 3 eager epochs do, bit for
    bit (the kernels are deterministic)."""
    import numpy as np

    from distributed_learning_tpu_torch.models import TransformerLM
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training import GossipTrainer

    layers, steps, T, V = 2, 2, 256, 512
    rng = np.random.default_rng(0)

    def tokens(n):
        seq = (rng.integers(0, V, size=(n, 1)) + np.arange(T + 1)) % V
        return seq[:, :-1].astype(np.int32), seq[:, 1:].astype(np.int32)

    train, test = {a: tokens(2 * steps) for a in range(4)}, tokens(4)

    def trainer():
        model = TransformerLM(vocab_size=V, num_layers=layers, num_heads=2, head_dim=128,
                              max_len=T, attn_impl="flash", dtype=torch.bfloat16,
                              n_agents=4, device=card, seed=0)
        t = GossipTrainer(node_names=range(4), model=model, optimizer="adam",
                          learning_rate=1e-3, weights=Topology.ring(4), train_data=train,
                          test_data=test, batch_size=2, epoch_len=steps, eval_batch_size=2,
                          device=card)
        return t.initialize_nodes()

    eager = trainer()
    for _ in range(3):
        eager.train_epoch()
    graph = trainer()
    fa.reset_launch_counts()
    out = graph.train_epochs(3)
    torch.cuda.synchronize()
    per = layers * steps * 3
    evals = layers * len(test[0]) // 2
    assert {kn.name: kn.launches for kn in fa.KERNELS.values()} == {
        "flash_fwd": per + evals, "flash_bwd_dq": per, "flash_bwd_dkv": per,
        "flash_bwd_rowterm": per}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert fa.KERNELS[name].by_body["cuda_core"] == 0, name
    assert graph._graphs.replays[("train",)] == 3
    assert graph.superstep_host_syncs == [0]
    assert torch.equal(graph.model.flat_params, eager.model.flat_params)
    assert [p["mix_rounds"] for p in out] == [1, 1, 1]
    fa.reset_launch_counts()


def _robust_inputs():
    """A (5, 4099) float32 state and published buffer on a quarter grid
    (many coordinates tie across agents), agent 1 NaN at every 97th
    coordinate, and irregular Metropolis weights (unequal, so the tie
    order decides which neighbour a trim cuts)."""
    from distributed_learning_tpu_torch.parallel import Topology

    g = torch.Generator().manual_seed(0)
    x, pub = (torch.randint(-4, 5, (5, 4099), generator=g).float() / 4 for _ in range(2))
    x[1, ::97] = float("nan")
    pub[1, ::97] = float("nan")
    W = Topology.from_edges([(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3)]).metropolis_weights()
    return {"float32": x}, {"float32": pub}, torch.tensor(W, dtype=torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("published", [False, True])
@pytest.mark.parametrize("kind", ["trim", "median", "clip_adaptive"])
def test_robust_rounds_on_card_equal_cpu(card, kind, published):
    """The trimmed-mean, median and adaptive-clip rounds (plain PyTorch,
    no kernel of their own) on the card equal the CPU's within 2e-6, NaN
    where the CPU has NaN, with the same redirected mass."""
    from distributed_learning_tpu_torch.ops import mixing as ops

    x, pub, W = _robust_inputs()

    def run(device):
        xs = {k: v.to(device) for k, v in x.items()}
        ps = {k: v.to(device) for k, v in pub.items()} if published else None
        Wd, out = W.to(device), {k: torch.empty_like(v) for k, v in xs.items()}
        if kind == "clip_adaptive":
            out, mass = ops.clipped_mix(xs, Wd, 0.8, out, adaptive=True, published=ps)
        else:
            trim = ops.trim_counts(Wd, 1 if kind == "trim" else "median")
            out, mass = ops.trimmed_mix(xs, Wd, trim, out, published=ps)
        return out["float32"].cpu(), float(mass)

    (cpu, cpu_mass), (got, mass) = run("cpu"), run(card)
    torch.testing.assert_close(got, cpu, rtol=0, atol=2e-6, equal_nan=True)
    assert cpu.isnan().any() and not cpu.isnan().all()
    assert mass == pytest.approx(cpu_mass, rel=1e-6) and cpu_mass > 0.0
