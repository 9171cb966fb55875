"""Which body each flash-attention kernel runs, on the CPU: the forward
(A), dQ (B) and dK/dV (C) choose their body each by (kernel, dtype, head
dim), as ``uses_wgmma_body`` in ``csrc/flash_params.cuh`` does.  In
bfloat16 at head dim 256 (and 192, run zero-padded to it) and at head dim
32 (and 8, 16, 24, padded to it) all three take their wgmma bodies, while
float32 there keeps the CUDA-core bodies; above 256 the bfloat16 forward
takes its wide wgmma body (no scratch) while dQ, dK/dV and float32 keep
the wide CUDA-core bodies; a layer's backward runs the pre-pass by B's
and C's body, not A's.

No kernel runs here: the launch path up to the kernel call is driven on
CPU tensors with ``_Kernel.launch`` replaced by a recorder.
"""

import pytest
import torch

from distributed_learning_tpu_torch.ops import flash_attention as fa

KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def _want(dtype, D):
    """(A, B, C) bodies of a call of head dim D."""
    Dk = fa.kernel_head_dim(D)
    if Dk > 256:
        if dtype == torch.bfloat16:
            return ("wgmma", "cuda_core_wide", "cuda_core_wide")
        return ("cuda_core_wide",) * 3
    if dtype == torch.float32:
        return ("cuda_core",) * 3
    return ("wgmma",) * 3


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256, 320, 512, 640, 1152])
def test_each_kernel_takes_its_own_body(D, dtype):
    q = torch.zeros(1, 4, 1, D, dtype=dtype)
    want = _want(dtype, D)
    assert tuple(fa._body(q, name) for name in KERNELS) == want
    Dk = fa.kernel_head_dim(D)
    assert tuple(fa.wgmma_body(dtype, Dk, name) for name in KERNELS) == tuple(
        b == "wgmma" for b in want)
    # Without a kernel: whether all three take wgmma.
    assert fa.wgmma_body(dtype, Dk) is all(b == "wgmma" for b in want)


def test_an_unknown_kernel_name_raises():
    with pytest.raises(ValueError, match="unknown kernel"):
        fa.wgmma_body(torch.bfloat16, 256, "flash_bwd")


@pytest.fixture
def recorded(monkeypatch):
    """Each ``_Kernel.launch`` call as (kernel name, body, params)."""
    calls = []

    def launch(self, params, device, body="cuda_core"):
        calls.append((self.name, body, params))

    monkeypatch.setattr(fa._Kernel, "launch", launch)
    return calls


def _bwd_inputs(D, T=40, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(D)
    q, k, v, o, do = (torch.randn(2, T, 2, D, generator=g).to(dtype) for _ in range(5))
    lse = torch.randn(2, 2, T, generator=g)
    return q, k, v, o, do, lse


@pytest.mark.parametrize("D", [256, 192])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_d256_backward_launch_takes_wgmma_and_a_row_term(recorded, D, which):
    """``_launch_dq`` / ``_launch_dkv`` at head dim 256 in bf16 (192 through
    the padding helpers) record the wgmma body and hand the kernel the
    pre-pass's row term, run here since the caller passed none."""
    q, k, v, o, do, lse = _bwd_inputs(D)
    launch, padded = {"dq": (fa._launch_dq, fa.padded_bwd_dq),
                      "dkv": (fa._launch_dkv, fa.padded_bwd_dkv)}[which]
    padded(launch, q, k, v, o, do, lse, None, D ** -0.5, True, None, None)
    assert [(name, body) for name, body, _ in recorded] == [(f"flash_bwd_{which}", "wgmma")]
    params = recorded[0][2]
    assert params.rowterm is not None and params.D == 256
    assert params.acc is None and params.acc2 is None  # no wide-body scratch


@pytest.mark.parametrize("D", [256, 192])
def test_d256_forward_launch_takes_wgmma(recorded, D):
    """The forward at head dim 256 in bf16 (192 through the padding
    helper) records the wgmma body, with lse and no wide-body scratch."""
    q, k, v, *_ = _bwd_inputs(D)
    o, lse = fa.padded_fwd(fa._launch_fwd, q, k, v, D ** -0.5, True, None, True)
    assert [(name, body) for name, body, _ in recorded] == [("flash_fwd", "wgmma")]
    params = recorded[0][2]
    assert params.D == 256 and params.acc is None
    assert o.shape == q.shape and lse.shape == (2, 2, 40)


@pytest.mark.parametrize("D", [32, 24, 16, 8])
def test_d32_forward_launch_takes_wgmma(recorded, D):
    """The bf16 forward at head dim 32, and at 24, 16 and 8 through the
    padding helper, records the wgmma body at head dim 32, with lse and
    no wide-body scratch; O keeps the caller's head dim."""
    q, k, v, *_ = _bwd_inputs(D)
    o, lse = fa.padded_fwd(fa._launch_fwd, q, k, v, D ** -0.5, True, None, True)
    assert [(name, body) for name, body, _ in recorded] == [("flash_fwd", "wgmma")]
    params = recorded[0][2]
    assert params.D == 32 and params.lse is not None and params.acc is None
    assert o.shape == q.shape and lse.shape == (2, 2, 40)


@pytest.mark.parametrize("D", [320, 384, 512, 1152])
def test_wide_bf16_forward_takes_wgmma_and_its_backward_keeps_the_scratch(recorded, D):
    """The bf16 forward above 256 (320 through the padding helper, at 384)
    records the wgmma body with lse and no scratch, and O keeps the
    caller's head dim; the same layer's dQ and dK/dV stay on the wide
    CUDA-core bodies with their float32 scratch and the pre-pass's row
    term."""
    q, k, v, o, do, lse = _bwd_inputs(D)
    out, lse_out = fa.padded_fwd(fa._launch_fwd, q, k, v, D ** -0.5, True, None, True)
    assert [(name, body) for name, body, _ in recorded] == [("flash_fwd", "wgmma")]
    params = recorded[0][2]
    assert params.D == fa.kernel_head_dim(D) and params.lse is not None and params.acc is None
    assert out.shape == q.shape and lse_out.shape == (2, 2, 40)
    recorded.clear()
    fa.padded_bwd_dq(fa._launch_dq, q, k, v, o, do, lse, None, D ** -0.5, True, None, None)
    fa.padded_bwd_dkv(fa._launch_dkv, q, k, v, o, do, lse, None, D ** -0.5, True, None, None)
    assert [(name, body) for name, body, _ in recorded] == [
        ("flash_bwd_dq", "cuda_core_wide"), ("flash_bwd_dkv", "cuda_core_wide")]
    dq_params, dkv_params = recorded[0][2], recorded[1][2]
    assert dq_params.acc is not None and dq_params.rowterm is not None
    assert (dkv_params.acc is not None and dkv_params.acc2 is not None
            and dkv_params.rowterm is not None)


@pytest.mark.parametrize("D", [384, 512])
def test_f32_wide_forward_stays_on_cuda_cores_with_its_scratch(recorded, D):
    q, k, v, *_ = _bwd_inputs(D, dtype=torch.float32)
    fa._launch_fwd(q, k, v, D ** -0.5, True, None, True)
    assert [(name, body) for name, body, _ in recorded] == [("flash_fwd", "cuda_core_wide")]
    assert recorded[0][2].acc is not None


def test_wide_forward_on_a_view_tma_cannot_read_raises(recorded):
    """The bf16 forward above 256 takes no other body either."""
    buf = torch.zeros(2 * 8 * 520, dtype=torch.bfloat16)
    q = buf.as_strided((1, 8, 2, 512), (8 * 520, 520, 4, 1))  # 8-byte head stride
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa._launch_fwd(q, q, q, 512 ** -0.5, True, None, True)
    assert recorded == []


def test_f32_d32_forward_launch_stays_on_cuda_cores(recorded):
    q, k, v, *_ = _bwd_inputs(32, dtype=torch.float32)
    fa._launch_fwd(q, k, v, 32 ** -0.5, True, None, True)
    assert [(name, body) for name, body, _ in recorded] == [("flash_fwd", "cuda_core")]


@pytest.mark.parametrize("D", [32, 24, 16, 8])
@pytest.mark.parametrize("which", ["dq", "dkv"])
def test_d32_backward_launch_takes_wgmma(recorded, D, which):
    """dQ and dK/dV at head dim 32 in bf16, and at 24, 16 and 8 through the
    padding helpers, record the wgmma body at head dim 32 and hand the
    kernel the pre-pass's row term, run here since the caller passed
    none; the gradients keep the caller's head dim."""
    q, k, v, o, do, lse = _bwd_inputs(D)
    launch, padded = {"dq": (fa._launch_dq, fa.padded_bwd_dq),
                      "dkv": (fa._launch_dkv, fa.padded_bwd_dkv)}[which]
    out = padded(launch, q, k, v, o, do, lse, None, D ** -0.5, True, None, None)
    assert [(name, body) for name, body, _ in recorded] == [(f"flash_bwd_{which}", "wgmma")]
    params = recorded[0][2]
    assert params.rowterm is not None and params.D == 32
    assert params.acc is None and params.acc2 is None  # no wide-body scratch
    assert all(t.shape == q.shape for t in ((out,) if which == "dq" else out))


def test_f32_d32_backward_launch_stays_on_cuda_cores(recorded):
    """float32 at head dim 32 keeps the CUDA-core dQ, with no row term."""
    q, k, v, o, do, lse = _bwd_inputs(32, dtype=torch.float32)
    fa._launch_dq(q, k, v, o, do, lse, None, 32 ** -0.5, True, None, None)
    assert [(name, body) for name, body, _ in recorded] == [("flash_bwd_dq", "cuda_core")]
    assert recorded[0][2].rowterm is None


def test_f32_d256_forward_launch_stays_on_cuda_cores(recorded):
    q, k, v, *_ = _bwd_inputs(256, dtype=torch.float32)
    fa._launch_fwd(q, k, v, 0.0625, True, None, True)
    assert [(name, body) for name, body, _ in recorded] == [("flash_fwd", "cuda_core")]


def test_cuda_core_backward_is_handed_no_row_term(recorded):
    q, k, v, o, do, lse = _bwd_inputs(256, dtype=torch.float32)
    fa._launch_dq(q, k, v, o, do, lse, None, 0.0625, True, None, None)
    assert recorded[0][1] == "cuda_core" and recorded[0][2].rowterm is None


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
def test_d256_backward_on_a_view_tma_cannot_read_raises(recorded, which):
    """As at head dims 64 and 128: no quiet fall back to CUDA cores, for
    the forward as for dQ and dK/dV."""
    buf = torch.zeros(2 * 8 * 264, dtype=torch.bfloat16)
    q = buf.as_strided((1, 8, 2, 256), (8 * 264, 264, 4, 1))  # 8-byte head stride
    o = do = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        if which == "fwd":
            fa._launch_fwd(q, q, q, 0.0625, True, None, True)
        else:
            launch = {"dq": fa._launch_dq, "dkv": fa._launch_dkv}[which]
            launch(q, q, q, o, do, lse, None, 0.0625, True, None, None)
    assert recorded == []


def test_d32_forward_on_a_view_tma_cannot_read_raises(recorded):
    """The bf16 forward at head dim 32 takes no other body either."""
    buf = torch.zeros(2 * 8 * 40, dtype=torch.bfloat16)
    q = buf.as_strided((1, 8, 2, 32), (8 * 40, 40, 4, 1))  # 8-byte head stride
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa._launch_fwd(q, q, q, 32 ** -0.5, True, None, True)
    assert recorded == []


@pytest.mark.parametrize("dtype,D,runs", [
    (torch.bfloat16, 256, True),   # A, B and C on wgmma
    (torch.bfloat16, 192, True),
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 32, True),
    (torch.float32, 256, False),
    (torch.bfloat16, 512, True),   # the wide bodies read it too
])
def test_layer_backward_runs_the_pre_pass_by_the_backward_bodies(dtype, D, runs):
    assert fa._needs_rowterm(torch.zeros(1, 1, 1, D, dtype=dtype)) is runs


@pytest.mark.parametrize("bodies,runs", [
    ({"flash_fwd": "wgmma", "flash_bwd_dq": "cuda_core", "flash_bwd_dkv": "cuda_core"}, False),
    ({"flash_fwd": "cuda_core", "flash_bwd_dq": "cuda_core", "flash_bwd_dkv": "wgmma"}, True),
    ({"flash_fwd": "cuda_core", "flash_bwd_dq": "wgmma", "flash_bwd_dkv": "cuda_core"}, True),
])
def test_pre_pass_choice_ignores_the_forward_body(monkeypatch, bodies, runs):
    monkeypatch.setattr(fa, "_body", lambda q, kernel: bodies[kernel])
    assert fa._needs_rowterm(torch.zeros(1, 1, 1, 64)) is runs
