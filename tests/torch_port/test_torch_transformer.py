"""The port's agent-stacked TransformerLM against the JAX package's, from
converted flax weights, in float32 on the CPU.  Tolerances: logits 2e-5
and parameter grads 2e-6 absolute (float32 sums in another order; the
logits are O(1), the grads O(0.1))."""

import jax
import numpy as np
import optax
import pytest
import torch

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu_torch.convert import flax_to_torch, torch_to_flax
from distributed_learning_tpu_torch.models import TransformerLM, get_model
from distributed_learning_tpu_torch.parallel import ConsensusEngine, Topology

V, T, L, H, DH = 64, 64, 2, 2, 32
CFG = dict(vocab_size=V, num_layers=L, num_heads=H, head_dim=DH, max_len=T)


def _jax_params(impl, seed=0, window=None):
    model = JaxLM(attn_impl=impl, attn_window=window, **CFG)
    x0 = np.zeros((1, T), np.int32)
    return model, jax.jit(model.init)(jax.random.key(seed), x0)["params"]


@pytest.mark.parametrize("impl,window", [("full", None), ("flash", None), ("flash", 12)])
def test_logits_and_grads_match_jax(impl, window):
    jm, params = _jax_params(impl, window=window)
    rng = np.random.default_rng(0)
    x = rng.integers(0, V, (2, T)).astype(np.int32)
    y = rng.integers(0, V, (2, T)).astype(np.int32)

    def jloss(p):
        logits = jm.apply({"params": p}, x)
        return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

    jlogits = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    jgrads = flax_to_torch(jax.jit(jax.grad(jloss))(params))

    tm = TransformerLM(attn_impl=impl, attn_window=window, n_agents=1, device="cpu", **CFG)
    tm.load_stacked(flax_to_torch(params))
    logits = tm(torch.as_tensor(x, dtype=torch.long)[None])
    np.testing.assert_allclose(logits.detach().numpy()[0], jlogits, atol=2e-5)
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, V), torch.as_tensor(y, dtype=torch.long).reshape(-1))
    tm.flat_grads.zero_()
    loss.backward()
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad[0].numpy(), jgrads[name], atol=2e-6,
                                   err_msg=name)


def test_agents_are_independent_and_stacked_weights_convert():
    """Two agents with different converted weights give each its own
    flax logits; the conversion round-trips the flax tree."""
    jm, p0 = _jax_params("full", seed=0)
    _, p1 = _jax_params("full", seed=1)
    stacked = jax.tree.map(lambda a, b: np.stack([a, b]), p0, p1)
    x = np.random.default_rng(2).integers(0, V, (2, 1, T)).astype(np.int32)
    tm = TransformerLM(attn_impl="full", n_agents=2, device="cpu", **CFG)
    tm.load_stacked(flax_to_torch(stacked, n_agents=2))
    logits = tm(torch.as_tensor(x, dtype=torch.long)).detach().numpy()
    for a, p in enumerate((p0, p1)):
        np.testing.assert_allclose(
            logits[a], np.asarray(jm.apply({"params": p}, x[a])), atol=2e-5)
    back = torch_to_flax(flax_to_torch(stacked, n_agents=2))
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(stacked),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="leading agent axis"):
        flax_to_torch(p0, n_agents=2)


def test_parameters_and_grads_are_views_of_the_flat_buffers():
    tm = get_model("transformer", V, num_layers=1, num_heads=2, head_dim=32,
                   max_len=16, n_agents=3, device="cpu")
    stacked = tm.stacked_parameters()
    assert sum(p[0].numel() for p in stacked.values()) == tm.param_count()
    for p in stacked.values():
        assert p.untyped_storage().data_ptr() == tm.flat_params.untyped_storage().data_ptr()
        assert p.grad.untyped_storage().data_ptr() == tm.flat_grads.untyped_storage().data_ptr()
    # One gossip round on the buffer moves every parameter view.
    with torch.no_grad():
        tm.flat_params[1].add_(1.0)
    before = tm.head.bias.detach().clone()
    out = ConsensusEngine(Topology.ring(3).metropolis_weights()).mix(
        {"float32": tm.flat_params})
    with torch.no_grad():
        tm.flat_params.copy_(out["float32"])
    assert not torch.equal(before, tm.head.bias)
    np.testing.assert_allclose(tm.head.bias.detach().numpy(), 1.0 / 3.0, atol=1e-6)


def test_bf16_compute_tracks_float32():
    """``dtype=bfloat16`` (the slice's compute type) over float32 weights
    stays within bf16 resolution of the float32 logits (atol 0.1 on
    O(1) logits after two layers)."""
    _, params = _jax_params("flash")
    x = torch.as_tensor(np.random.default_rng(3).integers(0, V, (1, 2, T)), dtype=torch.long)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        tm = TransformerLM(attn_impl="flash", dtype=dt, n_agents=1, device="cpu", **CFG)
        tm.load_stacked(flax_to_torch(params))
        out[dt] = tm(x).detach()
    assert out[torch.bfloat16].dtype == torch.float32
    np.testing.assert_allclose(out[torch.bfloat16].numpy(), out[torch.float32].numpy(), atol=0.1)
