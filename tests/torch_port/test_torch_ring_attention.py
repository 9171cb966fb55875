"""Sequence-parallel attention on ``torch.distributed`` (``ops/
ring_attention.py``: ``ring``, ``ulysses`` and ``ring_flash`` through
``make_ring_attention``; 4 gloo ranks on the CPU, spawned once for the
module) against the JAX package's ``make_ring_attention`` on a 4-device
``seq`` mesh of the conftest's CPU devices, ``ring_flash`` with
``interpret=True`` (the Pallas kernels through their interpreter), causal
and not.  Each of the port's three strategies is held against that one
JAX program per mask (all three are exact attention, and the JAX
package's own tests hold its ring and Ulysses to it): the output and the
gradients of ``sum(out * cot)`` in q, k and v, float32, within 1e-5.

The controls (a K/V block given the wrong source index, a rotation
skipped) must leave that limit.  The model's sequence-parallel
``attn_impl`` refuses what the reference refuses (a window, decode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from distributed_learning_tpu.ops.ring_attention import make_ring_attention
from distributed_learning_tpu_torch.models.transformer import TransformerLM
from sharded_ranks import Ranks

N = 4
TOL = 1e-5
STRATEGIES = [(s, c) for s in ("ring", "ulysses", "ring_flash") for c in (True, False)]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    inp = {n: rng.normal(size=(2, 8 * N, 4, 8)).astype(np.float32)
           for n in ("q", "k", "v", "cot")}
    _INPUTS["world"] = inp
    return inp, Ranks("ring", N, inp)  # the ranks run while the JAX side compiles


@functools.lru_cache(maxsize=None)
def _jax(causal, inp_key):
    """The JAX ring-flash output and q, k, v gradients (the Pallas
    kernels in interpret mode), from one compiled program."""
    inp = _INPUTS[inp_key]
    mesh = Mesh(np.array(jax.devices()[:N]), ("seq",))
    fn = make_ring_attention(mesh, strategy="ring_flash", causal=causal, interpret=True)
    q, k, v, cot = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "cot"))

    def loss(q, k, v):
        out = fn(q, k, v)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


_INPUTS = {}


@pytest.mark.parametrize("strategy,causal", STRATEGIES,
                         ids=[f"{s}-{'causal' if c else 'full'}" for s, c in STRATEGIES])
def test_output_and_gradients_equal_the_jax_mesh(world, strategy, causal):
    out, grads = _jax(causal, "world")
    res = world[1].results()
    tag = f"{strategy}_{'causal' if causal else 'full'}"
    for r in res:  # every rank returns the global output and gradients
        np.testing.assert_allclose(r[f"{tag}_out"], out, atol=TOL, rtol=0, err_msg=tag)
        for name, g in zip("qkv", grads):
            np.testing.assert_allclose(r[f"{tag}_d{name}"], g, atol=TOL, rtol=0,
                                       err_msg=f"{tag} d{name}")


@pytest.mark.parametrize("control", ["wrong_src", "skipped_rotation"])
def test_the_controls_fail_the_comparison(world, control):
    out, _ = _jax(True, "world")
    res = world[1].results()
    np.testing.assert_allclose(res[0]["ring_flash_causal_out"], out, atol=TOL, rtol=0)
    assert np.abs(res[0][f"control_{control}"] - out).max() > 100 * TOL


class _Axis:
    """A stand-in for the sequence axis: the refusals never reach it."""
    size, agent = 2, 0


@pytest.mark.parametrize("attn", ["ring", "ring_flash", "ulysses"])
def test_sequence_parallel_models_refuse_what_the_reference_refuses(attn):
    kw = dict(vocab_size=8, num_layers=1, num_heads=2, head_dim=8, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="needs mesh="):
        TransformerLM(attn_impl=attn, **kw)
    with pytest.raises(ValueError, match="window is only supported"):
        TransformerLM(attn_impl=attn, attn_window=4, mesh=_Axis(), **kw)
    model = TransformerLM(attn_impl=attn, mesh=_Axis(), **kw)
    tokens = torch.zeros((1, 1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="decode mode requires full/flash attention"):
        model(tokens, model.init_cache(1))
    with pytest.raises(ValueError, match="exceeds max_len"):  # 9 local x 2 ranks > 16
        model(torch.zeros((1, 1, 9), dtype=torch.long))
