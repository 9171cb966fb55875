"""The port's LM extras (rotary positions, grouped-query attention, MoE
blocks, residual dropout) against the JAX package's ``TransformerLM``, in
float32 on the CPU, from the reference's init through ``convert.py``:
2 layers, d 32 (4 heads x 8), 2 KV heads, 4 experts.

* ``_rope`` equals the reference's at offset positions (1e-6);
* GQA and the whole rope + GQA + MoE LM: logits (2e-5), the loss with
  ``0.01 * aux`` (1e-5) and every parameter's gradient (1e-5), full and
  the port's full and flash attention (the flash wrapper's plain version
  on the CPU) held to the reference's full attention;
* dropout cannot follow ``jax.random``, so it is held to the reference's
  own properties (``tests/test_models.py:414``): eval is deterministic
  and equals dropout-free, train differs from eval, the same seed gives
  the same masks and another seed others;
* ``convert.py`` round-trips the new flax names (no ``Embed_1`` under
  rope);
* the trainer's cost profile of the extras LM counts exactly the matrix
  products (the expert GEMMs over every capacity slot) and the flash
  kernels' analytic count over the query heads."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_learning_tpu.models.moe import collect_load_balance_loss as jax_aux
from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.models.transformer import _rope as jax_rope
from distributed_learning_tpu_torch.convert import flax_to_torch, torch_to_flax
from distributed_learning_tpu_torch.models import TransformerLM
from distributed_learning_tpu_torch.models.moe import collect_load_balance_loss
from distributed_learning_tpu_torch.models.transformer import _rope
from distributed_learning_tpu_torch.training.trainer import GossipTrainer
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

V, T = 64, 16
BASE = dict(vocab_size=V, num_layers=2, num_heads=4, head_dim=8, max_len=T)
EXTRAS = dict(pos_emb="rope", num_kv_heads=2, mlp="moe", num_experts=4, moe_top_k=2,
              moe_capacity_factor=1.0)
COEF = 0.01


def _jax_lm(seed=0, **kw):
    model = JaxLM(**BASE, **kw)
    params = jax.jit(model.init)(jax.random.key(seed), np.zeros((1, T), np.int32))["params"]
    return model, params


def _port_lm(params, n_agents=1, **kw):
    tm = TransformerLM(n_agents=n_agents, device="cpu", **BASE, **kw)
    tm.load_stacked(flax_to_torch(params, n_agents=None if n_agents == 1 else n_agents))
    return tm


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rope_matches_jax(dtype):
    x = np.random.default_rng(0).normal(size=(3, 9, 4, 16)).astype(np.float32)
    pos = np.arange(40, 49)
    want = np.asarray(jax_rope(jnp.asarray(x, dtype), jnp.asarray(pos)).astype(jnp.float32))
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    got = _rope(torch.tensor(x).to(tdt), torch.tensor(pos)).float().numpy()
    # bf16: one rounding of the float32 rotation (2^-8 relative).
    np.testing.assert_allclose(got, want, atol=1e-6 if tdt is torch.float32 else 2e-2)
    with pytest.raises(ValueError, match="even head_dim"):
        _rope(torch.zeros(1, 2, 1, 3), torch.arange(2))


CONFIGS = {
    "gqa_rope": dict(num_kv_heads=2, pos_emb="rope"),
    "extras_window": dict(EXTRAS, attn_window=7),
}


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(name):
    """The reference's logits, loss (+ COEF * aux) and gradients for one
    configuration (full attention), computed once for both port paths."""
    jm, params = _jax_lm(seed=1, **CONFIGS[name])
    rng = np.random.default_rng(2)
    x = rng.integers(0, V, (2, T)).astype(np.int32)
    y = rng.integers(0, V, (2, T)).astype(np.int32)

    def jloss(p):
        logits, st = jm.apply({"params": p}, x, mutable=["moe_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        aux = jax_aux(st)
        return (loss if aux is None else loss + COEF * aux), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return params, x, y, float(jl), np.asarray(jlogits), flax_to_torch(jg)


@pytest.mark.parametrize("impl", ["full", "flash"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lm_loss_aux_and_grads_match_jax(name, impl):
    """The port's full and flash paths (the kernels' plain versions here)
    against the reference's full attention: the same function."""
    kw = CONFIGS[name]
    params, x, y, jl, jlogits, want = _jax_loss_and_grads(name)
    tm = _port_lm(params, attn_impl=impl, **kw)
    logits = tm(torch.tensor(x, dtype=torch.long)[None])
    loss = torch.nn.functional.cross_entropy(logits.reshape(-1, V),
                                             torch.tensor(y, dtype=torch.long).reshape(-1))
    aux = collect_load_balance_loss(tm)
    assert (aux is None) == ("mlp" not in kw)
    if aux is not None:
        loss = loss + COEF * aux[0]
    tm.flat_grads.zero_()
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy()[0], jlogits, atol=2e-5)
    assert float(loss.detach()) == pytest.approx(jl, abs=1e-5)
    assert set(want) == set(tm.stacked_parameters())
    for pname, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad[0].numpy(), want[pname], atol=1e-5, err_msg=pname)


def test_convert_round_trips_the_extras_names():
    _, params = _jax_lm(**EXTRAS)
    assert "Embed_1" not in params
    blk = params["_Block_0"]
    assert {"q_proj", "kv_proj", "DenseGeneral_1"} == set(blk["_Attention_0"])
    assert {"gate", "w_up", "b_up", "w_dn", "b_dn"} == set(blk["MoEMLP_0"])
    named = flax_to_torch(params)
    assert "pos_embed" not in named and "blocks.1.moe.w_up" in named
    assert named["blocks.0.attn.kv_proj"].shape == (32, 2, 2, 8)
    back = torch_to_flax(named)
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), b)
    tm = TransformerLM(n_agents=1, device="cpu", **BASE, **EXTRAS)
    assert set(tm.stacked_parameters()) == set(named)
    assert all(float(b.detach().abs().max()) == 0.0 for n, b in tm.stacked_parameters().items()
               if n.endswith(("b_up", "b_dn")))


def test_dropout_follows_the_reference_properties():
    kw = dict(BASE, num_layers=1, dropout_rate=0.5, pos_emb="rope", num_kv_heads=2)
    x = torch.tensor(np.random.default_rng(0).integers(0, V, (2, 2, T)), dtype=torch.long)

    def model(seed):
        return TransformerLM(n_agents=2, device="cpu", seed=seed, **kw)

    m = model(0)
    plain = TransformerLM(n_agents=2, device="cpu", seed=0, **dict(kw, dropout_rate=0.0))
    m.eval()
    a, b = m(x), m(x)
    assert torch.equal(a, b) and torch.equal(a, plain(x))
    m.train()
    t1 = m(x)
    assert float((t1 - a).abs().max()) > 1e-4
    t2 = m(x)  # the generators moved on: other masks
    assert float((t1 - t2).abs().max()) > 1e-4
    assert torch.equal(model(0).train()(x), t1)  # same seed, same masks
    other = model(0)
    other.seed_dropout(1)
    assert float((other.train()(x) - t1).abs().max()) > 1e-4
    m.set_dropout(False)
    assert torch.equal(m(x), a)


def test_cost_profile_counts_the_extras_products():
    """2 agents x B 2 x T 16, d 32, 2 KV heads, top-2 over 4 experts at
    capacity 1.0: per agent and layer the q / kv / out projections, the
    gate and the expert GEMMs over E * C slots (forward, dX, dW: 3x), the
    head likewise, and attention at 4 + 10 FLOPs per live pair and head
    dimension over the 4 query heads."""
    n, B, d, h, E, Hkv, H, Dh = 2, 2, 32, 128, 4, 2, 4, 8
    data = {a: (np.zeros((4, T), np.int32), np.zeros((4, T), np.int32)) for a in range(n)}
    t = GossipTrainer(node_names=list(range(n)), model="transformer", train_data=data,
                      model_kwargs=dict(BASE, attn_impl="flash", **EXTRAS), batch_size=B,
                      weights=np.full((n, n), 1.0 / n), device="cpu")
    S = B * T
    C = math.ceil(S / E * EXTRAS["moe_capacity_factor"])
    layer = 2 * S * d * (d + 2 * Hkv * Dh + d + E) + 2 * (2 * E * C * d * h)
    attn = 14 * B * H * (T * (T + 1) // 2) * Dh
    want = n * (3 * (BASE["num_layers"] * layer + 2 * S * d * V) + BASE["num_layers"] * attn)
    assert t.cost_profile().flops == want
