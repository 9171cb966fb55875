"""KV-cache decode and ``generate`` of the port's ``TransformerLM``
against the JAX package's, float32 on the CPU, from the reference's init
through ``convert.py`` (2 layers, d 32 = 4 heads x 8, vocab 64; 4 heads x
32, the head dim whose bf16 forward runs the wgmma body on the card; and
2 heads x 512, whose bf16 forward runs the wide wgmma body there).

* greedy ``generate`` token ids equal the reference's for MHA with
  learned positions, GQA with rope and a window, and rope + GQA + MoE
  (drop-free in decode), through the port's full and flash paths (the
  flash prefill runs the kernel's plain version here);
* the logits of a prefill plus single-token steps equal a full forward
  over the same tokens at those positions (2e-5), windowed and MoE
  models included (``tests/test_models.py:158, 487``); a cache write one
  slot off does not;
* a step past the cache is NaN and stays NaN (``:521``);
* ``validate_sampling`` raises the reference's errors for the same
  arguments;
* the top-k / top-p truncation is the reference's rule (``:553``): with
  the reference's own Gumbel noise, ``argmax(truncated + noise)`` equals
  the reference's ``pick`` token for token, and top-k 1 or a tiny top-p
  collapse sampling to greedy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.models.transformer import generate as jax_generate
from distributed_learning_tpu.models.transformer import sample_fn as jax_sample_fn
from distributed_learning_tpu.models.transformer import validate_sampling as jax_validate
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.models import TransformerLM
from distributed_learning_tpu_torch.models import transformer as tr
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

V, L = 64, 24
BASE = dict(vocab_size=V, num_layers=2, num_heads=4, head_dim=8, max_len=L)
CONFIGS = {
    "mha": {},
    "gqa_rope_window": dict(num_kv_heads=2, pos_emb="rope", attn_window=5),
    "rope_gqa_moe": dict(num_kv_heads=2, pos_emb="rope", mlp="moe", num_experts=4,
                         moe_top_k=2, moe_capacity_factor=8.0),
    "head_dim_32": dict(head_dim=32),
    "head_dim_512": dict(num_heads=2, head_dim=512),
}


def _config(name):
    return {**BASE, **CONFIGS[name]}
TP, STEPS = 7, 8


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's init, prompt (2 agents' worth, 2 sequences each)
    and greedy tokens for one configuration."""
    jm = JaxLM(**_config(name))
    params = jax.jit(jm.init)(jax.random.key(3), np.zeros((1, TP), np.int32))["params"]
    prompt = np.random.default_rng(4).integers(0, V, (2, TP)).astype(np.int32)
    toks = np.asarray(jax_generate(jm, params, jnp.asarray(prompt), STEPS))
    return params, prompt, toks


def _port(name, impl="full", n_agents=1, params=None):
    tm = TransformerLM(attn_impl=impl, n_agents=n_agents, device="cpu", **_config(name))
    if params is not None:
        tm.load_stacked(flax_to_torch(params))
    return tm


@pytest.mark.parametrize("impl", ["full", "flash"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_generate_matches_jax(name, impl):
    params, prompt, want = _reference(name)
    tm = _port(name, impl, params=params)
    got = tr.generate(tm, torch.tensor(prompt)[None], STEPS)
    assert got.dtype == torch.int32 and got.shape == (1, 2, STEPS)
    np.testing.assert_array_equal(got[0].numpy(), want)


def test_agents_decode_from_their_own_parameters():
    """Agent ``a`` of a stacked model generates what a one-agent model
    with agent ``a``'s weights generates."""
    params, prompt, want = _reference("mha")
    tm = _port("mha", n_agents=2)
    single = _port("mha", params=params)
    stacked = {k: np.stack([v[0].detach().numpy(), tm.stacked_parameters()[k][1].detach().numpy()])
               for k, v in single.stacked_parameters().items()}
    tm.load_stacked(stacked)
    got = tr.generate(tm, torch.tensor(np.stack([prompt, prompt])), STEPS)
    np.testing.assert_array_equal(got[0].numpy(), want)
    solo = _port("mha")
    solo.load_stacked({k: v[1] for k, v in stacked.items()})
    np.testing.assert_array_equal(got[1].numpy(),
                                  tr.generate(solo, torch.tensor(prompt)[None], STEPS)[0].numpy())


def _decode_logits(tm, seq, tp):
    """Logits of a prefill over ``seq[..., :tp]`` then one step per later
    token, at each step's position."""
    cache = tm.init_cache(seq.shape[1])
    out = [tm(seq[..., :tp], cache)[:, :, -1]]
    for t in range(tp, seq.shape[-1] - 1):
        out.append(tm(seq[..., t:t + 1], cache)[:, :, -1])
    return torch.stack(out, dim=2)


def _write_one_slot_off(ck, cv, k, v, i):
    """The control: every cache write lands one slot later."""
    L, T = ck.shape[1], k.shape[1]
    slots = (i + 1 + torch.arange(T)).clamp(max=L - 1)
    ck.index_copy_(1, slots, k.to(ck.dtype))
    cv.index_copy_(1, slots, v.to(cv.dtype))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decode_logits_equal_a_full_forward(name, monkeypatch):
    tm = _port(name, "flash", n_agents=2)
    tm.eval()
    seq = torch.tensor(np.random.default_rng(5).integers(0, V, (2, 3, 16)), dtype=torch.long)
    with torch.no_grad():
        dec = _decode_logits(tm, seq, TP)
        full = tm(seq)[:, :, TP - 1:-1]
        monkeypatch.setattr(tr._Attention, "_write_cache", staticmethod(_write_one_slot_off))
        bad = _decode_logits(tm, seq, TP)
    torch.testing.assert_close(dec, full, atol=2e-5, rtol=0)
    assert float((bad - full).abs().max()) > 1e-2


def test_a_step_past_the_cache_is_nan():
    tm = _port("mha")
    prompt = torch.tensor(np.random.default_rng(6).integers(0, V, (1, 1, L)), dtype=torch.long)
    with torch.no_grad():
        cache = tm.init_cache(1)
        assert torch.isfinite(tm(prompt, cache)).all()  # exactly fills the cache
        for _ in range(2):
            assert torch.isnan(tm(torch.zeros(1, 1, 1, dtype=torch.long), cache)).all()
        with pytest.raises(ValueError, match="exceeds the cache"):
            tm(torch.zeros(1, 1, L + 1, dtype=torch.long), tm.init_cache(1))


@pytest.mark.parametrize("args", [
    (20, 5, None, 0.0, None, None),        # prompt + steps > max_len
    (4, 2, None, 1.0, None, None),         # sampling without a key
    (4, 2, None, 0.0, 4, None),            # top_k under greedy
    (4, 2, "key", 1.0, 0, None),           # top_k out of range
    (4, 2, "key", 1.0, V + 1, None),
    (4, 2, "key", 1.0, None, 1.5),         # top_p out of range
    (4, 2, "key", 1.0, None, 0.0),
])
def test_validate_sampling_raises_the_references_errors(args):
    tp, steps, key, temp, top_k, top_p = args
    jm = JaxLM(**BASE)
    with pytest.raises(ValueError) as want:
        jax_validate(jm, tp, steps, jax.random.key(0) if key else None, temp, top_k, top_p)
    with pytest.raises(ValueError) as got:
        tr.validate_sampling(_port("mha"), tp, steps, torch.Generator() if key else None,
                             temp, top_k, top_p)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 5, None), (0.7, None, 0.8), (1.3, 10, 0.6), (1.0, None, 1.0), (0.9, V, 0.95)])
def test_truncation_is_the_references_rule(temp, top_k, top_p):
    logits = np.random.default_rng(8).normal(scale=2.0, size=(256, V)).astype(np.float32)
    pick = jax_sample_fn(temp, top_k, top_p)
    keys = jax.random.split(jax.random.key(9), 8)
    trunc = tr.truncate_logits(torch.tensor(logits), temp, top_k, top_p).numpy()
    for k in keys:
        noise = np.asarray(jax.random.gumbel(k, logits.shape, jnp.float32))
        want = np.asarray(pick(jnp.asarray(logits), k, jnp.int32))
        np.testing.assert_array_equal(np.argmax(trunc + noise, axis=-1), want)
    kept = np.isfinite(trunc).sum(-1)
    assert kept.min() >= 1 and (top_k is None or kept.max() <= top_k)


def test_sampling_collapses_to_greedy_and_replays_with_a_seed():
    params, prompt, greedy = _reference("mha")
    tm = _port("mha", params=params)
    p = torch.tensor(prompt)[None]
    for kw in (dict(top_k=1), dict(top_p=1e-6)):
        got = tr.generate(tm, p, STEPS, key=torch.Generator().manual_seed(1), temperature=1.0, **kw)
        np.testing.assert_array_equal(got[0].numpy(), greedy)
    s1, s2 = (tr.generate(tm, p, STEPS, key=torch.Generator().manual_seed(3), temperature=0.8,
                          top_k=8, top_p=0.9) for _ in range(2))
    assert torch.equal(s1, s2) and bool(((s1 >= 0) & (s1 < V)).all())
