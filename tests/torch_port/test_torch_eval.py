"""``training/eval.py``: the port's ``lm_cross_entropy`` / ``perplexity`` on
its 2-layer narrow TransformerLM against the JAX package's, from
converted flax weights, float32 on the CPU (``attn_impl`` full and
flash; the flash wrapper runs its plain version here).  Limit: 1e-5
relative (the same float32 sums of O(1) cross entropies in another
order).  The same inputs are rejected with the same messages."""

import jax
import numpy as np
import pytest
import torch

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.training import eval as jeval
from distributed_learning_tpu_torch.convert import flax_to_torch
from distributed_learning_tpu_torch.models import TransformerLM
from distributed_learning_tpu_torch.training import eval as teval
from sharded_ranks import one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

V, T, L, H, DH = 64, 32, 2, 2, 16
CFG = dict(vocab_size=V, num_layers=L, num_heads=H, head_dim=DH, max_len=T)


def _pair(impl, seeds=(0,)):
    jm = JaxLM(attn_impl=impl, **CFG)
    x0 = np.zeros((1, T), np.int32)
    params = [jax.jit(jm.init)(jax.random.key(s), x0)["params"] for s in seeds]
    tm = TransformerLM(attn_impl=impl, n_agents=len(seeds), device="cpu", **CFG)
    stacked = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]), *params)
    tm.load_stacked(flax_to_torch(stacked, n_agents=len(seeds)))
    return jm, params, tm


def _tokens(n=6, seed=3):
    return np.random.default_rng(seed).integers(0, V, (n, T)).astype(np.int32)


@pytest.mark.parametrize("batch_size", [None, 2, 3])
@pytest.mark.parametrize("impl", ["full", "flash"])
def test_cross_entropy_and_perplexity_match_jax(impl, batch_size):
    jm, (params,), tm = _pair(impl)
    toks = _tokens()
    jce, jn = jeval.lm_cross_entropy(jm, params, jax.numpy.asarray(toks), batch_size=batch_size)
    tce, tn = teval.lm_cross_entropy(tm, toks, batch_size=batch_size)
    assert tn == jn == 6 * (T - 1)
    assert isinstance(tce, float) and tce == pytest.approx(jce, rel=1e-5)
    jppl = jeval.perplexity(jm, params, jax.numpy.asarray(toks), batch_size=batch_size)
    tppl = teval.perplexity(tm, torch.as_tensor(toks), batch_size=batch_size)
    assert tppl == pytest.approx(jppl, rel=1e-5)
    assert np.isfinite(tppl) and tppl > 1.0  # random weights: not calibrated, may exceed V


def test_per_agent_means_for_a_stacked_model():
    jm, params, tm = _pair("flash", seeds=(0, 1))
    toks = _tokens(4)
    ce, n = teval.lm_cross_entropy(tm, toks, batch_size=2)
    assert ce.shape == (2,) and n == 4 * (T - 1)
    for a, p in enumerate(params):
        want, _ = jeval.lm_cross_entropy(jm, p, jax.numpy.asarray(toks), batch_size=2)
        assert ce[a] == pytest.approx(want, rel=1e-5)
    assert np.allclose(teval.perplexity(tm, toks), np.exp(ce), rtol=1e-6)


def test_eval_leaves_the_mode_and_runs_without_grad():
    _, _, tm = _pair("full")
    tm.train()
    teval.lm_cross_entropy(tm, _tokens(2))
    assert tm.training and tm.flat_grads.abs().sum() == 0


@pytest.mark.parametrize("tokens,kw", [
    (np.zeros((4, 1), np.int32), {}),
    (np.zeros((4, 8), np.int32), {"batch_size": 3}),
    (np.zeros((4, 8), np.int32), {"batch_size": 0}),
])
def test_rejects_what_the_reference_rejects(tokens, kw):
    jm, (params,), tm = _pair("full")
    with pytest.raises(ValueError) as jerr:
        jeval.lm_cross_entropy(jm, params, jax.numpy.asarray(tokens), **kw)
    with pytest.raises(ValueError) as terr:
        teval.lm_cross_entropy(tm, tokens, **kw)
    assert str(terr.value) == str(jerr.value)
