"""The port's agent-stacked ``MoEMLP`` (``models/moe.py``) against the JAX
package's, in float32 on the CPU, from the reference's init: outputs,
gradients (parameters and input), the load-balance aux and the dropped
fraction, for top-1 and top-2 routing, with ample capacity, with a
capacity low enough to drop tokens, and on the drop-free path.
Tolerance 1e-5 (float32 sums in another order; values O(1))."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.models.moe import MoEMLP as JaxMoE
from distributed_learning_tpu_torch.models.moe import MoEMLP, collect_load_balance_loss
from distributed_learning_tpu_torch.models.transformer import TransformerLM

B, T, D, E, RATIO = 2, 16, 32, 4, 2
TOL = 1e-5
NAMES = ("gate", "w_up", "b_up", "w_dn", "b_dn")


def _x(seed, n=None):
    shape = (B, T, D) if n is None else (n, B, T, D)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _flat(params):
    return {k: np.asarray(params["gate"]["kernel"] if k == "gate" else params[k]) for k in NAMES}


def _jax(top_k, factor, drop, seed):
    layer = JaxMoE(num_experts=E, mlp_ratio=RATIO, capacity_factor=factor, top_k=top_k,
                   drop_tokens=drop)
    x = _x(seed)
    params = jax.jit(layer.init)(jax.random.key(seed), jnp.asarray(x))["params"]
    return layer, params, x


def _port(stacked, top_k, factor):
    n = next(iter(stacked.values())).shape[0]
    m = MoEMLP(n, D, E, RATIO, factor, top_k, device="cpu")
    with torch.no_grad():
        for k in NAMES:
            getattr(m, k).copy_(torch.tensor(stacked[k]))
    return m


CASES = {
    "top1_ample": (1, 8.0, True),
    "top1_drops": (1, 0.25, True),
    "top2_queue": (2, 1.0, True),
    "top2_drops": (2, 0.5, True),
    "top2_dropfree": (2, 1.25, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_jax(case):
    top_k, factor, drop = CASES[case]
    layer, params, x = _jax(top_k, factor, drop, seed=sorted(CASES).index(case))
    cot = np.random.default_rng(99).normal(size=x.shape).astype(np.float32)

    def jloss(p, xx):
        out, st = layer.apply({"params": p}, xx, mutable=["moe_stats"])
        return jnp.sum(out * cot), (out, st["moe_stats"])

    (_, (jout, stats)), (jgp, jgx) = jax.jit(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    m = _port({k: v[None] for k, v in _flat(params).items()}, top_k, factor)
    xt = torch.tensor(x[None], requires_grad=True)
    out = m(xt, drop_tokens=drop)
    (out * torch.tensor(cot[None])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy()[0], np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy()[0], np.asarray(jgx), atol=TOL)
    for k, g in _flat(jgp).items():
        np.testing.assert_allclose(getattr(m, k).grad.numpy()[0], g, atol=TOL, err_msg=k)
    aux = stats["load_balance_loss"]
    np.testing.assert_allclose(float(m.aux[0].detach()), float(aux), atol=TOL)
    np.testing.assert_allclose(float(m.dropped_fraction[0]), float(stats["dropped_fraction"]),
                               atol=1e-7)
    if case.endswith("drops"):
        assert float(m.dropped_fraction[0]) > 0.0
        rows = out.detach().numpy()[0].reshape(-1, D)
        assert (np.abs(rows).sum(axis=1) == 0).any()  # a dropped token's output is zero


def test_second_choices_queue_behind_first():
    """Top-2 at capacity 1.0: the dropped fraction equals a replay of the
    priority rule (every first choice ranked in token order, then the
    second choices over the slack), and some drop."""
    layer, params, x = _jax(2, 1.0, True, seed=7)
    m = _port({k: v[None] for k, v in _flat(params).items()}, 2, 1.0)
    with torch.no_grad():
        m(torch.tensor(x[None]))
    tokens = x.reshape(-1, D)
    S = tokens.shape[0]
    C = max(1, math.ceil(S / E * 1.0))
    probs = np.asarray(jax.nn.softmax(jnp.asarray(tokens @ _flat(params)["gate"]), -1))
    first = np.argmax(probs, axis=-1)
    masked = probs.copy()
    masked[np.arange(S), first] = -1.0
    second = np.argmax(masked, axis=-1)
    counts, kept = np.zeros(E, int), 0
    for e in list(first) + list(second):
        if counts[e] < C:
            counts[e] += 1
            kept += 1
    expect = 1.0 - kept / (2 * S)
    assert expect > 0.0
    np.testing.assert_allclose(float(m.dropped_fraction[0]), expect, atol=1e-7)


def test_agents_route_and_compute_independently():
    """Two agents with their own weights and tokens: each equals the
    reference layer on its own; per-agent aux and dropped fraction."""
    trees = [_jax(2, 1.0, True, seed=s)[1] for s in (3, 4)]
    xs = _x(5, n=2)
    stacked = {k: np.stack([_flat(t)[k] for t in trees]) for k in NAMES}
    m = _port(stacked, 2, 1.0)
    with torch.no_grad():
        out = m(torch.tensor(xs)).numpy()
    layer = JaxMoE(num_experts=E, mlp_ratio=RATIO, capacity_factor=1.0, top_k=2)
    apply = jax.jit(lambda p, x: layer.apply({"params": p}, x, mutable=["moe_stats"]))
    for a, p in enumerate(trees):
        jout, st = apply(p, jnp.asarray(xs[a]))
        np.testing.assert_allclose(out[a], np.asarray(jout), atol=TOL)
        np.testing.assert_allclose(float(m.aux[a]), float(st["moe_stats"]["load_balance_loss"]),
                                   atol=TOL)
        np.testing.assert_allclose(float(m.dropped_fraction[a]),
                                   float(st["moe_stats"]["dropped_fraction"]), atol=1e-7)


def test_collect_load_balance_loss():
    """The mean over the MoE blocks of their (N,) aux; None without MoE."""
    kw = dict(vocab_size=16, num_layers=2, num_heads=2, head_dim=16, max_len=8, n_agents=2,
              device="cpu")
    dense = TransformerLM(**kw)
    dense(torch.zeros(2, 1, 8, dtype=torch.long))
    assert collect_load_balance_loss(dense) is None
    moe = TransformerLM(mlp="moe", num_experts=E, **kw)
    moe(torch.randint(0, 16, (2, 1, 8), generator=torch.Generator().manual_seed(0)))
    blocks = [b.moe.aux for b in moe.blocks]
    got = collect_load_balance_loss(moe)
    assert got.shape == (2,)
    torch.testing.assert_close(got, (blocks[0] + blocks[1]) / 2, rtol=0, atol=0)
    # Collected: the blocks no longer hold the forward's autograd graph.
    assert all(b.moe.aux is None for b in moe.blocks)
    with pytest.raises(ValueError, match="top_k"):
        MoEMLP(1, D, E, top_k=E + 1, device="cpu")
