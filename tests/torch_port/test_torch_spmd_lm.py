"""``training/spmd_lm.py``: the agents x sequence-parallel LM step on 4
gloo ranks on the CPU regrouped as agents 2 x seq 2 (``GridMesh``,
spawned once for the module), against the JAX package's
``make_gossip_lm_step`` on a 2 x 2 ``(agents, seq)`` mesh of the
conftest's CPU devices: a 2-layer narrow ``TransformerLM``, the JAX
init converted, Adam at 3e-3, ``SPMD_STEPS`` steps on the reference
test's data (targets shifted on the global sequence).

Limits: each step's loss within 1e-5 relative; every parameter of each
agent's replica (the same on both ranks of its row) within 1e-5 after
the steps.  The port's ``ring``, ``ring_flash`` and ``ulysses`` steps
are each held against the JAX ``ring`` step, compiled once: the three
compute the same function of the parameters (each is exact attention),
and the JAX package's own tests hold its ``ring_flash`` step to its
``ring`` one; a JAX compile of this step costs about 10 s here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.training.spmd_lm import make_gossip_lm_step, stack_agent_states
from distributed_learning_tpu_torch.convert import flax_to_torch
from sharded_ranks import SPMD_LM, SPMD_STEPS, Ranks

N_AGENTS, N_SEQ, B, T = 2, 2, 4, 16
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, SPMD_LM["vocab_size"], size=(N_AGENTS, B))
    seq = (starts[..., None] + np.arange(T + 1)) % SPMD_LM["vocab_size"]
    return seq[..., :-1].astype(np.int32), seq[..., 1:].astype(np.int32)


@pytest.fixture(scope="module")
def world():
    x, y = _data()
    params, _ = stack_agent_states(JaxLM(**SPMD_LM, attn_impl="full"), optax.adam(3e-3),
                                   jax.random.key(0), jnp.asarray(x[0]), N_AGENTS)
    p0 = flax_to_torch(jax.tree.map(np.asarray, params), n_agents=N_AGENTS)
    ranks = Ranks("spmd_lm", N_AGENTS * N_SEQ,
                  dict(x=x, y=y, **{f"p0_{k}": v for k, v in p0.items()}))
    return x, y, params, ranks


_JAX = {}


def _jax_run(world, attn="ring"):
    if attn in _JAX:
        return _JAX[attn]
    x, y, params, _ = world
    mesh = Mesh(np.array(jax.devices()[:N_AGENTS * N_SEQ]).reshape(N_AGENTS, N_SEQ),
                ("agents", "seq"))
    tx = optax.adam(3e-3)
    step = make_gossip_lm_step(mesh, JaxLM(**SPMD_LM, attn_impl=attn, seq_axis="seq"), tx)
    opt = jax.vmap(tx.init)(params)
    p, losses = params, []
    with mesh:
        for _ in range(SPMD_STEPS):
            p, opt, loss = step(p, opt, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
    _JAX[attn] = losses, flax_to_torch(jax.tree.map(np.asarray, p), n_agents=N_AGENTS)
    return _JAX[attn]


@pytest.mark.parametrize("attn", ["ring", "ring_flash", "ulysses"])
def test_the_step_equals_the_jax_step(world, attn):
    losses, params = _jax_run(world)
    res = world[-1].results()
    for r in res:
        a, _ = r["coords"]
        np.testing.assert_allclose(r[f"{attn}_losses"], losses, rtol=LOSS_RTOL, atol=0)
        for name, v in r[f"{attn}_params"].items():
            np.testing.assert_allclose(v[0], params[name][a], atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{attn} agent {a} {name}")


def test_the_rows_hold_one_replica_and_the_agents_mix(world):
    """Both ranks of an agent's row hold the same replica (the gradient
    summed over seq), and the two agents differ (their batches do)."""
    res = world[-1].results()
    by_agent = {}
    for r in res:
        by_agent.setdefault(r["coords"][0], []).append(r["ring_params"])
    for a, reps in by_agent.items():
        for name in reps[0]:
            np.testing.assert_array_equal(reps[0][name], reps[1][name], err_msg=name)
    assert any(not np.array_equal(by_agent[0][0][k], by_agent[1][0][k]) for k in by_agent[0][0])
