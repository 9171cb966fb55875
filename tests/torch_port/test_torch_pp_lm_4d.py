"""The pipelined TransformerLM in its widest compositions on 16 gloo CPU
ranks (``sharded_ranks.battery_pp_4d``), at ``tests/test_pp_lm_4d.py``'s
sizes (vocab 32, 4 layers, 4 heads x 8, T 8, M 3, mb 4):

* dp x pp x sp x tp, (data 2, stage 2, seq 2, model 2), 1F1B with ring
  attention and Megatron stages: one SGD step at lr 1 against JAX
  ``value_and_grad`` of ``model.apply`` with full attention (no 16-device
  JAX: the oracle is unsharded), loss 1e-4, parameters 5e-4
  (``test_pp_lm_4d.py``'s limits);
* dp x pp x tp, (data 2, stage 2, model 2) with the rows split over a
  second data axis of 2: the same oracle and limits;
* pp x sp x ep, (data 2, stage 2, seq 2, expert 2), ring attention and
  expert-sharded MoE blocks under Adam: the loss falls over 4 steps and
  each rank holds half the experts (``test_pp_ep.py:233``, whose routing
  statistic per sequence shard has no closed-form oracle either).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu_torch.convert import pipeline_to_flax, torch_to_flax
from distributed_learning_tpu_torch.models.transformer import TransformerLM
from sharded_ranks import (
    PP4D_ADAM_STEPS,
    PP4D_LM,
    PP4D_M,
    PP4D_MB,
    PP4D_SEED,
    PP4D_T,
    Ranks,
    one_intra_op_thread,
)

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

LOSS_ATOL, PARAM_ATOL = 1e-4, 5e-4
SHAPES = {"4d": {"data": 2, "stage": 2, "seq": 2, "model": 2},
          "3d": {"data": 2, "stage": 2, "model": 2, "rows": 2}}


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    tok = rng.integers(0, PP4D_LM["vocab_size"], (PP4D_M, PP4D_MB, PP4D_T)).astype(np.int32)
    y = np.roll(tok, -1, axis=-1)
    ranks = Ranks("pp_4d", 16, {"tok": tok, "y": y})
    port = TransformerLM(**PP4D_LM, device="cpu", seed=PP4D_SEED)
    tree = torch_to_flax({k: v[0].detach().numpy() for k, v in port.stacked_parameters().items()})
    model = JaxLM(**PP4D_LM)

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(tok).reshape(-1, PP4D_T))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y).reshape(-1, PP4D_T)).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    expect = jax.tree.map(lambda p, g: np.asarray(p - g), tree, grads)
    return port, float(loss), expect, ranks.results()


@pytest.mark.parametrize("name", list(SHAPES))
def test_pipelined_step_matches_the_unsharded_oracle(world, name):
    port, loss, expect, res = world
    for r in res:
        assert abs(r[name]["loss"] - loss) < LOSS_ATOL, (r[name]["loss"], loss)
    got = pipeline_to_flax(port, [r[name]["params"] for r in res], SHAPES[name])
    leaves = jax.tree_util.tree_leaves_with_path(got)
    want = jax.tree_util.tree_leaves(expect)
    assert len(leaves) == len(want)
    for (path, a), b in zip(leaves, want):
        np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_pp_sp_ep_trains_with_half_the_experts_a_rank(world):
    _, _, _, res = world
    for r in res:
        losses = r["sp_ep"]["losses"]
        assert len(losses) == PP4D_ADAM_STEPS and np.all(np.isfinite(losses))
        assert losses[-1] < losses[0], losses
        assert r["sp_ep"]["w_up"][1] == 2  # 4 experts over the 2-way expert axis
