"""ROADMAP item 5a on gloo CPU ranks: tensor parallelism with TP decode,
FSDP, gossip x FSDP / gossip x TP and the expert-parallel MoE LM.

One 4-rank world for the module (``sharded_ranks.battery_tp_fsdp``,
spawned once; the pytest process compiles and runs the JAX side while the
ranks run), regrouped per case as the JAX meshes of the conftest's CPU
devices are laid out (ranks row-major, rank r = device r):

* ``make_tp_train_step`` on (data 2, model 2) for MHA, GQA (2 K/V heads,
  the cache sharded) and MQA (1 K/V head, the replicated-K/V fallback),
  2 SGD steps at lr 0.1 (the steps take any optimizer; JAX compiles an
  Adam step at 2-3x the cost of an SGD one, and the port's Adam is held
  to optax in ``test_torch_adam.py``): each step's loss within 1e-5
  relative and every block within 1e-5 of the JAX step's (the limits of
  ``test_torch_spmd_lm.py``); the whole leaves equal along the model
  line bit for bit;
* ``make_tp_generate`` greedy: tokens equal to the JAX
  ``make_tp_generate``'s; sampled: equal to the port's one-process
  ``generate`` with the same generator seed; the cache blocks
  ``(B/2, L, Hkv/2, Dh)`` (all ``Hkv`` under the fallback) equal to
  ``constrain_decode_cache``'s;
* ``make_fsdp_train_step`` on data 4, dense and MoE (``moe_aux_coef``
  0.01, top-2 routing of the global batch): the gathered init equal to
  the unsharded one bit for bit, losses 1e-5 relative, blocks 1e-5;
* ``make_gossip_fsdp_step`` on (agents 2, data 2) and
  ``make_gossip_tp_step`` on (agents 2, model 2), W = [[.75, .25], [.25,
  .75]], 2 steps: the same limits;
* ``TransformerLM(moe_expert_axis="expert")`` on (data 2, expert 2): the
  logits of each rank's rows and one step's gradient (averaged over data)
  against the JAX ``shard_moe_params`` + ``jax.jit`` forward and its
  gradient (one program), within ``test_moe.py``'s 2e-5; a lone
  expert-parallel ``MoEMLP`` against the whole layer, both routes (1e-5);
* every builder refuses a dropout model (``reject_dropout_model``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from distributed_learning_tpu.models.moe import apply_collecting_moe_aux, shard_moe_params
from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.training import fsdp as jfsdp
from distributed_learning_tpu.training import gossip_fsdp as jgossip
from distributed_learning_tpu.training import tp as jtp
from distributed_learning_tpu_torch.convert import (
    flax_to_torch,
    flax_to_torch_shards,
    torch_to_flax,
)
from distributed_learning_tpu_torch.models.transformer import TransformerLM
from distributed_learning_tpu_torch.parallel.multihost import MeshPosition
from distributed_learning_tpu_torch.training import fsdp, gossip_fsdp, tp
from distributed_learning_tpu_torch.training.trainer import make_optimizer
from sharded_ranks import (
    PAR_AUX,
    PAR_GEN_STEPS,
    PAR_KV,
    PAR_LM,
    PAR_LR,
    PAR_MOE,
    PAR_PROMPT,
    PAR_STEPS,
    PAR_W,
    Ranks,
)

B, T = 4, 16
RTOL = ATOL = 1e-5
EP_TOL = 2e-5
TP_SHAPE, FSDP_SHAPE = {"data": 2, "model": 2}, {"data": 4}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(shape):
    return Mesh(np.array(jax.devices()[:4]).reshape(tuple(shape.values())), tuple(shape))


def _data():
    rng = np.random.default_rng(0)
    seq = (rng.integers(0, PAR_LM["vocab_size"], (B, 1)) + np.arange(T + 1)) % PAR_LM["vocab_size"]
    gseq = (rng.integers(0, PAR_LM["vocab_size"], (2, B, 1)) + np.arange(T + 1)) \
        % PAR_LM["vocab_size"]
    prompt = rng.integers(0, PAR_LM["vocab_size"], (B, PAR_PROMPT))
    return dict(x=seq[:, :-1].astype(np.int32), y=seq[:, 1:].astype(np.int32),
                gx=gseq[..., :-1].astype(np.int32), gy=gseq[..., 1:].astype(np.int32),
                prompt=prompt.astype(np.int32))


def _run(step, p, o, x, y):
    losses = []
    for _ in range(PAR_STEPS):
        p, o, loss = step(p, o, x, y)
        losses.append(float(loss))
    return losses, _np(p)


def _jax_side(d, inits):
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    tx = optax.sgd(PAR_LR)
    out = {}
    mesh = _mesh(TP_SHAPE)
    with mesh:
        for kind, kv in PAR_KV.items():
            model, params = inits[f"tp_{kind}"]
            p = jtp.shard_transformer_params(params, mesh)
            step = jtp.make_tp_train_step(mesh, model, tx, moe_aux_coef=PAR_AUX)
            out[f"tp_{kind}"] = _run(step, p, tx.init(p), x, y)
            gen = jtp.make_tp_generate(mesh, model)
            out[f"gen_{kind}"] = np.asarray(gen(p, jnp.asarray(d["prompt"]), PAR_GEN_STEPS))
    mesh = _mesh(FSDP_SHAPE)
    with mesh:
        for kind in ("dense", "moe"):
            model, params = inits[f"fsdp_{kind}"]
            p = jfsdp.shard_params_fsdp(params, mesh)
            step = jfsdp.make_fsdp_train_step(mesh, model, tx, moe_aux_coef=PAR_AUX)
            out[f"fsdp_{kind}"] = _run(step, p, tx.init(p), x, y)
    model, (stacked, opt) = inits["gossip"]
    W = jnp.asarray(PAR_W, jnp.float32)
    gx, gy = jnp.asarray(d["gx"]), jnp.asarray(d["gy"])
    mesh = _mesh({"agents": 2, "data": 2})
    with mesh:
        step = jgossip.make_gossip_fsdp_step(mesh, model, tx, W)
        out["gossip_fsdp"] = _run(step, jgossip.shard_stacked_fsdp(stacked, mesh),
                                  jgossip.shard_stacked_fsdp(opt, mesh), gx, gy)
    mesh = _mesh({"agents": 2, "model": 2})
    with mesh:
        step = jgossip.make_gossip_tp_step(mesh, model, tx, W)
        out["gossip_tp"] = _run(step, jgossip.shard_stacked_tp(stacked, mesh), opt, gx, gy)
    model, params = inits["ep"]
    mesh = _mesh({"data": 2, "expert": 2})
    with mesh:
        sharded = shard_moe_params(params, mesh, "expert")

        def loss_fn(p):
            # One program for the forward (the logits ride along) and its
            # gradient.
            lg, aux = apply_collecting_moe_aux(model, p, x)
            return (optax.softmax_cross_entropy_with_integer_labels(lg, y).mean()
                    + PAR_AUX * aux), lg

        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(sharded)
    out["ep"] = np.asarray(logits), float(loss), _np(grads)
    return out


def _init(seed, **kw):
    """A JAX model and its parameters: the port's init from ``seed`` as a
    flax tree (one init on both sides; flax's own init would cost the
    module several seconds of eager dispatch)."""
    port = TransformerLM(**PAR_LM, **kw, device="cpu", seed=seed)
    tree = torch_to_flax({k: v[0].detach().numpy() for k, v in
                          port.stacked_parameters().items()})
    return JaxLM(**PAR_LM, **kw), tree


@pytest.fixture(scope="module")
def world():
    d = _data()
    inits, inputs = {}, dict(d)
    for i, (kind, kv) in enumerate(PAR_KV.items()):
        inits[f"tp_{kind}"] = _init(i, num_kv_heads=kv)
    inits["fsdp_dense"] = inits["tp_mha"]
    inits["fsdp_moe"] = inits["ep"] = _init(7, **PAR_MOE)
    model, params = inits["tp_mha"]
    stacked = jax.tree.map(lambda v: np.broadcast_to(v[None], (2,) + v.shape), params)
    inits["gossip"] = model, (stacked, jax.vmap(optax.sgd(PAR_LR).init)(stacked))
    for name, (_, params) in inits.items():
        if name == "gossip":
            conv = flax_to_torch(params[0], n_agents=2)
        else:
            conv = flax_to_torch(params)
        inputs.update({f"{name}_{k}": v for k, v in conv.items()})
    ranks = Ranks("tp_fsdp", 4, inputs)
    return d, inits, _jax_side(d, inits), ranks.results()


def _blocks(tree, shape, rank, layout, **kw):
    return flax_to_torch_shards(tree, MeshPosition.of_rank(shape, rank), layout, **kw)


def _check_params(got, want, what):
    assert set(got) == set(want), what
    for name, v in got.items():
        np.testing.assert_allclose(v.reshape(want[name].shape), want[name], atol=ATOL, rtol=0,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("kind", list(PAR_KV))
def test_tp_step_equals_the_jax_step(world, kind):
    _, _, jx, res = world
    losses, final = jx[f"tp_{kind}"]
    for r, out in enumerate(res):
        np.testing.assert_allclose(out[f"tp_{kind}_losses"], losses, rtol=RTOL, atol=0)
        _check_params(out[f"tp_{kind}_params"], _blocks(final, TP_SHAPE, r, "tp"),
                      f"rank {r}")


@pytest.mark.parametrize("kind", list(PAR_KV))
def test_tp_whole_leaves_stay_equal_along_the_model_line(world, kind):
    """Dense_0's bias (and MQA's replicated kv_proj) are read in blocks:
    their gradient is summed over the model axis, so every whole leaf is
    the same on both ranks of a model line after the steps."""
    _, inits, _, res = world
    whole = flax_to_torch(inits[f"tp_{kind}"][1])
    assert any(n.endswith("fc1.bias") for n in res[0][f"tp_{kind}_partial"])
    assert any(n.endswith("attn.kv_proj") for n in res[0][f"tp_{kind}_partial"]) == (kind == "mqa")
    for a, b in ((0, 1), (2, 3)):
        pa, pb = res[a][f"tp_{kind}_params"], res[b][f"tp_{kind}_params"]
        for name, v in pa.items():
            if v.shape[1:] == whole[name].shape:
                np.testing.assert_array_equal(v, pb[name], err_msg=name)


@pytest.mark.parametrize("kind", list(PAR_KV))
def test_tp_greedy_decode_equals_the_jax_tp_decode(world, kind):
    _, _, jx, res = world
    for out in res:
        np.testing.assert_array_equal(out[f"gen_{kind}"], jx[f"gen_{kind}"])


@pytest.mark.parametrize("kind", list(PAR_KV))
def test_tp_sampled_decode_equals_one_process_generate(world, kind):
    for out in world[-1]:
        got, want = out[f"sampled_{kind}"]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", list(PAR_KV))
def test_tp_cache_blocks(world, kind):
    kv = PAR_KV[kind] or PAR_LM["num_heads"]
    heads = kv // 2 if kv % 2 == 0 else kv
    want = (B // 2, PAR_LM["max_len"], heads, PAR_LM["head_dim"])
    for out in world[-1]:
        assert set(out[f"cache_{kind}"]) == {want}
        assert set(out[f"constrained_{kind}"]) == {want}


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_fsdp_step_equals_the_jax_step(world, kind):
    _, _, jx, res = world
    losses, final = jx[f"fsdp_{kind}"]
    for r, out in enumerate(res):
        assert out[f"fsdp_{kind}_gathered_bitwise"]
        np.testing.assert_allclose(out[f"fsdp_{kind}_losses"], losses, rtol=RTOL, atol=0)
        _check_params(out[f"fsdp_{kind}_params"], _blocks(final, FSDP_SHAPE, r, "fsdp"),
                      f"rank {r}")


@pytest.mark.parametrize("kind", ["fsdp", "tp"])
def test_gossip_step_equals_the_jax_step(world, kind):
    _, _, jx, res = world
    losses, final = jx[f"gossip_{kind}"]
    shape = {"agents": 2, "data" if kind == "fsdp" else "model": 2}
    for r, out in enumerate(res):
        np.testing.assert_allclose(out[f"gossip_{kind}_losses"], losses, rtol=RTOL, atol=0)
        want = _blocks(final, shape, r, kind, n_agents=2)
        _check_params(out[f"gossip_{kind}_params"], want, f"rank {r}")


def test_expert_parallel_forward_equals_the_jax_forward(world):
    _, _, jx, res = world
    logits = jx["ep"][0]
    for out in res:
        a = out["ep_coords"]["data"]
        np.testing.assert_allclose(out["ep_logits"], logits[a * B // 2:(a + 1) * B // 2],
                                   atol=EP_TOL, rtol=0)


def test_expert_parallel_gradient_equals_the_jax_gradient(world):
    _, _, jx, res = world
    _, loss, grads = jx["ep"]
    for r, out in enumerate(res):
        np.testing.assert_allclose(out["ep_loss"], loss, rtol=RTOL, atol=0)
        want = _blocks(grads, {"data": 2, "expert": 2}, r, "ep")
        for name, v in out["ep_grads"].items():
            np.testing.assert_allclose(v.reshape(want[name].shape), want[name], atol=EP_TOL,
                                       rtol=0, err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("route", ["dispatch", "dropfree"])
def test_expert_parallel_layer_equals_the_whole_layer(world, route):
    """A lone ``MoEMLP(expert_mesh=)`` (its E/2 experts, the combine's
    all_reduce) equals the whole layer it was cut from, on the capacity
    dispatch and on decode's drop-free path: the output, the gate's
    gradient and its experts' gradients (float32 sums in another order)."""
    for out in world[-1]:
        for what, err in out[f"ep_layer_{route}"].items():
            assert err <= 1e-5, (what, err)


def _builders():
    sgd = make_optimizer("sgd", None, PAR_LR)
    return {
        "tp": lambda m: tp.make_tp_train_step(None, m, sgd),
        "fsdp": lambda m: fsdp.make_fsdp_train_step(None, m, sgd),
        "gossip_fsdp": lambda m: gossip_fsdp.make_gossip_fsdp_step(None, m, sgd, PAR_W),
        "gossip_tp": lambda m: gossip_fsdp.make_gossip_tp_step(None, m, sgd, PAR_W),
    }


@pytest.mark.parametrize("builder", ["tp", "fsdp", "gossip_fsdp", "gossip_tp"])
def test_builders_refuse_a_dropout_model(builder):
    model = TransformerLM(**PAR_LM, dropout_rate=0.1, device="cpu")
    with pytest.raises(ValueError, match="dropout_rate > 0"):
        _builders()[builder](model)
    assert torch.is_tensor(model.flat_params)
