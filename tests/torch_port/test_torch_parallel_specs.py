"""The placement functions of ROADMAP item 5a against the JAX package's,
in one process (no ranks): on real TransformerLM parameter trees (MHA, GQA
with 2 K/V heads, MQA, and an MoE LM, each held in flax's layout) and
2- and 4-way axes,

* every spec (``transformer_tp_rules`` with ``divisible_or_replicated``,
  ``fsdp_spec`` with and without ``avoid``, the stacked specs of
  ``gossip_fsdp`` and ``moe_param_spec``) equals the reference's as a
  tuple, leaf by leaf;
* every rank's block from the port's ``shard_*`` function (rank ``r`` at
  its row-major place, ``MeshPosition.of_rank``) equals the
  ``addressable_shards`` entry of device ``r`` of the array the
  reference's ``shard_*`` puts on the conftest's CPU devices, exactly.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from distributed_learning_tpu.models import moe as jmoe
from distributed_learning_tpu.training import fsdp as jfsdp
from distributed_learning_tpu.training import gossip_fsdp as jgossip
from distributed_learning_tpu.training import tp as jtp
from distributed_learning_tpu_torch.convert import torch_to_flax
from distributed_learning_tpu_torch.models import moe
from distributed_learning_tpu_torch.models.transformer import TransformerLM
from distributed_learning_tpu_torch.parallel.multihost import MeshPosition
from distributed_learning_tpu_torch.training import fsdp, gossip_fsdp, tp

LM = dict(vocab_size=32, num_layers=2, num_heads=4, head_dim=8, max_len=16)
KINDS = {"mha": {}, "gqa": {"num_kv_heads": 2}, "mqa": {"num_kv_heads": 1},
         "moe": {"mlp": "moe", "num_experts": 4, "moe_top_k": 2, "num_kv_heads": 2}}
SIZES = (2, 4)


def _tree(kind):
    port = TransformerLM(**LM, **KINDS[kind], device="cpu", seed=1)
    return torch_to_flax({k: v[0].detach().numpy() for k, v in port.stacked_parameters().items()})


def _mesh(shape):
    n = int(np.prod(list(shape.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _same_blocks(port_shard, jax_tree, shape):
    """Rank r's port block of every leaf equals device r's shard."""
    n = int(np.prod(list(shape.values())))
    jax_leaves = _leaves(jax_tree)
    for r in range(n):
        port_leaves = _leaves(port_shard(MeshPosition.of_rank(shape, r)))
        assert len(port_leaves) == len(jax_leaves)
        for (path, got), (_, arr) in zip(port_leaves, jax_leaves):
            want = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}[r]
            np.testing.assert_array_equal(np.asarray(got), want,
                                          err_msg=f"rank {r} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_tp_rules_and_blocks_equal_the_reference(kind, n):
    tree = _tree(kind)
    shape = {"data": 2, "model": n}
    mesh = _mesh(shape)
    for path, leaf in _leaves(tree):
        want = jtp._divisible_or_replicated(jtp.transformer_tp_rules(path, leaf, "model"),
                                            leaf, mesh, "model")
        got = tp.divisible_or_replicated(tp.transformer_tp_rules(path, leaf, "model"),
                                         leaf, MeshPosition.of_rank(shape, 0), "model")
        assert tuple(got) == tuple(want), jax.tree_util.keystr(path)
    _same_blocks(lambda pos: tp.shard_transformer_params(tree, pos),
                 jtp.shard_transformer_params(tree, mesh), shape)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_fsdp_specs_and_blocks_equal_the_reference(kind, n):
    tree = _tree(kind)
    for path, leaf in _leaves(tree):
        assert tuple(fsdp.fsdp_spec(leaf, n, "data")) == tuple(jfsdp.fsdp_spec(leaf, n, "data"))
        avoid = jtp.transformer_tp_rules(path, leaf, "model")
        assert tuple(fsdp.fsdp_spec(leaf, n, "data", avoid=tp.P(*avoid))) == \
            tuple(jfsdp.fsdp_spec(leaf, n, "data", avoid=avoid)), jax.tree_util.keystr(path)
    shape = {"data": n}
    _same_blocks(lambda pos: fsdp.shard_params_fsdp(tree, pos),
                 jfsdp.shard_params_fsdp(tree, _mesh(shape)), shape)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_specs_and_blocks_equal_the_reference(kind, n):
    stacked = jax.tree.map(lambda v: np.stack([v, v + 1.0]), _tree(kind))
    fs, ts = {"agents": 2, "data": n}, {"agents": 2, "model": n}
    fmesh, tmesh = _mesh(fs), _mesh(ts)
    for path, leaf in _leaves(stacked):
        assert tuple(gossip_fsdp._stacked_spec(leaf, n, "agents", "data")) == \
            tuple(jgossip._stacked_spec(leaf, n, "agents", "data"))
        assert tuple(gossip_fsdp._stacked_megatron_spec(path, leaf, MeshPosition.of_rank(ts, 0),
                                                        "agents", "model")) == \
            tuple(jgossip._stacked_megatron_spec(path, leaf, tmesh, "agents", "model"))
    _same_blocks(lambda pos: gossip_fsdp.shard_stacked_fsdp(stacked, pos),
                 jgossip.shard_stacked_fsdp(stacked, fmesh), fs)
    _same_blocks(lambda pos: gossip_fsdp.shard_stacked_tp(stacked, pos),
                 jgossip.shard_stacked_tp(stacked, tmesh), ts)


def _moe_tree(tree_of):
    """The MoE LM's tree, or a lone MoEMLP(num_experts=4) layer's at d 8,
    h 32."""
    if tree_of == "lm":
        return _tree("moe")
    rng = np.random.default_rng(0)
    return {"gate": {"kernel": rng.normal(size=(8, 4)).astype(np.float32)},
            "w_up": rng.normal(size=(4, 8, 32)).astype(np.float32),
            "b_up": rng.normal(size=(4, 32)).astype(np.float32),
            "w_dn": rng.normal(size=(4, 32, 8)).astype(np.float32),
            "b_dn": rng.normal(size=(4, 8)).astype(np.float32)}


@pytest.mark.parametrize("tree_of", ["lm", "layer"])
def test_moe_param_spec_equals_the_reference(tree_of):
    """Expert kernels and biases split their expert axis; the gate and
    every other leaf stay whole."""
    seen = 0
    for path, leaf in _leaves(_moe_tree(tree_of)):
        got = moe.moe_param_spec(path, leaf, "expert")
        assert tuple(got) == tuple(jmoe.moe_param_spec(path, leaf, "expert"))
        seen += any(got)
    assert seen == 4 * (LM["num_layers"] if tree_of == "lm" else 1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("tree_of", ["lm", "layer"])
def test_shard_moe_params_equals_the_reference(tree_of, n):
    """Every rank's block equals the reference's shard on device r."""
    tree = _moe_tree(tree_of)
    shape = {"data": 8 // n, "expert": n}
    _same_blocks(lambda pos: moe.shard_moe_params(tree, pos, "expert"),
                 jmoe.shard_moe_params(tree, _mesh(shape), "expert"), shape)
