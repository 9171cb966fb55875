"""ROADMAP item 5c on gloo CPU ranks: the port's pipelined TransformerLM
(``training/pp_lm.py``) against the JAX package.

One 4-rank world for the module (``sharded_ranks.battery_pp_lm``); the
pytest process compiles the JAX oracles while the ranks run.  Each case is
one SGD step at lr 1 from the seed's init (the reference tests' way of
reading gradients: the parameters after it are init - grad), built from a
port ``TransformerLM`` of that seed on every rank; the oracle is JAX
``value_and_grad`` of ``model.apply`` on the whole microbatched batch
(``attn_impl="full"``), on the port's init converted with
``torch_to_flax``.  The ranks' parameters go back to one flax tree through
``convert.pipeline_to_flax`` (``merge_lm_params``).  Limits are the
reference tests': loss 2e-6 relative and parameters 3e-5
(``test_pp_lm.py:72-89``); pp x tp 1e-5 / 1e-4 (``test_pp_lm_tp.py``);
pp x sp 1e-5 / 2e-4 (``test_pp_lm_sp.py:88-96``); MoE, pp x ep and dp x pp
2e-6 / 5e-5 (``test_pp_lm_moe.py``, ``test_pp_ep.py``,
``test_pp_lm_sp.py:194``).

* stage 4: GPipe (with and without ``remat_stage``; learned and rope
  positions), 1F1B (learned, rope), interleaved (8 layers, V 2), GPipe
  and 1F1B on the MoE LM (``moe_aux_coef`` 0.5 against the per-microbatch
  regularized oracle, ``test_pp_lm_moe.py``);
* stage 2 x model 2 (MHA GPipe, GQA 1F1B, MHA interleaved), stage 2 x seq
  2 (ring GPipe, ring-flash 1F1B with rope, Ulysses interleaved), stage 2
  x expert 2 (1F1B, interleaved), data 2 x stage 2 (1F1B, GPipe, MoE
  interleaved);
* the layouts: ``split_lm_params`` / ``merge_lm_params`` /
  ``stage_layout`` / ``interleaved_stage_layout`` equal to the JAX
  package's bit for bit, and ``convert.flax_stage_block`` of the JAX
  layout equal to each rank's init bit for bit (seed s of the pipeline is
  the one-process model of seed s);
* the refusals the reference raises (dropout, layers that do not divide
  into S or S x V, a missing seq axis, ``tp_axis`` with MoE, a missing
  axis, heads that do not divide, ``expert_axis`` without MoE, a wrong
  microbatch count), and a model not built on the step's tp axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from distributed_learning_tpu.models.moe import apply_collecting_moe_aux
from distributed_learning_tpu.models.transformer import TransformerLM as JaxLM
from distributed_learning_tpu.training import pp_lm as jpp_lm
from distributed_learning_tpu_torch.convert import flax_stage_block, pipeline_to_flax, torch_to_flax
from distributed_learning_tpu_torch.parallel.multihost import MeshPosition
from distributed_learning_tpu_torch.training import pp_lm
from sharded_ranks import (
    PP_COEF,
    PP_CONFIGS,
    PP_LM,
    PP_LM_CASES,
    PP_LM_M,
    PP_LM_MB,
    PP_LM_T,
    PP_V,
    Ranks,
    one_intra_op_thread,
    pp_lm_model,
)

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

CASES = {c[0]: c for c in PP_LM_CASES}


def _limits(name):
    shape, config = CASES[name][1], CASES[name][2]
    if "model" in shape:
        return 1e-5, 1e-4
    if "seq" in shape:
        return 1e-5, 2e-4
    if config == "moe" or "data" in shape:
        return 2e-6, 5e-5
    return 2e-6, 3e-5


def _tokens():
    rng = np.random.default_rng(0)
    tok = rng.integers(0, PP_LM["vocab_size"], (PP_LM_M, PP_LM_MB, PP_LM_T)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=-1)


def _init(config):
    """The port model of ``config`` (its seed) and its init as a flax tree."""
    m = pp_lm_model(config)
    return m, torch_to_flax({k: v[0].detach().numpy() for k, v in m.stacked_parameters().items()})


def _jax_model(config):
    kw = {k: v for k, v in PP_CONFIGS[config].items() if k != "seed"}
    return JaxLM(**PP_LM, **kw)


def _oracle(config, tree, tok, y):
    """``(loss, params - grads)`` of the JAX model on the whole batch (MoE:
    the per-microbatch regularized objective, ``test_pp_lm_moe.py``)."""
    model = _jax_model(config)
    tok, y = jnp.asarray(tok), jnp.asarray(y)

    def loss_fn(p):
        if config == "moe":
            def one(t, yy):
                logits, aux = apply_collecting_moe_aux(model, p, t)
                return optax.softmax_cross_entropy_with_integer_labels(logits, yy).mean() \
                    + PP_COEF * aux

            return jnp.mean(jax.vmap(one)(tok, y))
        logits = model.apply({"params": p}, tok.reshape(-1, tok.shape[-1]))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y.reshape(-1, y.shape[-1])).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(tree)
    return float(loss), jax.tree.map(lambda p, g: np.asarray(p - g), tree, grads)


@pytest.fixture(scope="module")
def world():
    tok, y = _tokens()
    ranks = Ranks("pp_lm", 4, {"tok": tok, "y": y})
    inits = {c: _init(c) for c in PP_CONFIGS}
    oracles = {c: _oracle(c, inits[c][1], tok, y) for c in PP_CONFIGS}
    return inits, oracles, ranks.results()


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.mark.parametrize("name", list(CASES))
def test_pipelined_step_equals_model_apply(world, name):
    inits, oracles, res = world
    _, shape, config, *_ = CASES[name]
    loss_rtol, atol = _limits(name)
    want_loss, want = oracles[config]
    for r in res:
        np.testing.assert_allclose(r[name]["loss"], want_loss, rtol=loss_rtol, atol=0)
    got = pipeline_to_flax(inits[config][0], [r[name]["params"] for r in res], shape)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=0,
                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_stash_and_graph_counts(world):
    """1F1B keeps at most min(M, 2S-1) stage inputs, GPipe all M graphs."""
    _, _, res = world
    M = PP_LM_M
    for r in res:
        assert r["gpipe"]["stats"]["graphs_held_peak"] == M
        assert r["1f1b"]["stats"]["stash_depth"] == min(M, 2 * 4 - 1)
        assert r["1f1b"]["stats"]["stash_peak"] <= min(M, 2 * 4 - 1)


@pytest.mark.parametrize("name, n_chunks, layout", [("gpipe", None, None),
                                                     ("1f1b_tp_gqa", None, "tp"),
                                                     ("inter", PP_V, None)])
def test_jax_stage_layout_converts_to_each_ranks_init(world, name, n_chunks, layout):
    inits, _, res = world
    _, shape, config, *_ = CASES[name]
    model, tree = inits[config]
    jmodel = _jax_model(config)
    outer, stacked = jpp_lm.split_lm_params(jmodel, tree)
    S = shape["stage"]
    stages = (jpp_lm.interleaved_stage_layout(stacked, S, n_chunks) if n_chunks
              else jpp_lm.stage_layout(stacked, S))
    stages = jax.tree.map(np.asarray, stages)
    for rank, r in enumerate(res):
        pos = MeshPosition.of_rank(shape, rank)
        want = flax_stage_block(model, outer, stages, pos, n_chunks=n_chunks, layout=layout)
        got = r[name]["init"]
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v.reshape(want[k].shape), want[k], err_msg=k)
        layers = sorted({int(k.split(".")[1]) for k in got if k.startswith("blocks.")})
        assert layers == sorted(i for chunk in r[name]["layers"] for i in chunk)


def test_layouts_equal_the_reference_bit_for_bit(world):
    inits, _, _ = world
    model, tree = inits["deep"]
    jmodel = _jax_model("deep")
    outer, stacked = pp_lm.split_lm_params(model, tree)
    j_outer, j_stacked = jpp_lm.split_lm_params(jmodel, tree)
    pairs = [(stacked, j_stacked), (outer, j_outer),
             (pp_lm.stage_layout(stacked, 4), jpp_lm.stage_layout(j_stacked, 4)),
             (pp_lm.interleaved_stage_layout(stacked, 4, 2),
              jpp_lm.interleaved_stage_layout(j_stacked, 4, 2))]
    for a, b in pairs:
        assert len(_leaves(a)) == len(_leaves(b))
        for (pa, la), (pb, lb) in zip(_leaves(a), _leaves(b)):
            assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    for back in (pp_lm.merge_lm_params(model, outer, stacked),
                 pp_lm.merge_lm_params(model, outer, pp_lm.stage_layout(stacked, 4), n_stages=4),
                 pp_lm.merge_lm_params(model, outer, pp_lm.interleaved_stage_layout(stacked, 4, 2),
                                       n_stages=4, n_chunks=2)):
        for (pa, la), (pb, lb) in zip(_leaves(back), _leaves(tree)):
            assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
            np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


@pytest.mark.parametrize("name, axis, n_chunks", [("1f1b_tp_gqa", "tp", None),
                                                  ("inter_tp", "tp", PP_V),
                                                  ("1f1b_ep", "ep", None)])
def test_param_specs_equal_the_reference(world, name, axis, n_chunks):
    """``_LMParts.build_param_specs`` leaf for leaf against the JAX
    package's on a (stage 2, model | expert 2) mesh; the MLP's up bias
    stays whole in the port (each rank reads its columns' slice), where
    the reference splits it."""
    from jax.sharding import Mesh

    _, shape, config, *_ = CASES[name]
    other = "model" if axis == "tp" else "expert"
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("stage", other))
    kw = {"tp_axis": "model"} if axis == "tp" else {"expert_axis": "expert"}
    want = jpp_lm._LMParts(mesh, _jax_model(config), "stage", **kw).build_param_specs(
        n_chunks=n_chunks)
    spec = lambda x: isinstance(x, tuple)  # noqa: E731  (both specs are tuples)
    want = jax.tree_util.tree_leaves_with_path(want, is_leaf=spec)
    lead = 2 if n_chunks is None else 3
    for r in world[2]:
        got = jax.tree_util.tree_leaves_with_path(r[name]["specs"], is_leaf=spec)
        assert len(got) == len(want) > 0
        for (pa, a), (pb, b) in zip(got, want):
            key = jax.tree_util.keystr(pb)
            assert jax.tree_util.keystr(pa) == key
            if axis == "tp" and key.endswith("['Dense_0']['bias']"):
                assert tuple(a) == ("stage",) + (None,) * lead, (key, a)
                continue
            assert tuple(a) == tuple(b) + (None,) * (len(a) - len(b)), (key, a, b)


REFUSALS = {"dropout": "dropout", "layers": "divide", "layers_chunks": "divide",
            "seq_axis": "seq", "tp_moe": "moe", "tp_mesh": "mesh", "tp_heads": "divisible",
            "tp_mqa": "divisible", "tp_unbuilt": "built with", "ep_dense": "moe",
            "ep_mesh": "mesh", "microbatches": "microbatches"}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_builders_refuse_what_the_reference_refuses(world, case):
    _, _, res = world
    for r in res:
        msg = r["refused"][case]
        assert msg and REFUSALS[case] in msg, (case, msg)
