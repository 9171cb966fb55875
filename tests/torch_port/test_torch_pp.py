"""ROADMAP item 5b on gloo CPU ranks: the port's generic pipeline executors
(``training/pp.py``, ``training/pp_interleaved.py``) against the JAX
package.

One 4-rank world for the module (``sharded_ranks.battery_pp``); the pytest
process computes the JAX side while the ranks run.  The stage is the
reference tests' tanh stack (``tests/test_pp.py:13-41``), the limits
theirs: loss 1e-6 absolute, gradients 2e-5 (``test_pp.py:118-121``).

* GPipe (``make_pipeline_apply``) on stage 4, with and without
  ``remat_stage``: outputs and the gradients of ``sum(out * co)`` in the
  parameters and the microbatches against the JAX unsharded stack;
* 1F1B with M 3 (< S) and M 12 (> 2S - 1, the stash's slots reused):
  loss and gradients against ``jax.value_and_grad`` of the unsharded
  mean loss; the stash holds at most ``min(M, 2S - 1)`` inputs (all of
  them at stage 0) while GPipe holds all M graphs on every stage;
* interleaved on stage 4 (V 2, M 6) and on data 2 x stage 2 (V 2, M 4):
  against the virtual stages applied in order;
* ``build_schedule``'s tables equal to the JAX function's on the grid of
  ``test_pp_interleaved.py:77`` (no process group);
* controls that must fail: every stage seeding its backward from the
  loss; each input filed one stash slot off;
* refusals: a wrong microbatch count, a sharded chunk dim, a spec without
  the stage axis, neither or both of ``loss_fn`` / ``head_fn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_learning_tpu.training import pp_interleaved as jppi
from distributed_learning_tpu_torch.parallel.multihost import MeshPosition, PartitionSpec as P
from distributed_learning_tpu_torch.training import pp, pp_interleaved as ppi
from sharded_ranks import PP_D, PP_L, PP_MB, PP_S, PP_V, PP_VD, Ranks, one_intra_op_thread

one_thread = pytest.fixture(scope="module", autouse=True)(one_intra_op_thread)

LOSS_ATOL, GRAD_ATOL = 1e-6, 2e-5
SCHEDULES = [(1, 1, 3), (2, 2, 4), (4, 2, 6), (4, 4, 8), (8, 2, 8)]


def _inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    d = {"W": (rng.normal(size=(PP_S, PP_L, PP_D, PP_D)) / np.sqrt(PP_D)).astype(f32),
         "b": (rng.normal(size=(PP_S, PP_L, PP_D)) * 0.1).astype(f32),
         "x": rng.normal(size=(4, PP_MB, PP_D)).astype(f32),
         "co": rng.normal(size=(4, PP_MB, PP_D)).astype(f32)}
    for m in (3, 12):
        d[f"x{m}"] = rng.normal(size=(m, PP_MB, PP_D)).astype(f32)
        d[f"y{m}"] = rng.normal(size=(m, PP_MB, PP_D)).astype(f32)
    for tag, S in (("c", PP_S), ("d", 2)):
        d[f"{tag}W"] = (rng.normal(size=(S, PP_V, PP_VD, PP_VD)) / np.sqrt(PP_VD)).astype(f32)
        d[f"{tag}b"] = (rng.normal(size=(S, PP_V, PP_VD)) * 0.1).astype(f32)
    for m in (4, 6):
        d[f"cx{m}"] = rng.normal(size=(m, PP_MB, PP_VD)).astype(f32)
        d[f"cy{m}"] = rng.normal(size=(m, PP_MB, PP_VD)).astype(f32)
    return d


def _stack(params, x):
    a = x
    for s in range(params["W"].shape[0]):
        for layer in range(params["W"].shape[1]):
            a = jnp.tanh(a @ params["W"][s, layer] + params["b"][s, layer])
    return a


def _mse(out, y):
    return jnp.mean((out - y) ** 2)


def _stack_loss(params, x, y):
    return jnp.mean(jax.vmap(lambda a, b: _mse(_stack(params, a), b))(x, y))


def _chunks_loss(params, x, y):
    """The S*V virtual stages in order (chunk c of stage d is c*S + d)."""
    S, V = params["W"].shape[:2]

    def one(a, b):
        for v in range(S * V):
            c, d = v // S, v % S
            a = jnp.tanh(a @ params["W"][d, c] + params["b"][d, c])
        return _mse(a, b)

    return jnp.mean(jax.vmap(one)(x, y))


def _jax_side(d):
    out = {}
    params = {"W": jnp.asarray(d["W"]), "b": jnp.asarray(d["b"])}
    x, co = jnp.asarray(d["x"]), jnp.asarray(d["co"])
    out["gpipe_out"] = np.asarray(jax.vmap(lambda a: _stack(params, a))(x))
    out["gpipe_grads"] = jax.grad(
        lambda p, xx: jnp.sum(jax.vmap(lambda a: _stack(p, a))(xx) * co), argnums=(0, 1))(params, x)
    for m in (3, 12):
        out[f"1f1b_{m}"] = jax.value_and_grad(_stack_loss)(params, jnp.asarray(d[f"x{m}"]),
                                                           jnp.asarray(d[f"y{m}"]))
    for tag, m in (("c", 6), ("d", 4)):
        cp = {"W": jnp.asarray(d[f"{tag}W"]), "b": jnp.asarray(d[f"{tag}b"])}
        out[f"inter_{tag}"] = jax.value_and_grad(_chunks_loss)(cp, jnp.asarray(d[f"cx{m}"]),
                                                               jnp.asarray(d[f"cy{m}"]))
    return out


@pytest.fixture(scope="module")
def world():
    d = _inputs()
    ranks = Ranks("pp", 4, d)
    return d, _jax_side(d), ranks.results()


def _by_stage(res, case, key, n=PP_S):
    """The stage blocks of gradient ``key``, in stage order (data 0)."""
    blocks = {}
    for r in res:
        c = r[case].get("coords", r["coords"])
        if c.get("data", 0) == 0:
            blocks[c["stage"]] = r[case][key]
    return np.concatenate([blocks[s] for s in range(n)])


@pytest.mark.parametrize("remat", [False, True])
def test_gpipe_apply_and_gradients_match_the_unsharded_stack(world, remat):
    _, jx, res = world
    g_params, g_x = jx["gpipe_grads"]
    for r in res:
        got = r[f"gpipe_{remat}"]
        np.testing.assert_allclose(got["out"], jx["gpipe_out"], atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(got["dx"], np.asarray(g_x), atol=GRAD_ATOL, rtol=0)
    for k in ("W", "b"):
        total = sum(r[f"gpipe_{remat}"][f"g_{k}"] for r in res)  # each rank fills its stage
        np.testing.assert_allclose(total, np.asarray(g_params[k]), atol=GRAD_ATOL, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("m", [3, 12])
def test_1f1b_loss_and_gradients_match_the_unsharded_stack(world, m):
    _, jx, res = world
    loss, grads = jx[f"1f1b_{m}"]
    for r in res:
        np.testing.assert_allclose(r[f"1f1b_{m}"]["loss"], float(loss), atol=LOSS_ATOL, rtol=0)
    for k in ("W", "b"):
        np.testing.assert_allclose(_by_stage(res, f"1f1b_{m}", f"g_{k}"), np.asarray(grads[k]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=k)


def test_1f1b_stash_holds_min_m_2s_minus_1_inputs_gpipe_holds_m_graphs(world):
    _, _, res = world
    for r in res:
        st = r["1f1b_12"]["stats"]
        assert st["stash_depth"] == min(12, 2 * PP_S - 1)
        assert st["stash_peak"] <= st["stash_depth"]
        assert r["1f1b_3"]["stats"]["stash_depth"] == 3
        assert r["gpipe_False"]["stats"]["graphs_held_peak"] == 4
    stage0 = next(r for r in res if r["coords"]["stage"] == 0)
    assert stage0["1f1b_12"]["stats"]["stash_peak"] == 2 * PP_S - 1


@pytest.mark.parametrize("case, tag", [("inter_4", "c"), ("inter_dp", "d")])
def test_interleaved_loss_and_gradients_match_the_virtual_stages(world, case, tag):
    _, jx, res = world
    loss, grads = jx[f"inter_{tag}"]
    n = 2 if case == "inter_dp" else PP_S
    for r in res:
        np.testing.assert_allclose(r[case]["loss"], float(loss), atol=LOSS_ATOL, rtol=0)
    for k in ("W", "b"):
        np.testing.assert_allclose(_by_stage(res, case, f"g_{k}", n), np.asarray(grads[k]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("control", ["head_every_stage", "slot_off"])
def test_controls_fail(world, control):
    """A head seeding every stage's backward, or an input filed one stash
    slot off, must move the gradients far past the limit."""
    _, jx, res = world
    _, grads = jx["1f1b_12"]
    err = max(float(np.abs(_by_stage(res, f"control_{control}", f"g_{k}")
                           - np.asarray(grads[k])).max()) for k in ("W", "b"))
    assert err > 100 * GRAD_ATOL, err


def test_interleaved_refuses_a_wrong_microbatch_count(world):
    _, _, res = world
    for r in res:
        assert "built for 6 microbatches, got 4" in r["refused_microbatch_count"]


@pytest.mark.parametrize("S, V, M", SCHEDULES)
def test_build_schedule_equals_the_reference(S, V, M):
    got, want = ppi.build_schedule(S, V, M), jppi.build_schedule(S, V, M)
    assert (got.slots, got.ticks) == (want.slots, want.ticks)
    for field in ("op", "chunk", "mb", "recv_f_valid", "recv_f_chunk", "recv_f_slot",
                  "recv_b_valid", "recv_b_chunk", "recv_b_slot"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def test_builders_refuse_bad_specs_and_heads():
    pos = MeshPosition({"stage": 2, "model": 2}, {"stage": 0, "model": 0})
    with pytest.raises(ValueError, match="chunk dim"):
        ppi.make_interleaved_1f1b_train_step(pos, pp.head_seed, pp.head_seed, n_chunks=2,
                                             n_microbatches=4,
                                             param_specs={"w1": P("stage", "model", None)})
    with pytest.raises(ValueError, match="leading"):
        pp.make_1f1b_train_step(pos, pp.head_seed, pp.head_seed,
                                param_specs={"w1": P("model", None)})
    with pytest.raises(ValueError, match="exactly one"):
        pp.make_1f1b_train_step(pos, pp.head_seed)
    with pytest.raises(ValueError, match="exactly one"):
        ppi.make_interleaved_1f1b_train_step(pos, pp.head_seed, pp.head_seed, n_chunks=1,
                                             n_microbatches=2, head_fn=pp.head_seed)
