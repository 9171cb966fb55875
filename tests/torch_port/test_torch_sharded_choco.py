"""``ChocoGossipEngine(mesh=)``: CHOCO-GOSSIP with one agent a gloo rank
on the CPU (4 ranks on a ring, spawned once for the module) against the
JAX package's ``mesh=`` engine on ``make_agent_mesh(4)`` and the port's
dense engine.

* top-k, per-leaf and global budgets, error feedback, and the per-leaf
  oracle (``fused=False``): ``CHOCO_ROUNDS`` rounds from the same
  stacked state, every field (``x``, ``xhat``, ``ef``) and the residual
  trace within 2e-6 (the mixing tolerance) of both; the compressed
  values of a rank's row equal the dense route's row bit for bit.
* random-k, whose bits cannot follow ``jax.random``: each rank draws the
  dense route's whole key block and keeps its row, so agent i's kept set
  on a mesh equals agent i's on the dense route, and the runs agree
  within 2e-6.
* ``consensus.compressed_bytes`` counts this rank's bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel import compression as jc
from distributed_learning_tpu.parallel.consensus import make_agent_mesh
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel import compression as tc
from sharded_ranks import CHOCO, CHOCO_ROUNDS, Ranks, _matrix

N = 4
TOL = 2e-6


def _x0(seed=7):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(N, 6, 5)).astype(np.float32),
            "b": rng.normal(size=(N, 9)).astype(np.float32),
            "c": rng.normal(size=(N, 3, 2)).astype(np.float32)}


@pytest.fixture(scope="module")
def world():
    x0 = _x0()
    # The ranks run while the first test compiles the JAX side.
    return x0, Ranks("choco", N, {f"x_{k}": v for k, v in x0.items()})


def _rows(res, key):
    return {k: np.concatenate([r[key][k] for r in res]) for k in res[0][key]}


def _kw(name):
    cfg = dict(CHOCO[name])
    spec = cfg.pop("spec")
    return spec, dict(gamma=cfg.pop("gamma", 0.2), **cfg)


def _check_run(res, name, state, trace, what):
    fields = ("x", "xhat") + (("ef",) if CHOCO[name].get("error_feedback") else ())
    for field in fields:
        got, want = _rows(res, f"{name}_{field}"), getattr(state, field)
        for k in got:
            w = np.asarray(want[k] if not isinstance(want[k], torch.Tensor) else want[k].numpy())
            np.testing.assert_allclose(got[k], w, atol=TOL, rtol=0,
                                       err_msg=f"{name} {what} {field}.{k}")
    for r in res:  # the trace is read across the ranks: the same on each
        np.testing.assert_allclose(r[f"{name}_trace"], np.asarray(trace), atol=TOL, rtol=0)


def _dense(name, x0):
    spec, kw = _kw(name)
    eng = tc.ChocoGossipEngine(_matrix("ring"), tc.compressor_from_spec(spec), device="cpu",
                               **kw)
    return eng, eng.run(eng.init({k: torch.tensor(v) for k, v in x0.items()}, seed=3),
                        CHOCO_ROUNDS)


@pytest.mark.parametrize("name", [n for n in CHOCO if n.startswith("topk")])
def test_top_k_runs_equal_the_jax_mesh_engine_and_the_dense_engine(world, name):
    x0, ranks = world
    spec, kw = _kw(name)
    ref = jc.ChocoGossipEngine(_matrix("ring"), jc.compressor_from_spec(spec),
                               mesh=make_agent_mesh(N), **kw)
    sj, tj = ref.run(ref.init({k: jnp.asarray(v) for k, v in x0.items()}, seed=3), CHOCO_ROUNDS)
    res = ranks.results()
    _check_run(res, name, sj, tj, "jax mesh")
    _, (sd, td) = _dense(name, x0)
    _check_run(res, name, sd, td, "dense")
    for r in res:
        assert r[f"{name}_maxdev"] == pytest.approx(float(tj[-1]), abs=TOL)


@pytest.mark.parametrize("name", [n for n in CHOCO if n.startswith("randk")])
def test_random_k_runs_equal_the_dense_engine(world, name):
    x0, res = world[0], world[1].results()
    _, (sd, td) = _dense(name, x0)
    _check_run(res, name, sd, td, "dense")


@pytest.mark.parametrize("budget", ["per-leaf", "global"])
def test_kept_sets_and_compressed_values_equal_the_dense_route(world, budget):
    x0, res = world[0], world[1].results()
    buffers, layout = ops.flatten_stacked({k: torch.tensor(v) + 10.0 for k, v in x0.items()})
    fc = tc.FusedCompressor(tc.random_k(0.4), budget=budget)
    dense = fc.compress(buffers, layout, torch.Generator().manual_seed(5), n=N)["float32"]
    topk = tc.FusedCompressor(tc.top_k(0.3), budget=budget).compress(
        buffers, layout, None, n=N)["float32"]
    for a, r in enumerate(res):
        np.testing.assert_array_equal(r[f"kept_{budget}"][0], (dense[a] != 0).numpy())
        np.testing.assert_array_equal(r[f"topk_{budget}"][0], topk[a].numpy())
    # The agents' kept sets differ (a rank does not keep row 0's draws).
    assert not np.array_equal(res[0][f"kept_{budget}"], res[1][f"kept_{budget}"])


def test_compressed_bytes_count_this_ranks_bytes(world):
    x0, res = world[0], world[1].results()
    layout = ops.fused_layout({k: torch.tensor(v) for k, v in x0.items()})
    for name in CHOCO:
        spec, kw = _kw(name)
        fc = tc.FusedCompressor(tc.compressor_from_spec(spec), budget=kw.get("budget", "per-leaf"))
        want = fc.wire_bytes_per_round(layout, 1) * CHOCO_ROUNDS
        for r in res:
            assert r[f"{name}_bytes"] == want, name
