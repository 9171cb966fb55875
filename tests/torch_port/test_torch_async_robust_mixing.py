"""The async (stale-weighted) and Byzantine-robust mixing primitives of the
port (``distributed_learning_tpu_torch/ops/mixing.py``) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through both.  Limits: effective
matrices and radii within 1e-7, bitwise ``W`` at the neutral knobs;
mixed states within 2e-6 (``tests/test_consensus.py``'s limit) for
float32 keys and within one bfloat16 rounding step (2**-7 relative) for
a bf16 key (a 1e-7 difference before the cast can round to the
neighbouring bf16 value); redirected masses within 1e-6 relative.  The cases cover NaN
distances, inf / negative / per-receiver radii, an isolated agent, even
and odd degrees (``jnp.nanmedian`` averages the two middle values, which
``torch.nanmedian`` does not), duplicated values under trimming with
unequal weights (the index tie-break decides which neighbour is cut),
and a bf16 bucket beside float32.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.ops import mixing as jm
from distributed_learning_tpu_torch.ops import mixing as tm
from distributed_learning_tpu_torch.parallel import Topology

N = 5


def _graphs():
    """Mixing matrices: a ring (every degree 2), the complete graph
    (degree 4), Metropolis weights of an irregular graph (degrees 1-4, so
    unequal weights), and the same with agent 4 isolated."""
    irregular = Topology.from_edges([(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3)])
    W_iso = irregular.metropolis_weights().copy()
    W_iso[4, :] = 0.0
    W_iso[:, 4] = 0.0
    W_iso[4, 4] = 1.0
    W_iso[0, 0] += 1.0 - W_iso[0].sum()
    return {
        "ring": Topology.ring(N).metropolis_weights(),
        "complete": Topology.complete(N).metropolis_weights(),
        "irregular": irregular.metropolis_weights(),
        "isolated": W_iso,
    }


GRAPHS = {k: v.astype(np.float32) for k, v in _graphs().items()}


def _state(seed=0, ties=False, n=N):
    """A mixed-dtype stacked dict: two float32 keys and a bf16 key; with
    ``ties`` the values lie on a coarse grid, so many coordinates hold
    equal values across agents."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        v = rng.normal(size=(n,) + shape).astype(np.float32)
        return np.round(v * 2) / 2 if ties else v

    return {"w": draw(3, 4), "b": draw(7), "h": draw(6).astype(jnp.bfloat16)}


def _t(x):
    return {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32) for k, v in x.items()}


def _j(x):
    return {k: jnp.asarray(v) for k, v in x.items()}


def _out(x):
    return {k: torch.empty_like(v) for k, v in x.items()}


def _assert_states_close(got, want):
    for k, w in want.items():
        g, w = got[k].to(torch.float32).numpy(), np.asarray(w, np.float32)
        if got[k].dtype == torch.bfloat16:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-6, err_msg=k)


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# -- stale weights and presence ------------------------------------------ #
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("tau", [0, 1, 3])
def test_stale_weight_matrix_matches_jax(graph, tau):
    W = GRAPHS[graph]
    age = np.array([0, 1, 2, 3, 5], np.int32)
    want = np.asarray(jm.stale_weight_matrix(W, age, tau=tau))
    for t in (tau, torch.tensor(tau, dtype=torch.int32)):  # int, or a device tensor
        got = tm.stale_weight_matrix(torch.tensor(W), torch.tensor(age), tau=t).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
        np.testing.assert_allclose(got.sum(1), W.sum(1), atol=1e-6)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_neutral_weights_are_bitwise_W(graph):
    W = torch.tensor(GRAPHS[graph])
    zero = torch.zeros(N, dtype=torch.int32)
    assert torch.equal(tm.stale_weight_matrix(W, zero, tau=0), W)
    assert torch.equal(tm.presence_weight_matrix(W, torch.ones(N)), W)
    sq = torch.tensor(np.random.default_rng(1).uniform(0, 9, size=(N, N)).astype(np.float32))
    W_eff, mass = tm.clip_weight_matrix(W, sq, math.inf)
    assert torch.equal(W_eff, W) and float(mass) == 0.0


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_presence_weight_matrix_matches_jax(graph):
    W = GRAPHS[graph]
    present = np.array([1, 0, 1, 1, 0], np.float32)
    want = np.asarray(jm.presence_weight_matrix(W, present))
    got = tm.presence_weight_matrix(torch.tensor(W), torch.tensor(present)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("graph", ["ring", "irregular"])
def test_stale_weighted_mix_matches_jax(graph):
    W = np.asarray(jm.stale_weight_matrix(GRAPHS[graph], np.array([0, 2, 1, 0, 3], np.int32),
                                          tau=2))
    x, pub = _state(0), _state(1)
    want = jm.stale_weighted_mix(_j(x), _j(pub), W)
    got = tm.stale_weighted_mix(_t(x), _t(pub), torch.tensor(W), _out(_t(x)))
    _assert_states_close(got, want)


def test_stale_weighted_mix_is_dense_mix_when_pub_holds_x():
    W = torch.tensor(GRAPHS["irregular"])
    x = _t(_state(2))
    got = tm.stale_weighted_mix(x, {k: v.clone() for k, v in x.items()}, W, _out(x))
    _assert_bitwise(got, tm.dense_mix(x, W, _out(x)))


# -- distances and clipping ----------------------------------------------- #
@pytest.mark.parametrize("published", [False, True])
def test_pairwise_sq_dists_matches_jax(published):
    x, pub = _state(3), _state(4)
    want = np.asarray(jm.pairwise_sq_dists(_j(x), _j(pub) if published else None))
    got = tm.pairwise_sq_dists(_t(x), _t(pub) if published else None).numpy()
    # The Gram form's float32 cancellation (sx + sy ~ 2e1) bounds the gap.
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert (got >= 0).all()


def _sq(seed=5, nan=True):
    rng = np.random.default_rng(seed)
    sq = rng.uniform(0.0, 9.0, size=(N, N)).astype(np.float32)
    sq = (sq + sq.T) / 2
    np.fill_diagonal(sq, 0.0)
    if nan:
        sq[0, 2] = sq[2, 0] = np.nan  # a poisoned payload
    return sq


RADII = {
    "scalar": 1.5,
    "inf": math.inf,
    "negative": -1.0,
    "nan": math.nan,
    "zero": 0.0,
    "per_receiver": np.array([0.5, math.inf, 2.0, -1.0, 1.0], np.float32),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("radius", sorted(RADII))
def test_clip_weight_matrix_matches_jax(graph, radius):
    W, sq, r = GRAPHS[graph], _sq(), RADII[radius]
    want, want_mass = jm.clip_weight_matrix(W, sq, r)
    r_t = torch.tensor(r) if isinstance(r, np.ndarray) else r
    got, mass = tm.clip_weight_matrix(torch.tensor(W), torch.tensor(sq), r_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    assert float(mass) == pytest.approx(float(want_mass), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("multiplier", [0.5, 2.0, math.inf])
def test_adaptive_clip_radius_matches_jax(graph, nan, multiplier):
    W, sq = GRAPHS[graph], _sq(nan=nan)
    want = np.asarray(jm.adaptive_clip_radius(W, sq, multiplier))
    got = tm.adaptive_clip_radius(torch.tensor(W), torch.tensor(sq), multiplier).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if graph == "isolated" and not math.isinf(multiplier):
        assert got[4] == 0.0


def test_adaptive_radius_averages_the_middle_pair():
    """The nanmedian trap: on a ring every agent has 2 neighbours, whose
    median is their mean (``jnp.nanmedian``), not the lower one
    (``torch.nanmedian``), which would halve the radius here."""
    W = torch.tensor(GRAPHS["ring"])
    sq = torch.zeros(N, N)
    for i in range(N):
        sq[i, (i + 1) % N] = sq[(i + 1) % N, i] = 1.0
        sq[i, (i - 1) % N] = sq[(i - 1) % N, i] = 1.0
    sq[0, 1] = sq[1, 0] = 9.0
    r = tm.adaptive_clip_radius(W, sq, 1.0)
    assert float(r[0]) == 2.0  # (3 + 1) / 2
    assert float(W.new_tensor([3.0, 1.0]).nanmedian()) == 1.0


@pytest.mark.parametrize("graph", ["ring", "irregular", "isolated"])
@pytest.mark.parametrize("adaptive,radius", [(False, 1.0), (True, 0.8), (False, math.inf)])
@pytest.mark.parametrize("published", [False, True])
def test_clipped_mix_matches_jax(graph, adaptive, radius, published):
    W = GRAPHS[graph]
    x, pub = _state(6), _state(7)
    want, want_mass = jm.clipped_mix(_j(x), W, radius, adaptive=adaptive,
                                     published=_j(pub) if published else None)
    got, mass = tm.clipped_mix(_t(x), torch.tensor(W), radius, _out(_t(x)), adaptive=adaptive,
                               published=_t(pub) if published else None)
    _assert_states_close(got, want)
    assert float(mass) == pytest.approx(float(want_mass), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("published", [False, True])
def test_clipped_mix_at_inf_is_bitwise_the_plain_round(published):
    W = torch.tensor(GRAPHS["irregular"])
    x, pub = _t(_state(8)), _t(_state(9))
    for adaptive in (False, True):
        got, mass = tm.clipped_mix(x, W, math.inf, _out(x), adaptive=adaptive,
                                   published=pub if published else None)
        plain = (tm.stale_weighted_mix(x, pub, W, _out(x)) if published
                 else tm.dense_mix(x, W, _out(x)))
        _assert_bitwise(got, plain)
        assert float(mass) == 0.0


# -- trimming ------------------------------------------------------------- #
@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("trim", [0, 1, 2, "median"])
def test_trim_counts_match_jax(graph, trim):
    W = GRAPHS[graph]
    want = np.asarray(jm.trim_counts(W, trim))
    got = tm.trim_counts(torch.tensor(W), trim)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_trim_counts_rejects_what_jax_rejects():
    for mod, W in ((jm, GRAPHS["ring"]), (tm, torch.tensor(GRAPHS["ring"]))):
        with pytest.raises(ValueError, match="trim must be an int or 'median', got 'mean'"):
            mod.trim_counts(W, "mean")


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("trim", [0, 1, "median"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("published", [False, True])
def test_trimmed_mix_matches_jax(graph, trim, ties, published):
    W = GRAPHS[graph]
    x, pub = _state(10, ties), _state(11, ties)
    t = jm.trim_counts(W, trim)
    want, want_mass = jm.trimmed_mix(_j(x), W, t, published=_j(pub) if published else None)
    got, mass = tm.trimmed_mix(_t(x), torch.tensor(W), tm.trim_counts(torch.tensor(W), trim),
                               _out(_t(x)), published=_t(pub) if published else None)
    _assert_states_close(got, want)
    assert float(mass) == pytest.approx(float(want_mass), rel=1e-6, abs=1e-7)


def test_trim_tie_break_decides_which_neighbour_is_cut():
    """Receiver 2's neighbours 0 and 1 hold the same value at every
    coordinate and weigh 1/5 and 1/4 (irregular Metropolis weights): the
    index tie-break ranks neighbour 0 lowest, so trim 1 cuts it (and the
    highest, neighbour 3), as the reference does.  A flipped tie axis
    would cut neighbour 1 and move 1/4 instead of 1/5."""
    W = GRAPHS["irregular"]
    assert W[2, 0] != W[2, 1]
    x = {"w": np.zeros((N, 8), np.float32)}
    x["w"][2], x["w"][3] = 1.0, 3.0
    t = jm.trim_counts(W, 1)
    want, want_mass = jm.trimmed_mix(_j(x), W, t)
    got, mass = tm.trimmed_mix(_t(x), torch.tensor(W), tm.trim_counts(torch.tensor(W), 1),
                               _out(_t(x)))
    _assert_states_close(got, want)
    assert float(mass) == pytest.approx(float(want_mass), rel=1e-6)
    # Receiver 2 keeps its own value with its weight and those of the cut
    # neighbours 0 and 3; neighbour 1 contributes its 0.
    np.testing.assert_allclose(got["w"][2].numpy(), W[2, 2] + W[2, 0] + W[2, 3], atol=1e-7)


@pytest.mark.parametrize("published", [False, True])
def test_trimmed_mix_at_zero_is_bitwise_the_plain_round(published):
    W = torch.tensor(GRAPHS["complete"])
    x, pub = _t(_state(12, ties=True)), _t(_state(13, ties=True))
    got, mass = tm.trimmed_mix(x, W, tm.trim_counts(W, 0), _out(x),
                               published=pub if published else None)
    plain = tm.stale_weighted_mix(x, pub, W, _out(x)) if published else tm.dense_mix(x, W, _out(x))
    _assert_bitwise(got, plain)
    assert float(mass) == 0.0


def test_trimmed_mix_does_not_depend_on_the_chunking(monkeypatch):
    W = torch.tensor(GRAPHS["irregular"])
    x, pub = _t(_state(14, ties=True)), _t(_state(15, ties=True))
    t = tm.trim_counts(W, 1)
    whole, mass = tm.trimmed_mix(x, W, t, _out(x), published=pub)
    monkeypatch.setattr(tm, "_TRIM_CHUNK_ENTRIES", 3 * N * N)  # 3 coordinates a chunk
    chunked, mass_c = tm.trimmed_mix(x, W, t, _out(x), published=pub)
    _assert_bitwise(whole, chunked)
    assert float(mass) == float(mass_c)
