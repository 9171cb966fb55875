"""The port's async and robust gossip routes on the ``ConsensusEngine``
(``parallel/consensus.py``, ``parallel/robust.py``) against the JAX
package's engine, on the CPU.

* ``mix_async`` / ``mix_async_robust`` / ``mix_robust`` over several
  calls with the carry threaded through: mixed states and ``pub`` within
  2e-6 (float32; one bf16 rounding step, 2**-7 relative, for the bf16
  key), ``age`` and ``rnd`` exactly, masses within 1e-6 relative;
* the in-place routes (``mix_async_``, ``mix_robust_``,
  ``mix_async_robust_``) equal the copy forms bit for bit, with and
  without spare buffers, and add the mass to the scalar they are given;
* the neutral knobs are bitwise the plain ``mix`` / ``mix_async``, on a
  bf16 bucket beside float32 (``tests/test_robust.py``'s oracles);
* the persistent-liar attacks of ``tests/test_robust.py``, and their
  rounds against the reference's within one float32 step at the
  poison's scale (``LIAR_ATOL``) and 2e-6 relative;
* ``as_robust_config`` accepts and rejects what the reference does.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.parallel import ConsensusEngine as JaxEngine
from distributed_learning_tpu.parallel import as_robust_config as jax_as_robust_config
from distributed_learning_tpu_torch.parallel import (
    AsyncGossipState,
    ConsensusEngine,
    RobustConfig,
    Topology,
    as_robust_config,
)

N = 4
RING = Topology.ring(N).metropolis_weights()
COMPLETE = Topology.complete(N).metropolis_weights()
PERIODS = (1, 2, 1, 3)
NEUTRAL_SPECS = [
    "clip",
    {"kind": "clip", "radius": math.inf, "adaptive": True},
    {"kind": "trim", "trim": 0},
]
SPECS = {
    "clip": {"kind": "clip", "radius": 1.0},
    "clip_adaptive": {"kind": "clip", "radius": 0.7, "adaptive": True},
    "trim": {"kind": "trim", "trim": 1},
    "median": "median",
}


def _state(n=N, seed=3):
    """The mixed-dtype state of ``tests/test_robust.py`` (f32 beside bf16)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(n, 3, 2)).astype(np.float32),
        "b": rng.normal(size=(n, 5)).astype(np.float32),
        "h": rng.normal(size=(n, 4)).astype(np.float32),
    }


def _j(x):
    return {k: jnp.asarray(v).astype(jnp.bfloat16 if k == "h" else jnp.float32)
            for k, v in x.items()}


def _t(x):
    return {k: torch.tensor(v).to(torch.bfloat16 if k == "h" else torch.float32)
            for k, v in x.items()}


def _assert_close(got, want, tag="", rtol=0.0, atol=2e-6):
    for k, w in want.items():
        g, w = got[k].to(torch.float32).numpy(), np.asarray(w, np.float32)
        if got[k].dtype == torch.bfloat16:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-6, err_msg=f"{tag} {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"{tag} {k}")


def _assert_bitwise(a, b, tag=""):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (tag, k)


def _assert_carry(st, ref, tag=""):
    np.testing.assert_array_equal(st.age.numpy(), np.asarray(ref.age), err_msg=tag)
    assert int(st.rnd) == int(ref.rnd), tag
    _assert_close(st.pub, ref.pub, f"{tag} pub")


def _engines(W):
    return JaxEngine(W), ConsensusEngine(W, device="cpu")


@pytest.mark.parametrize("tau,periods", [(0, 1), (1, PERIODS), (2, PERIODS), (0, PERIODS)])
def test_mix_async_matches_jax_with_the_carry_threaded(tau, periods):
    je, te = _engines(RING)
    xj, xt = _j(_state()), _t(_state())
    sj = st = None
    for call, times in enumerate((2, 1, 3)):
        xj, sj = je.mix_async(xj, sj, tau=tau, periods=periods, times=times)
        xt, st = te.mix_async(xt, st, tau=tau, periods=periods, times=times)
        _assert_close(xt, xj, f"call {call}")
        _assert_carry(st, sj, f"call {call}")


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_mix_robust_matches_jax(spec):
    je, te = _engines(COMPLETE if spec in ("trim", "median") else RING)
    xj, xt = _j(_state()), _t(_state())
    for call, times in enumerate((1, 3)):
        xj, mj = je.mix_robust(xj, SPECS[spec], times=times)
        xt, mt = te.mix_robust(xt, SPECS[spec], times=times)
        _assert_close(xt, xj, f"call {call}")
        assert float(mt) == pytest.approx(float(mj), rel=1e-6), call
        assert float(mt) > 0.0


@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("tau", [1, 2])
def test_mix_async_robust_matches_jax_with_the_carry_threaded(spec, tau):
    je, te = _engines(COMPLETE if spec in ("trim", "median") else RING)
    xj, xt = _j(_state()), _t(_state())
    sj = st = None
    for call, times in enumerate((2, 1, 3)):
        xj, sj, mj = je.mix_async_robust(xj, sj, spec=SPECS[spec], tau=tau, periods=PERIODS,
                                         times=times)
        xt, st, mt = te.mix_async_robust(xt, st, spec=SPECS[spec], tau=tau, periods=PERIODS,
                                         times=times)
        _assert_close(xt, xj, f"call {call}")
        _assert_carry(st, sj, f"call {call}")
        assert float(mt) == pytest.approx(float(mj), rel=1e-6, abs=1e-7), call


def _fused(x):
    from distributed_learning_tpu_torch.ops import mixing as ops

    return ops.flatten_stacked(x)


@pytest.mark.parametrize("use_spare", [False, True])
@pytest.mark.parametrize("spec", [None] + sorted(SPECS))
def test_in_place_routes_equal_the_copy_forms(spec, use_spare):
    """The in-place routes on fused buffers (what the trainer's graphs
    capture) equal the copy forms bit for bit; the mass is added to the
    scalar given, and the device tensor ``tau`` is the int ``tau``."""
    from distributed_learning_tpu_torch.ops import mixing as ops

    te = ConsensusEngine(COMPLETE, device="cpu")
    x = _t(_state())
    buffers, layout = _fused(x)
    spare = te.spare_for(buffers, 1) if use_spare else None
    st = te.init_async_state(buffers)
    tau = torch.tensor(1, dtype=torch.int32)
    ref, ref_st = x, None
    for times in (2, 3):
        if spec is None:
            te.mix_async_(buffers, st, tau, times, periods=PERIODS, spare=spare)
            ref, ref_st = te.mix_async(ref, ref_st, tau=1, periods=PERIODS, times=times)
            continue
        mass = torch.tensor(0.0)
        te.mix_async_robust_(buffers, st, SPECS[spec], tau, times, periods=PERIODS, mass=mass,
                             spare=spare)
        ref, ref_st, ref_mass = te.mix_async_robust(ref, ref_st, spec=SPECS[spec], tau=1,
                                                    periods=PERIODS, times=times)
        assert torch.equal(mass, ref_mass) and float(mass) > 0.0
    _assert_bitwise(ops.unflatten_stacked(buffers, layout), ref)
    _assert_bitwise(ops.unflatten_stacked(st.pub, layout), ref_st.pub)
    assert torch.equal(st.age, ref_st.age) and torch.equal(st.rnd, ref_st.rnd)
    if spec is not None:
        robust = te.spare_for(buffers, 1)[0]
        for k, v in buffers.items():
            robust[k].copy_(v)
        mass = torch.tensor(0.5)  # the routes add to the caller's scalar
        te.mix_robust_(robust, SPECS[spec], 2, mass=mass, spare=spare)
        got, m_copy = te.mix_robust(ops.unflatten_stacked(buffers, layout), SPECS[spec], 2)
        _assert_bitwise(ops.unflatten_stacked(robust, layout), got)
        assert float(mass) == pytest.approx(0.5 + float(m_copy), rel=1e-6)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_static_programs_equal_the_engine_routes(spec):
    """``robust_mix_program`` / ``robust_async_gossip_program`` (a fixed
    count and bound) run what the engine's in-place routes run."""
    from distributed_learning_tpu_torch.parallel import robust

    te = ConsensusEngine(COMPLETE, device="cpu")
    buffers, _ = _fused(_t(_state()))
    copies = [{k: v.clone() for k, v in buffers.items()} for _ in range(4)]
    masses = [torch.tensor(0.0) for _ in range(4)]
    robust.robust_mix_program(te, SPECS[spec], times=2)(copies[0], masses[0])
    te.mix_robust_(copies[1], SPECS[spec], 2, mass=masses[1])
    carries = [te.init_async_state(buffers) for _ in range(2)]
    robust.robust_async_gossip_program(te, SPECS[spec], tau=1, periods=PERIODS, times=2)(
        copies[2], carries[0], masses[2])
    te.mix_async_robust_(copies[3], carries[1], SPECS[spec], 1, 2, periods=PERIODS,
                         mass=masses[3])
    for a, b in ((0, 1), (2, 3)):
        _assert_bitwise(copies[a], copies[b])
        assert torch.equal(masses[a], masses[b]) and float(masses[a]) > 0.0
    assert torch.equal(carries[0].pub["float32"], carries[1].pub["float32"])
    assert torch.equal(carries[0].age, carries[1].age)


@pytest.mark.parametrize("spec", NEUTRAL_SPECS)
def test_neutral_robust_mix_bit_identical_to_mix(spec):
    te = ConsensusEngine(RING, device="cpu")
    x = _t(_state())
    ref = te.mix(x, times=3)
    got, mass = te.mix_robust(x, spec, times=3)
    _assert_bitwise(ref, got, spec)
    assert float(mass) == 0.0


@pytest.mark.parametrize("spec", NEUTRAL_SPECS)
def test_neutral_robust_async_bit_identical_to_mix_async(spec):
    te = ConsensusEngine(RING, device="cpu")
    x = _t(_state())
    ref, st_ref = te.mix_async(x, tau=2, periods=PERIODS, times=3)
    got, st_got, mass = te.mix_async_robust(x, spec=spec, tau=2, periods=PERIODS, times=3)
    _assert_bitwise(ref, got, spec)
    assert float(mass) == 0.0
    assert torch.equal(st_ref.age, st_got.age) and int(st_ref.rnd) == int(st_got.rnd)
    ref2, _ = te.mix_async(ref, st_ref, tau=2, periods=PERIODS, times=2)
    got2, _, mass2 = te.mix_async_robust(got, st_got, spec=spec, tau=2, periods=PERIODS,
                                         times=2)
    _assert_bitwise(ref2, got2, spec)
    assert float(mass2) == 0.0


def test_neutral_async_bit_identical_to_mix():
    """tau 0 with every period 1: every agent publishes each round, so
    the stale-weighted round is the plain one bit for bit."""
    te = ConsensusEngine(RING, device="cpu")
    x = _t(_state())
    got, st = te.mix_async(x, tau=0, periods=1, times=3)
    _assert_bitwise(te.mix(x, times=3), got)
    assert int(st.rnd) == 3 and not st.age.any()


def test_async_straggler_ages_and_carry():
    te = ConsensusEngine(RING, device="cpu")
    x, st, ages = _t(_state()), None, []
    for _ in range(6):
        x, st = te.mix_async(x, st, tau=1, periods=(1, 1, 1, 3), times=1)
        ages.append(int(st.age[3]))
    assert ages == [0, 1, 2, 0, 1, 2]
    assert isinstance(st, AsyncGossipState) and int(st.rnd) == 6


@pytest.mark.parametrize("periods,match", [((1, 2), "periods must have length 4, got 2"),
                                           ((1, 0, 1, 1), "publish periods must be >= 1")])
def test_bad_periods_are_rejected_as_in_jax(periods, match):
    je, te = _engines(RING)
    for eng, x in ((je, _j(_state())), (te, _t(_state()))):
        with pytest.raises(ValueError, match=match):
            eng.mix_async(x, tau=1, periods=periods)


# -- breakdown: persistent liars (tests/test_robust.py) -------------------- #
NL = 8
LIARS = (2, 5)
POISON = 1e3
# An honest agent's trimmed round adds ~W * POISON ~ 250 in the GEMM and
# takes it back in the correction, so its float32 result carries the
# rounding of numbers at the poison's scale (measured gap 1.5e-5): the
# limit is one float32 step there, 6.1e-5.
LIAR_ATOL = float(np.spacing(np.float32(POISON)))


def _poison(x):
    w = x["w"].clone()
    w[list(LIARS)] = POISON
    return {"w": w}


def _honest_spread(x, ref):
    honest = np.array([i for i in range(NL) if i not in LIARS])
    return float(np.abs(x["w"].double().numpy()[honest] - ref).max())


def _liar_start(seed):
    rng = np.random.default_rng(seed)
    x0 = {"w": torch.tensor(rng.normal(size=(NL, 6)).astype(np.float32))}
    honest = np.array([i for i in range(NL) if i not in LIARS])
    return x0, x0["w"].double().numpy()[honest].mean(axis=0)


@pytest.mark.parametrize("spec", [{"kind": "clip", "radius": 2.0}, {"kind": "trim", "trim": 2},
                                  "median"])
def test_robust_mixing_survives_persistent_liars(spec):
    eng = ConsensusEngine(Topology.complete(NL).metropolis_weights(), device="cpu")
    x0, honest_mean = _liar_start(0)
    x_plain, x_rob, total_mass = x0, x0, 0.0
    for _ in range(6):
        x_plain = eng.mix(_poison(x_plain), times=1)
        x_rob, mass = eng.mix_robust(_poison(x_rob), spec, times=1)
        total_mass += float(mass)
    plain_err, robust_err = _honest_spread(x_plain, honest_mean), _honest_spread(x_rob,
                                                                                 honest_mean)
    assert plain_err > 50.0, plain_err
    assert robust_err < 5.0, robust_err
    assert plain_err / max(robust_err, 1e-9) > 20.0
    assert total_mass > 0.0


def test_async_robust_survives_liar_and_flags_mass():
    eng = ConsensusEngine(Topology.complete(NL).metropolis_weights(), device="cpu")
    x0, honest_mean = _liar_start(1)
    spec = {"kind": "clip", "radius": 2.0}
    x_plain, st_plain, x_rob, st_rob, masses = x0, None, x0, None, []
    for _ in range(6):
        x_plain, st_plain = eng.mix_async(_poison(x_plain), st_plain, tau=1, periods=1)
        x_rob, st_rob, mass = eng.mix_async_robust(_poison(x_rob), st_rob, spec=spec, tau=1,
                                                   periods=1)
        masses.append(float(mass))
    assert _honest_spread(x_plain, honest_mean) > 50.0
    assert _honest_spread(x_rob, honest_mean) < 5.0
    assert all(m > 0.0 for m in masses)


def test_liar_rounds_match_jax():
    """The attack's rounds themselves, against the reference's engine."""
    W = Topology.complete(NL).metropolis_weights()
    je, te = _engines(W)
    x0, _ = _liar_start(0)
    for spec in ({"kind": "clip", "radius": 2.0}, {"kind": "trim", "trim": 2}, "median"):
        xj, xt = {"w": jnp.asarray(x0["w"].numpy())}, x0
        for _ in range(6):
            xt = _poison(xt)
            xj, mj = je.mix_robust({"w": jnp.asarray(xt["w"].numpy())}, spec, times=1)
            xt, mt = te.mix_robust(xt, spec, times=1)
            _assert_close(xt, xj, str(spec), rtol=2e-6, atol=LIAR_ATOL)
            assert float(mt) == pytest.approx(float(mj), rel=1e-6)


# -- config plumbing -------------------------------------------------------- #
def test_as_robust_config_accepts_and_rejects():
    assert as_robust_config("clip") == RobustConfig(kind="clip")
    assert as_robust_config("median").kind == "median"
    cfg = as_robust_config({"kind": "clip", "radius": 2.0, "adaptive": True})
    assert cfg.radius == 2.0 and cfg.adaptive
    assert as_robust_config(cfg) is cfg
    assert as_robust_config("clip").neutral
    assert as_robust_config({"kind": "trim", "trim": 0}).neutral
    assert not as_robust_config({"kind": "trim", "trim": 1}).neutral
    assert not as_robust_config("median").neutral
    assert tuple(as_robust_config({"kind": "trim", "trim": 2})) == tuple(
        jax_as_robust_config({"kind": "trim", "trim": 2}))


@pytest.mark.parametrize("spec,exc,match", [
    ("nope", ValueError, "robust_mixing kind must be one of"),
    ({"kind": "clip", "bogus": 1}, ValueError, r"unknown robust_mixing key\(s\) \['bogus'\]"),
    ({"kind": "trim", "trim": -1}, ValueError, "trim must be >= 0, got -1"),
    (3.5, TypeError, "robust_mixing must be a RobustConfig, mapping, or kind string, got float"),
])
def test_as_robust_config_rejections_match_jax(spec, exc, match):
    for fn in (jax_as_robust_config, as_robust_config):
        with pytest.raises(exc, match=match):
            fn(spec)
