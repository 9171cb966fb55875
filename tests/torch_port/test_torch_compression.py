"""The port's CHOCO compressed gossip (``parallel/compression.py``) against
the JAX package's, on the CPU.

The same numpy-seeded inputs go through both.  Limits:

* top-k, approx-top-k (exact on the CPU on both sides), int8 and identity:
  the selected index sets are identical and the values bit-exact, on
  float32 and bfloat16 leaves, with NaNs and magnitude ties at the k
  boundary;
* scaled sign: the scale is a float32 (or bfloat16) sum whose order
  differs between the two libraries, so values agree within a few units
  in the last place of the scale (rtol 1e-6 float32, 2**-8 bfloat16),
  with the same signs and zeros;
* ``ChocoGossipEngine.run``, 20 rounds on a 4-agent ring: ``x``,
  ``xhat``, ``ef`` and the residual trace within 2e-6 absolute, the limit
  of ``tests/test_consensus.py``;
* random-k draws from a ``torch.Generator``, whose bits cannot follow
  ``jax.random``: its own properties, and a CHOCO run whose masks are the
  reference's ``jax.random.choice`` draws, fed in, within 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.ops import mixing as jax_mixing
from distributed_learning_tpu.parallel import compression as jc
from distributed_learning_tpu.parallel import Topology as JaxTopology
from distributed_learning_tpu_torch.ops import mixing as ops
from distributed_learning_tpu_torch.parallel import compression as tc

N = 4
RING = JaxTopology.ring(N).metropolis_weights()
KINDS = ["topk", "atopk", "sign", "int8", "identity"]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x) -> np.ndarray:
    """float64 numpy of a torch or jax array of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), dtype=np.float64)


def _pair(spec):
    return tc.compressor_from_spec(spec), jc.compressor_from_spec(spec)


def _awkward(rows=N, d=40, seed=0):
    """Rows with a NaN, and magnitude ties straddling every k boundary
    (values drawn from a handful of magnitudes, both signs)."""
    rng = np.random.default_rng(seed)
    v = rng.choice([0.25, 0.5, 1.0, 2.0], size=(rows, d)) * rng.choice([-1.0, 1.0], size=(rows, d))
    v[0, 3] = np.nan
    v[1, 17] = 0.0
    return v.astype(np.float32)


def _assert_same(got, want, kind, dtype, label=""):
    g, w = _np(got), _np(want)
    assert np.array_equal(np.isnan(g), np.isnan(w)), label
    # The index sets: a different selection puts a nonzero where the
    # reference has a zero.
    assert np.array_equal(g != 0, w != 0), label
    if kind == "sign":
        rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=label)
    else:
        np.testing.assert_array_equal(g, w, err_msg=label)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", KINDS)
def test_compressor_matches_reference(kind, dtype):
    spec = {"topk": "topk:0.3", "atopk": "atopk:0.3"}.get(kind, kind)
    port, ref = _pair(spec)
    td, jd = DTYPES[dtype]
    v = _awkward()
    for a in range(N):
        got = port(torch.tensor(v[a]).to(td), None)
        want = ref(jnp.asarray(v[a], jd), jax.random.key(0))
        assert got.dtype == td and got.shape == (v.shape[1],)
        _assert_same(got, want, kind, dtype, f"{kind} row {a}")


def test_top_k_keeps_nan_then_lowest_index_ties():
    v = torch.tensor([1.0, float("nan"), 3.0, 0.5, 2.0, 0.1, -2.0, 0.0])
    out = tc.top_k(0.5)(v)
    # NaN first, then 3, then the tie |2| = |-2| goes to index 4 and 6 both (k = 4).
    assert torch.isnan(out[1]) and out[2] == 3.0 and out[4] == 2.0 and out[6] == -2.0
    assert int((out != 0).sum()) == 4
    out = tc.top_k(0.25)(torch.tensor([2.0, -2.0, 2.0, 1.0, -2.0, 0.0, 0.5, 0.1]))
    assert out.tolist() == [2.0, -2.0, 0, 0, 0, 0, 0, 0]


def _mixed(seed=0, n=N):
    """A mixed float32 + bfloat16 stacked tree, keys sorted (the
    reference's leaf order), spans in several power-of-two size classes,
    a scalar leaf and ties at the k boundaries."""
    rng = np.random.default_rng(seed)
    shapes = {"b": (3,), "g": (7,), "h": (5,), "m": (2, 4), "s": (), "w": (16,), "z": (37,)}
    dts = {"g": "bfloat16", "h": "bfloat16"}
    out = {}
    for k, shp in shapes.items():
        v = rng.choice([0.25, 0.5, 1.0, 2.0, 3.0], size=(n,) + shp) * rng.normal(size=(n,) + shp)
        v[..., ] = np.where(rng.random(size=(n,) + shp) < 0.2, 1.0, v)
        out[k] = (v.astype(np.float32), dts.get(k, "float32"))
    return out


def _trees(mixed):
    port = {k: torch.tensor(v).to(DTYPES[d][0]) for k, (v, d) in mixed.items()}
    ref = {k: jnp.asarray(v, DTYPES[d][1]) for k, (v, d) in mixed.items()}
    return port, ref


@pytest.mark.parametrize("budget", ["per-leaf", "global"])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_compressor_matches_reference(kind, budget):
    spec = {"topk": "topk:0.3", "atopk": "atopk:0.3"}.get(kind, kind)
    port, ref = _pair(spec)
    tp, tj = _trees(_mixed())
    pb, pl = ops.flatten_stacked(tp)
    jb, jl = jax_mixing.flatten_stacked(tj)
    assert [b for b in pl.buckets] == [tuple(b) for b in jl.buckets]
    for name, _w in pl.buckets:
        assert pl.bucket_spans(name) == tuple(jl.bucket_spans(name))
    got = tc.FusedCompressor(port, budget).compress(pb, pl, None, n=N)
    want = jc.FusedCompressor(ref, budget).compress(jb, jl, jax.random.key(0), n=N)
    for name, _w in pl.buckets:
        _assert_same(got[name], want[name], kind, name, f"{kind} {budget} {name}")
    # Per-leaf budget: the fused result is the per-leaf compressor's.
    if budget == "per-leaf":
        views = tc.FusedCompressor(port).per_leaf_views(pb, pl, None, n=N)
        for name in got:
            assert torch.equal(got[name], views[name]) or kind == "sign", name


def test_fused_segment_top_k_keeps_nan_and_ties():
    x = {"a": torch.tensor([[1.0, float("nan"), 3.0, 0.5, 2.0, 0.1, -2.0, 0.0]])}
    buffers, layout = ops.flatten_stacked(x)
    got = tc.FusedCompressor(tc.top_k(0.5)).compress(buffers, layout, None, n=1)["float32"]
    want = jc.FusedCompressor(jc.top_k(0.5)).compress(
        {"float32": jnp.asarray(x["a"].numpy())}, jax_mixing.fused_layout(
            {"a": jnp.asarray(x["a"].numpy())}), jax.random.key(0), n=1)["float32"]
    _assert_same(got, want, "topk", "float32")
    assert torch.isnan(got[0, 1])


def test_fused_compressor_rejects_bad_configs():
    with pytest.raises(ValueError, match="budget"):
        tc.FusedCompressor(tc.top_k(0.1), budget="per-tensor")
    with pytest.raises(ValueError, match="named compressor"):
        tc.FusedCompressor(lambda v, g: v, budget="global")
    with pytest.raises(ValueError, match="fused=True"):
        tc.ChocoGossipEngine(RING, tc.top_k(0.1), fused=False, budget="global",
                            device="cpu")
    with pytest.raises(ValueError, match="fused=True"):
        tc.ChocoGossipEngine(RING, tc.top_k(0.1), fused=False, error_feedback=True,
                            device="cpu")


@pytest.mark.parametrize("budget", ["per-leaf", "global"])
@pytest.mark.parametrize("spec", ["topk:0.3", "atopk:0.1", "randk:0.25", "sign", "int8", "none"])
def test_wire_bytes_per_round_matches_reference(spec, budget):
    port, ref = _pair(spec)
    tp, tj = _trees(_mixed())
    _, pl = ops.flatten_stacked(tp)
    jl = jax_mixing.fused_layout(tj)
    got = tc.FusedCompressor(port, budget).wire_bytes_per_round(pl, N)
    assert got == jc.FusedCompressor(ref, budget).wire_bytes_per_round(jl, N)
    assert pl.bytes_per_round(N) == jl.bytes_per_round(N)
    assert tc.FusedCompressor(lambda v, g: v).wire_bytes_per_round(pl, N) is None


@pytest.mark.parametrize(
    "spec,kind,fraction",
    [("topk:0.2", "top_k", 0.2), ("top_k", "top_k", 0.1), ("atopk:0.5", "approx_top_k", 0.5),
     ("randk:0.25", "random_k", 0.25), ("sign", "scaled_sign", None),
     ("int8", "int8_quant", None), ("none", "identity", None), ("q8", "int8_quant", None)],
)
def test_compressor_from_spec(spec, kind, fraction):
    got, want = _pair(spec)
    assert (got.kind, got.fraction) == (want.kind, want.fraction) == (kind, fraction)


@pytest.mark.parametrize(
    "spec,match",
    [("topk:abc", "bad fraction"), ("nonsense:9", "unknown compressor"),
     ("topk:0", "fraction must be in"), ("randk:1.5", "fraction must be in")],
)
def test_compressor_from_spec_errors(spec, match):
    with pytest.raises(ValueError, match=match):
        tc.compressor_from_spec(spec)
    with pytest.raises(ValueError, match=match):
        jc.compressor_from_spec(spec)


def test_compressor_delta():
    assert tc.compressor_delta(tc.identity()) == 1.0
    for comp in (tc.top_k(0.1), tc.approx_top_k(0.1), tc.random_k(0.25), tc.scaled_sign(),
                 tc.int8_quant()):
        assert 0.0 < tc.compressor_delta(comp, dim=128, trials=20) <= 1.0


def _x0(seed=0, d=24):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(N, d)).astype(np.float32),
            "b": rng.normal(size=(N, 3, 5)).astype(np.float32),
            "c": rng.normal(size=(N,)).astype(np.float32)}


ENGINES = {
    "topk": dict(spec="topk:0.3"),
    "topk_perleaf_oracle": dict(spec="topk:0.3", fused=False),
    "topk_global_ef": dict(spec="topk:0.2", budget="global", error_feedback=True, gamma=0.05),
    "atopk_ef": dict(spec="atopk:0.3", error_feedback=True, gamma=0.05),
    "sign": dict(spec="sign", gamma=0.1),
    "int8_global": dict(spec="int8", budget="global"),
    "identity": dict(spec="none"),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_choco_engine_run_matches_reference(name):
    cfg = dict(ENGINES[name])
    spec = cfg.pop("spec")
    kw = dict(gamma=cfg.pop("gamma", 0.2), **cfg)
    port = tc.ChocoGossipEngine(RING, tc.compressor_from_spec(spec), device="cpu", **kw)
    ref = jc.ChocoGossipEngine(RING, jc.compressor_from_spec(spec), **kw)
    x0 = _x0()
    sp, tp = port.run(port.init({k: torch.tensor(v) for k, v in x0.items()}, seed=3), 20)
    sj, tj = ref.run(ref.init({k: jnp.asarray(v) for k, v in x0.items()}, seed=3), 20)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=2e-6, rtol=0)
    fields = ("x", "xhat", "ef") if kw.get("error_feedback") else ("x", "xhat")
    for field in fields:
        for k in x0:
            np.testing.assert_allclose(_np(getattr(sp, field)[k]), _np(getattr(sj, field)[k]),
                                       atol=2e-6, rtol=0, err_msg=f"{name} {field} {k}")
    assert (sp.ef is None) == (not kw.get("error_feedback"))
    # The iterates' mean is preserved (symmetric W), and they contract.
    np.testing.assert_allclose(sp.x["a"].mean(0).numpy(), x0["a"].mean(0), atol=1e-5)
    assert port.max_deviation(sp) < float(torch.tensor(x0["a"]).std(0).norm())


def _masks_of(keep):
    return (keep != 0).sum(-1)


def test_random_k_properties():
    """Exactly k kept per leaf and agent, kept values exact, masks that
    differ across agents, and reproducible from the generator; the global
    budget keeps k per agent row."""
    tp, _ = _trees({k: (v, "float32") for k, (v, _d) in _mixed(seed=2).items()})
    buffers, layout = ops.flatten_stacked({k: v + 10.0 for k, v in tp.items()})  # no zeros
    buf = buffers["float32"]
    fc = tc.FusedCompressor(tc.random_k(0.4))
    g = torch.Generator().manual_seed(5)
    out = fc.compress(buffers, layout, g, n=N)["float32"]
    for off, size in layout.bucket_spans("float32"):
        sl = out[:, off: off + size]
        assert (_masks_of(sl) == tc._k_of(0.4, size)).all()
    kept = out != 0
    assert torch.equal(out[kept], buf[kept])
    big = layout.bucket_spans("float32")[-1]
    rows = kept[:, big[0]: big[0] + big[1]]
    assert any(not torch.equal(rows[0], rows[a]) for a in range(1, N))
    again = fc.compress(buffers, layout, torch.Generator().manual_seed(5), n=N)["float32"]
    assert torch.equal(out, again)
    nxt = fc.compress(buffers, layout, g, n=N)["float32"]
    assert not torch.equal(out, nxt)
    glob = tc.FusedCompressor(tc.random_k(0.25), "global").compress(
        buffers, layout, torch.Generator().manual_seed(1), n=N)["float32"]
    assert (_masks_of(glob) == tc._k_of(0.25, buf.shape[1])).all()
    assert torch.equal(glob[glob != 0], buf[glob != 0])


def test_choco_with_the_references_random_k_masks():
    """The reference's random-k CHOCO (fused, per-leaf views: one key
    split per round, per leaf, per agent) against the port's CHOCO whose
    compressor keeps the index sets the reference drew, fed in."""
    x0 = _x0(seed=4)
    rounds, fraction, seed = 20, 0.25, 9
    ref = jc.ChocoGossipEngine(RING, jc.random_k(fraction), gamma=0.2)
    sj, tj = ref.run(ref.init({k: jnp.asarray(v) for k, v in x0.items()}, seed=seed), rounds)
    # The reference's draws, in its order: round, leaf (sorted keys), agent.
    draws = []
    key = jax.random.key(seed)
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        for leaf_key, name in zip(jax.random.split(sub, len(x0)), sorted(x0)):
            size = int(np.prod(x0[name].shape[1:]))
            k = jc._k_of(fraction, size)
            for agent_key in jax.random.split(leaf_key, N):
                draws.append(np.asarray(jax.random.choice(agent_key, size, (k,), replace=False)))
    feed = iter(draws)

    def fed(v, generator):
        flat = v.reshape(-1)
        return tc._keep(flat, torch.tensor(np.array(next(feed)), dtype=torch.long)).reshape(v.shape)

    port = tc.ChocoGossipEngine(RING, tc.Compressor(fed), gamma=0.2, device="cpu")
    sp, tp = port.run(port.init({k: torch.tensor(v) for k, v in sorted(x0.items())}), rounds)
    assert next(feed, None) is None
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=2e-6, rtol=0)
    for field in ("x", "xhat"):
        for k in x0:
            np.testing.assert_allclose(_np(getattr(sp, field)[k]), _np(getattr(sj, field)[k]),
                                       atol=2e-6, rtol=0, err_msg=f"{field} {k}")


def test_choco_round_is_in_place_and_random_k_reproducible():
    """``round_`` writes the caller's buffers and no others; two engines
    from one generator seed take the same random-k rounds."""
    x0 = {k: torch.tensor(v) for k, v in _x0().items()}
    eng = tc.ChocoGossipEngine(RING, tc.random_k(0.3), gamma=0.2, error_feedback=True,
                               device="cpu")
    buffers, layout = ops.flatten_stacked(x0)
    x, xhat, ef = buffers, {k: torch.zeros_like(v) for k, v in buffers.items()}, \
        {k: torch.zeros_like(v) for k, v in buffers.items()}
    ptrs = [t.data_ptr() for d in (x, xhat, ef) for t in d.values()]
    eng.round_(x, xhat, ef, layout, torch.Generator().manual_seed(0))
    assert ptrs == [t.data_ptr() for d in (x, xhat, ef) for t in d.values()]
    assert not torch.equal(x["float32"], ops.flatten_stacked(x0)[0]["float32"])
    a = eng.run(eng.init(x0, seed=1), 5)
    b = eng.run(eng.init(x0, seed=1), 5)
    assert all(torch.equal(a[0].x[k], b[0].x[k]) for k in x0)
    assert torch.equal(a[1], b[1])
