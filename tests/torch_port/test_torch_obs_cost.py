"""The port's device-metrics carry and cost observatory
(``obs/carry.py``, ``obs/cost.py``, ``obs/instrument.py``) against the
JAX package's, on the CPU.

* ``global_norm`` on float32 and bfloat16 leaves: 1e-6 relative (the
  same float32 sums in another order);
* ``flush_chunk``: the same series (names, steps, values to 1e-7
  relative: numpy means of the same float32 arrays) for scalar,
  ``(steps,)``, ``(steps, n)`` and ``(k, steps, n)`` traces;
* operation counts: exact (integers);
* ``mfu``, the timer's accounting and the ledger: exact.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_learning_tpu.obs import carry as jcarry
from distributed_learning_tpu.obs import cost as jcost
from distributed_learning_tpu.obs.registry import MetricsRegistry as JaxRegistry
from distributed_learning_tpu_torch.obs import carry as tcarry
from distributed_learning_tpu_torch.obs import cost as tcost
from distributed_learning_tpu_torch.obs.instrument import instrument_step
from distributed_learning_tpu_torch.obs.registry import MetricsRegistry, use_registry
from distributed_learning_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    leaves = [rng.normal(size=s).astype(np.float32) * 3 for s in ((7, 5), (11,), (3, 4, 2))]
    want = float(jcarry.global_norm([jnp.asarray(x, dtype=dtype) for x in leaves]))
    tl = [torch.tensor(x).to(getattr(torch, dtype)) for x in leaves]
    got = tcarry.global_norm(tl)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert float(tcarry.global_norm(dict(enumerate(tl)))) == pytest.approx(want, rel=1e-6)


def test_global_norm_per_agent_is_the_trainers_gradient_norm():
    g = torch.tensor(np.random.default_rng(1).normal(size=(4, 300)).astype(np.float32))
    per = tcarry.global_norm(g, dim=1)
    for a in range(4):
        want = float(jcarry.global_norm([jnp.asarray(g[a].numpy())]))
        assert float(per[a]) == pytest.approx(want, rel=1e-6)


_NODES = ["a", "b", "c"]


@pytest.mark.parametrize("shape", [(), (6,), (6, 3), (2, 6, 3)],
                         ids=["scalar", "steps", "steps_n", "k_steps_n"])
def test_flush_chunk_series_match_reference(shape):
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jarr = jcarry.flush_chunk(jreg, {"loss": jnp.asarray(x)}, step0=10, node_names=_NODES)
    tarr = tcarry.flush_chunk(treg, {"loss": torch.tensor(x)}, step0=10, node_names=_NODES)
    np.testing.assert_array_equal(jarr["loss"], tarr["loss"])
    assert sorted(jreg.series) == sorted(treg.series)
    for name, pts in jreg.series.items():
        got = treg.series[name]
        assert [s for s, _ in pts] == [s for s, _ in got]
        np.testing.assert_allclose([v for _, v in got], [v for _, v in pts], rtol=1e-7)


def test_flush_chunk_reads_each_tensor_once_and_takes_host_arrays():
    class Counted(torch.Tensor):
        reads = 0

        def cpu(self, *a, **k):
            Counted.reads += 1
            return super().cpu(*a, **k)

    t = torch.arange(12.0).reshape(4, 3).as_subclass(Counted)
    out = tcarry.flush_chunk(MetricsRegistry(), {"a": t, "b": np.ones((4, 3))},
                             node_names=_NODES)
    assert Counted.reads == 1
    assert out["b"].shape == (4, 3)


@pytest.mark.parametrize("mnk", [(3, 5, 7), (64, 32, 16)])
def test_matmul_profile_is_2mnk(mnk):
    M, N, K = mnk
    a, b = torch.randn(M, K), torch.randn(K, N)
    with use_registry(MetricsRegistry()) as reg:
        prof = tcost.profile_fn(torch.matmul, a, b, name="mm")
    assert prof.flops == 2 * M * N * K
    assert prof.platform == "cpu" and prof.bytes_accessed is None and prof.peak_bytes is None
    assert reg.gauges == {"cost.flops/mm": 2.0 * M * N * K}
    assert tcost.get_profile("mm") is prof
    tcost.clear_profiles()


@pytest.mark.parametrize("window", [None, 5])
def test_attention_profile_counts_the_causal_half(window):
    """On the CPU the flash wrapper runs its plain version (full-score
    products, twice the causal work); the profile still counts the
    function's work: 4 FLOPs forward and 10 backward per live (query,
    key) pair and head dimension."""
    B, T, H, D = 2, 12, 3, 8
    q, k, v = (torch.randn(B, T, H, D, requires_grad=True) for _ in range(3))

    def step():
        fa.flash_attention(q, k, v, causal=True, window=window).sum().backward()

    prof = tcost.profile_fn(step, name="attn", register=False)
    w = T if window is None else window
    pairs = B * H * sum(min(r + 1, w) for r in range(T))
    assert fa.live_pairs(B, H, T, T, True, window) == pairs
    assert prof.flops == 14 * pairs * D
    with torch.no_grad():
        fwd = tcost.profile_fn(lambda: fa.flash_attention(q, k, v, window=window),
                               register=False)
    assert fwd.flops == 4 * pairs * D


def test_counted_as_is_inert_without_a_counter():
    with tcost.counted_as(123.0):
        x = torch.randn(4, 4) @ torch.randn(4, 4)
    assert x.shape == (4, 4) and not tcost.counting()


@pytest.mark.parametrize("args", [(1e12, 1.0, 1e13), (None, 1.0, 1e13), (1e12, 0.0, 1e13),
                                  (1e12, 2.0, None), (3e9, 0.5, 989.4e12)])
def test_mfu_arithmetic_matches_reference(args):
    assert tcost.mfu(*args) == jcost.mfu(*args)


def test_profile_mfu_follows_the_loop_convention():
    """flops covers one step; mfu x peak x seconds equals flops x steps."""
    prof = tcost.CostProfile(name="p", flops=2.5e12)
    ref = jcost.CostProfile(name="p", flops=2.5e12)
    m = prof.mfu(0.4, 989.4e12, loop_steps=12)
    assert m == ref.mfu(0.4, 989.4e12, loop_steps=12)
    assert m * 989.4e12 * 0.4 == pytest.approx(2.5e12 * 12, rel=1e-12)
    assert prof.bytes_per_sec(0.4) is None


def test_peak_table(monkeypatch):
    monkeypatch.delenv(tcost.PEAK_FLOPS_ENV, raising=False)
    assert tcost.device_peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert tcost.device_peak_flops("NVIDIA H100 NVL") == 835.5e12
    assert tcost.device_peak_flops("NVIDIA H100 PCIe") == 756.5e12
    assert tcost.device_peak_flops("H100 SXM5 80GB") == 989.4e12
    assert tcost.device_peak_flops("cpu") is None
    assert tcost.device_peak_flops(torch.device("cpu")) is None
    assert tcost.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    if not torch.cuda.is_available():
        assert tcost.device_peak_flops() is None
    # No TPU entry: the port states no TPU rate.
    assert not any(k.startswith("v") or "tpu" in k for k in tcost.PEAK_FLOPS_TABLE)
    monkeypatch.setenv(tcost.PEAK_FLOPS_ENV, "5e14")
    assert tcost.device_peak_flops("NVIDIA H100 80GB HBM3") == 5e14
    assert tcost.device_peak_flops("cpu") == 5e14


@pytest.mark.parametrize("every_n", [0, 1, 2, 3])
def test_timer_accounting_matches_reference(every_n):
    jreg, treg = JaxRegistry(), MetricsRegistry()
    jt = jcost.SampledDispatchTimer(every_n, name="prog", registry=jreg)
    tt = tcost.SampledDispatchTimer(every_n, name="prog", registry=treg)
    assert [jt.tick() for _ in range(7)] == [tt.tick() for _ in range(7)]
    assert (jt.samples, jt.skipped) == (tt.samples, tt.skipped)
    assert jreg.counters == treg.counters


def test_timer_measures_on_the_cpu_with_the_host_clock():
    reg = MetricsRegistry()
    prof = tcost.CostProfile(name="prog", flops=1e9)
    timer = tcost.SampledDispatchTimer(1, name="prog", registry=reg, peak_flops=1e13)
    assert timer.tick()
    t0 = timer.start("cpu")
    assert isinstance(t0, float)
    dt = timer.measure(t0, profile=prof, loop_steps=4, step=3)
    assert dt > 0 and reg.series["cost.step_time_s/prog"] == [(3, dt)]
    assert reg.gauges["cost.mfu/prog"] == pytest.approx(4e9 / dt / 1e13)
    assert "cost.bytes_per_sec/prog" not in reg.gauges


def test_ledger_round_trip_and_default_name(tmp_path, monkeypatch):
    monkeypatch.delenv(tcost.LEDGER_ENV, raising=False)
    assert tcost.DEFAULT_LEDGER == "obs_ledger.jsonl"
    assert tcost.ledger_path() == "obs_ledger.jsonl" != jcost.ledger_path()
    path = str(tmp_path / "ledger.jsonl")
    recs = [{"metric": "samples/s", "value": 5.0, "cost": {"mfu": 0.2}},
            {"metric": "samples/s", "value": 4.0}]
    for r in recs:
        assert tcost.ledger_append(r, path)
    with open(path, "a") as fh:
        fh.write('{"torn": ')
    got = tcost.read_ledger(path)
    assert [r["value"] for r in got] == [5.0, 4.0] and all(r["kind"] == "perf" for r in got)
    assert tcost.format_ledger_trend(got) == jcost.format_ledger_trend(got)
    monkeypatch.setenv(tcost.LEDGER_ENV, path)
    assert tcost.ledger_path() == path


def test_instrumented_step_counts_spans_and_profiles():
    calls = []
    step = instrument_step(lambda a, b: calls.append(1) or a @ b, "tp_step")
    with use_registry(MetricsRegistry()) as reg:
        step(torch.ones(2, 3), torch.ones(3, 4))
        prof = step.cost_profile(torch.ones(2, 3), torch.ones(3, 4))
    assert reg.counters["tp_step.calls"] == 1 and reg.snapshot()["spans"] == {"tp_step": 1}
    assert prof.name == "tp_step" and prof.flops == 2 * 2 * 3 * 4
    assert len(calls) == 2  # the profile runs the step
    tcost.clear_profiles()


def test_engine_cost_profile_counts_the_gemms_and_leaves_counters_alone():
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine

    eng = ConsensusEngine(Topology.ring(4).metropolis_weights(), device="cpu")
    x = {"w": torch.randn(4, 6, 5), "b": torch.randn(4, 5)}
    before = {k: v.clone() for k, v in x.items()}
    with use_registry(MetricsRegistry()) as reg:
        prof = eng.cost_profile(x, times=3)
    assert prof.flops == 3 * 2 * 4 * 4 * 35
    assert reg.counters == {} and reg.gauges == {"cost.flops/consensus.mix": prof.flops}
    assert all(torch.equal(x[k], before[k]) for k in x)
    tcost.clear_profiles()


def test_flop_counter_sees_a_backward():
    w = torch.randn(8, 16, requires_grad=True)
    x = torch.randn(4, 8)
    with tcost.FlopCounter() as c:
        (x @ w).sum().backward()
    assert c.flops == 3 * 2 * 4 * 8 * 16 - 2 * 4 * 8 * 16  # no grad for x
    assert math.isfinite(c.flops)
