"""The port's obs plane (``distributed_learning_tpu_torch/obs/``) against the
JAX package's: the same event sequence goes to both packages' objects
(``MetricsRegistry``, ``SpanTracer``, ``QuantileSketch``, ``LabelRollup``,
``FlightRecorder``, ``HealthSentinel``, ``RunAggregator``) with fixed
clocks, and their snapshots, reports, JSONL lines (timestamps dropped),
dumps and the text of ``format_run_report`` and of ``obs-report``
(``--merge``, ``--ledger``, ``--bench``) must be equal.  Pure host code,
exact equality.
"""

import itertools
import json

import pytest

import distributed_learning_tpu.obs as jobs
import distributed_learning_tpu_torch.obs as tobs
from distributed_learning_tpu import cli as jcli
from distributed_learning_tpu.obs import cost as jcost
from distributed_learning_tpu_torch import cli as tcli
from distributed_learning_tpu_torch.obs import cost as tcost

PKGS = {"jax": jobs, "port": tobs}


def _clock(start=1000):
    c = itertools.count(start)
    return lambda: float(next(c))


def _registry_run(obs):
    reg = obs.MetricsRegistry(clock=_clock(), max_points=4, max_events=64)
    for i in range(6):
        reg.inc("consensus.rounds_run", 2)
        reg.gauge("consensus.leaf_count", 10 + i)
        reg.observe("train.loss", 2.0 - 0.1 * i, step=i + 1)
        reg.observe("train.loss/0", 2.1 - 0.1 * i, step=i + 1)
        reg.record_span("trainer.chunk", 0.25 + 0.01 * i, depth=0, t0=500.0 + i)
    reg.event("telemetry", token="0", payload={"epoch": 3})
    return reg


def _strip_ts(lines):
    out = []
    for line in lines:
        ev = json.loads(line)
        ev.pop("ts", None)
        out.append(ev)
    return out


def test_registry_snapshot_report_and_jsonl_equal(tmp_path):
    regs = {k: _registry_run(obs) for k, obs in PKGS.items()}
    assert regs["jax"].snapshot() == regs["port"].snapshot()
    assert regs["jax"].run_report() == regs["port"].run_report()
    lines = {}
    for k, reg in regs.items():
        path = tmp_path / f"{k}.jsonl"
        reg.dump_jsonl(str(path))
        lines[k] = _strip_ts(path.read_text().splitlines())
        rebuilt = PKGS[k].MetricsRegistry.from_jsonl(str(path)).run_report()
        lines[k + "_replayed"] = rebuilt
    assert lines["jax"] == lines["port"]
    assert lines["jax_replayed"] == lines["port_replayed"]


def test_format_run_report_text_equal():
    from distributed_learning_tpu.obs.report import format_run_report as jfmt
    from distributed_learning_tpu_torch.obs.report import format_run_report as tfmt

    assert jfmt(_registry_run(jobs).run_report()) == tfmt(_registry_run(tobs).run_report())


def test_span_tracer_aggregate_and_chrome_trace_equal():
    outs = {}
    for k, obs in PKGS.items():
        reg = obs.MetricsRegistry(clock=_clock())
        tr = obs.SpanTracer(registry=reg, clock=_clock(10))
        tr.wall0 = 1.0e9
        with tr.span("trainer.epoch"):
            with tr.span("trainer.chunk"):
                pass
            with tr.span("trainer.mix"):
                pass
        trace = tr.to_chrome_trace()
        for ev in trace["traceEvents"]:
            ev.pop("tid")
        outs[k] = (tr.aggregate(), trace, reg.snapshot())
    assert outs["jax"] == outs["port"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantile_sketch_and_rollup_equal(seed):
    import numpy as np

    vals = np.random.default_rng(seed).lognormal(-3.0, 1.0, 500).tolist() + [0.0, -0.5]
    outs = {}
    for k, obs in PKGS.items():
        a, b = obs.QuantileSketch(), obs.QuantileSketch()
        a.extend(vals[:250])
        b.extend(vals[250:])
        m = a.copy().merge(b)
        roll = obs.LabelRollup(max_labels=4)
        for i, v in enumerate(vals[:40]):
            roll.add(f"edge{i % 7}", v)
        outs[k] = (m.to_dict(), [m.quantile(q) for q in (0.01, 0.5, 0.9, 0.99)],
                   m.histogram([1e-3, 1e-2, 1e-1]), roll.to_dict(), roll.top(3))
    assert outs["jax"] == outs["port"]


def test_flight_recorder_dump_equal(tmp_path):
    outs = {}
    for k, obs in PKGS.items():
        fr = obs.FlightRecorder(str(tmp_path / k), capacity=3)
        for i in range(5):
            fr.note("a", "tick", i=i)
        fr.note("b", "boom")
        header, events = obs.FlightRecorder.read_dump(
            fr.trigger("round_aborted", round_id=7, token="a"))
        for e in [header] + events:
            for key in ("ts", "wall", "path", "dumped_at"):
                e.pop(key, None)
        outs[k] = (header, events, [e["i"] for e in fr.ring("a")])
    assert outs["jax"] == outs["port"]


def _agent_payloads(obs):
    out = {}
    for token, slow in (("a", 0.01), ("b", 0.2)):
        reg = obs.MetricsRegistry(clock=_clock())
        src = obs.ObsDeltaSource(reg)
        reg.inc("comm.agent.rounds_run", 5)
        if token == "b":
            reg.inc("comm.agent.stale_requests_dropped", 4)
        for r in range(5):
            reg.observe("comm.agent.round_s", slow + r * 0.001, step=r + 1)
            reg.observe("consensus.residual", 10.0 ** -(r + 2), step=r + 1)
            reg.record_span("comm.agent.round", slow, t0=1000.0 + r)
        out[token] = src.pack()
    return out


def test_aggregator_and_health_sentinel_equal(tmp_path):
    outs = {}
    for k, obs in PKGS.items():
        agg = obs.RunAggregator()
        for token, payload in _agent_payloads(obs).items():
            agg.process(token, json.loads(json.dumps(payload)))
        for r in range(5):
            agg.note_round_arrivals(r + 1, {"a": 100.0 + r, "b": 100.2 + r})
            agg.note_round_done(r + 1, 0.05, wall_t0=100.2 + r)
        sentinel = obs.HealthSentinel(agg.registry)
        first = [b.rule for b in sentinel.evaluate()]
        agg.registry.inc("comm.agent.stale_requests_dropped", 1000)
        second = [(b.rule, b.value) for b in sentinel.evaluate()]
        trace = agg.to_chrome_trace()
        outs[k] = (agg.registry.counters, agg.registry.gauges, agg.straggler_profile(),
                   sorted(agg.agents()), first, second,
                   sorted((e["ph"], e.get("name"), e.get("ts")) for e in trace["traceEvents"]))
    assert outs["jax"] == outs["port"]


def _write_agent_logs(obs, d):
    paths = []
    for token, slow in (("a", 0.01), ("b", 0.2)):
        reg = obs.MetricsRegistry(clock=_clock())
        reg.inc("comm.agent.rounds_run", 5)
        if token == "b":
            reg.inc("comm.agent.stale_requests_dropped", 2)
        for r in range(5):
            reg.observe("comm.agent.round_s", slow + r * 0.001, step=r + 1)
            reg.record_span("comm.agent.round", slow,
                            t0=1000.0 + r + (0.2 if token == "b" else 0.0))
        reg.observe("consensus.residual", 1e-4, step=5)
        path = str(d / f"{token}.jsonl")
        reg.dump_jsonl(path)
        paths.append(path)
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_obs_report_single_and_merge_text_equal(tmp_path, capsys):
    outs = {}
    for k, (obs, main) in {"jax": (jobs, jcli.main), "port": (tobs, tcli.main)}.items():
        d = tmp_path / k
        d.mkdir()
        paths = _write_agent_logs(obs, d)
        outs[k] = (_run(main, ["obs-report", paths[0]], capsys),
                   _run(main, ["obs-report", "--merge", *paths], capsys),
                   _run(main, ["obs-report", "--merge", str(d)], capsys))
    assert outs["jax"] == outs["port"]
    assert outs["port"][1][0] == 0 and "straggler" in outs["port"][1][1]


def test_obs_report_bench_text_equal(tmp_path, capsys):
    rows = [
        {"n": 1, "rc": 0, "parsed": {"metric": "m", "value": 100.0, "unit": "samples/sec",
                                     "vs_baseline": 1.0}},
        {"n": 2, "rc": 2, "parsed": None},
        {"n": 3, "rc": 0, "parsed": {"metric": "m", "value": 50.0, "unit": "samples/sec",
                                     "vs_baseline": 0.5}},
        {"n": 4, "rc": 0, "parsed": {"metric": "m", "value": 60.0, "unit": "samples/sec",
                                     "vs_baseline": 0.6, "tunnel_wedged": True}},
    ]
    paths = []
    for row in rows:
        p = tmp_path / f"round_{row['n']:02d}.json"
        p.write_text(json.dumps(row))
        paths.append(str(p))
    j = _run(jcli.main, ["obs-report", "--bench", *paths], capsys)
    t = _run(tcli.main, ["obs-report", "--bench", *paths], capsys)
    assert j == t and t[0] == 0 and "REGRESSION -50% vs r01" in t[1]


def test_obs_report_ledger_text_equal(tmp_path, capsys):
    records = [
        {"ts": 1.7e9, "metric": "m", "value": 10.0, "unit": "samples/sec",
         "cost": {"mfu": 0.21, "flops": 3.6e13, "peak_bytes": 2 ** 34}},
        {"ts": 1.7e9 + 60, "metric": "m", "value": 8.0, "unit": "samples/sec"},
        {"ts": 1.7e9 + 120, "metric": "m", "value": 5.0, "provisional": True},
    ]
    paths = {}
    for k, mod in (("jax", jcost), ("port", tcost)):
        path = str(tmp_path / f"{k}_ledger.jsonl")
        for rec in records:
            assert mod.ledger_append(rec, path)
        paths[k] = path
    j = _run(jcli.main, ["obs-report", "--ledger", paths["jax"]], capsys)
    t = _run(tcli.main, ["obs-report", "--ledger", paths["port"]], capsys)
    assert j == t and t[0] == 0 and "REGRESSION" in t[1]


def test_obs_monitor_once_text_equal(tmp_path, capsys):
    outs = {}
    for k, (obs, main) in {"jax": (jobs, jcli.main), "port": (tobs, tcli.main)}.items():
        agg = obs.RunAggregator()
        stream = str(tmp_path / f"{k}.jsonl")
        sink = obs.JsonlSink(stream)
        agg.registry.add_sink(sink)
        for token, payload in _agent_payloads(obs).items():
            agg.process(token, payload)
        sink.close()
        rc, out = _run(main, ["obs-monitor", stream, "--once"], capsys)
        # The dashboard's header carries the file's age on the wall clock.
        outs[k] = (rc, [l for l in out.splitlines() if "ago" not in l and "age" not in l])
    assert outs["jax"] == outs["port"] and outs["port"][0] == 0


def test_port_obs_exports_the_reference_surface():
    assert sorted(jobs.__all__) == sorted(tobs.__all__)
    for name in tobs.__all__:
        value = getattr(tobs, name)
        if callable(value):
            assert value.__module__.startswith("distributed_learning_tpu_torch."), name
