"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU:
``DebugLogger`` records and logs the same lines; ``trace`` writes a
Chrome trace that ``summarize_trace`` digests into rows with the
reference's keys; ``annotate`` names a span in it; on the CPU the trace
holds no device row, so its coverage of a timed window is ``None``."""

import logging
import os

import pytest
import torch

from distributed_learning_tpu.utils import profiling as jprof
from distributed_learning_tpu_torch.utils import profiling as tprof

REF_KEYS = {"operation", "type", "host_or_device", "occurrences", "total_self_us",
            "avg_self_us", "device_self_pct"}


def _log_lines(mod, caplog):
    caplog.clear()
    log = logging.getLogger(f"dlt.test.{mod.__name__}")
    dl = mod.DebugLogger(logger=log)
    with caplog.at_level(logging.DEBUG, logger=log.name):
        dl.debug("hello %s", "there")
        dl.log_residual(3, 1.25e-3)
        dl.info("plain")
        quiet = mod.DebugLogger(logger=log, enabled=False)
        quiet.debug("never")
        quiet.log_residual(4, 1.0)
    # Drop the elapsed-time prefix: "[  0.000s] ...".
    return [r.getMessage().split("] ", 1)[1] for r in caplog.records], dl.residuals, \
        quiet.residuals


def test_debug_logger_matches_reference(caplog):
    assert _log_lines(jprof, caplog) == _log_lines(tprof, caplog)


def test_enable_debug_logging_sets_the_root():
    logger = tprof.enable_debug_logging("dlt.port_test")
    assert logger.level == logging.DEBUG
    assert logger is jprof.enable_debug_logging("dlt.port_test")


def _work():
    with tprof.annotate("port.block"):
        a = torch.randn(32, 32)
        for _ in range(3):
            a = torch.tanh(a @ a)
    return a


def test_trace_writes_a_chrome_trace_and_summarize_reads_it(tmp_path):
    d = str(tmp_path / "tr")
    with tprof.trace(d):
        _work()
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    rows = tprof.summarize_trace(d, top=50)
    assert rows and all(set(r) == REF_KEYS for r in rows)
    names = {r["operation"] for r in rows}
    assert "port.block" in names and "aten::mm" in names
    mm = next(r for r in rows if r["operation"] == "aten::mm")
    assert mm["occurrences"] == 3 and mm["host_or_device"] == "host"
    assert mm["avg_self_us"] == pytest.approx(mm["total_self_us"] / 3)
    assert all(r["device_self_pct"] is None for r in rows if r["host_or_device"] == "host")
    assert [r["total_self_us"] for r in rows] == sorted((r["total_self_us"] for r in rows),
                                                        reverse=True)
    # The annotation's self time excludes its children.
    block = next(r for r in rows if r["operation"] == "port.block")
    assert block["total_self_us"] <= sum(r["total_self_us"] for r in rows)
    assert tprof.trace_coverage(d, 1.0) is None
    text = tprof.format_trace_summary(rows[:3], coverage=0.5)
    assert text.splitlines()[0] == "device rows cover 50.0% of the event-timed window"
    assert tprof.format_trace_summary(rows[:3]) == jprof.format_trace_summary(rows[:3])


def test_maybe_trace_is_a_no_op_without_a_dir(tmp_path):
    with tprof.maybe_trace(None):
        _work()
    with tprof.maybe_trace(str(tmp_path / "m")):
        _work()
    assert os.listdir(tmp_path / "m")
    with pytest.raises(FileNotFoundError):
        tprof.summarize_trace(str(tmp_path / "nothing"))


def test_spans_annotate_inside_a_trace(tmp_path):
    from distributed_learning_tpu_torch.obs import MetricsRegistry, SpanTracer

    tracer = SpanTracer(registry=MetricsRegistry(), profiler=True)
    d = str(tmp_path / "sp")
    with tprof.trace(d):
        with tracer.span("trainer.chunk"):
            _work()
    assert "trainer.chunk" in {r["operation"] for r in tprof.summarize_trace(d, top=50)}
