"""The PyTorch port stands alone: importing every module of
``distributed_learning_tpu_torch`` (and ``chip_smoke.py``) loads neither
JAX nor any module of the JAX package ``distributed_learning_tpu``."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHECK = r"""
import importlib, pkgutil, sys
import distributed_learning_tpu_torch as pkg
names = [pkg.__name__] + [
    m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
import chip_smoke  # the card's smoke script imports without running
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
    or m == "distributed_learning_tpu" or m.startswith("distributed_learning_tpu.")
)
print("MODULES=%d" % len(names))
print("LOADED=" + ",".join(bad))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _CHECK], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = dict(
        line.split("=", 1) for line in out.stdout.splitlines() if "=" in line
    )
    assert int(lines["MODULES"]) >= 15, out.stdout
    assert lines["LOADED"] == "", f"port import loaded {lines['LOADED']}"


def test_entry_points_need_the_card_unless_cpu_is_asked_for():
    from distributed_learning_tpu_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


_GRAPH_LAYER = [
    "distributed_learning_tpu_torch.parallel._spmd",
    "distributed_learning_tpu_torch.parallel.extra",
    "distributed_learning_tpu_torch.parallel.fast_averaging",
    "distributed_learning_tpu_torch.parallel.gradient_tracking",
    "distributed_learning_tpu_torch.parallel.pushsum",
    "distributed_learning_tpu_torch.parallel.schedule",
    "distributed_learning_tpu_torch.parallel.topology",
    "distributed_learning_tpu_torch.interop",
    "distributed_learning_tpu_torch.utils.telemetry",
]


def test_graph_layer_modules_import_no_jax():
    """The gossip variants and the graph layer, each imported on its own
    (plus the reference's top-level names), load no JAX and nothing of
    the JAX package."""
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in _GRAPH_LAYER]
        + ["import distributed_learning_tpu_torch as d",
           "[getattr(d, n) for n in ('Topology', 'gamma', 'spectral_gap', 'ConsensusEngine',"
           " 'Mixer', 'find_optimal_weights', 'solve_fastest_mixing', 'PushSumEngine',"
           " 'push_sum_matrix')]",
           "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
           " or m.startswith('jaxlib') or m == 'distributed_learning_tpu'"
           " or m.startswith('distributed_learning_tpu.'))",
           "print('LOADED=' + ','.join(bad))"])
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = [line for line in out.stdout.splitlines() if line.startswith("LOADED=")][0]
    assert loaded == "LOADED=", f"port import loaded {loaded}"


_OBS_CLI = [
    "distributed_learning_tpu_torch.cli",
    "distributed_learning_tpu_torch.obs",
    "distributed_learning_tpu_torch.obs.registry",
    "distributed_learning_tpu_torch.obs.spans",
    "distributed_learning_tpu_torch.obs.carry",
    "distributed_learning_tpu_torch.obs.instrument",
    "distributed_learning_tpu_torch.obs.cost",
    "distributed_learning_tpu_torch.obs.sketch",
    "distributed_learning_tpu_torch.obs.flight",
    "distributed_learning_tpu_torch.obs.health",
    "distributed_learning_tpu_torch.obs.aggregate",
    "distributed_learning_tpu_torch.obs.report",
    "distributed_learning_tpu_torch.utils.profiling",
    "distributed_learning_tpu_torch.training.config",
    "distributed_learning_tpu_torch.training.eval",
]


@pytest.fixture(scope="module")
def obs_cli_imports():
    """One fresh interpreter imports the modules in turn (and runs the
    CLI's ``obs-report`` on a one-line log); after each import it lists
    the JAX modules loaded so far, so a module that loads JAX is named
    by the first line that is not empty."""
    code = "\n".join([
        "import importlib, sys, tempfile, os",
        "def bad():",
        "    return ','.join(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m == 'distributed_learning_tpu'"
        " or m.startswith('distributed_learning_tpu.')))",
        f"for name in {_OBS_CLI!r}:",
        "    importlib.import_module(name)",
        "    print('LOADED', name, '=' + bad())",
        "from distributed_learning_tpu_torch.cli import main",
        "d = tempfile.mkdtemp(); p = os.path.join(d, 'r.jsonl')",
        "open(p, 'w').write('{\"ts\": 1.0, \"kind\": \"series\", \"name\": \"x\", \"value\": 1.0}\\n')",
        "assert main(['obs-report', p]) == 0",
        "print('LOADED obs-report =' + bad())",
    ])
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return dict(line[len("LOADED "):].split(" =", 1) for line in out.stdout.splitlines()
                if line.startswith("LOADED "))


@pytest.mark.parametrize("module", _OBS_CLI + ["obs-report"])
def test_obs_cli_config_and_eval_import_no_jax(module, obs_cli_imports):
    """The obs layer, the CLI (and its ``obs-report`` run), the
    experiment config and LM eval load no JAX and nothing of the JAX
    package."""
    assert obs_cli_imports[module] == "", f"{module} loaded {obs_cli_imports[module]}"
