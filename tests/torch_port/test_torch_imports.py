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


_LM_EXTRAS = [
    "distributed_learning_tpu_torch.models._stacked",
    "distributed_learning_tpu_torch.models.moe",
    "distributed_learning_tpu_torch.models.transformer",
]


def test_lm_extras_modules_import_no_jax():
    """The LM extras (MoE, decode and generation, the shared dropout and
    remat tape), each imported on its own with its public names, load no
    JAX and nothing of the JAX package."""
    code = "\n".join(
        ["import importlib, sys"]
        + [f"importlib.import_module({m!r})" for m in _LM_EXTRAS]
        + ["from distributed_learning_tpu_torch.models.moe import (MoEMLP,"
           " collect_load_balance_loss)",
           "from distributed_learning_tpu_torch.models.transformer import (KVCache, generate,"
           " sample_fn, truncate_logits, validate_sampling)",
           "from distributed_learning_tpu_torch.models._stacked import Dropout, remat_tape",
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


def test_lm_extras_entry_points_need_the_card_unless_cpu_is_asked_for():
    from distributed_learning_tpu_torch.models import TransformerLM
    from distributed_learning_tpu_torch.models.moe import MoEMLP

    kw = dict(vocab_size=8, num_layers=1, num_heads=2, head_dim=8, max_len=8,
              pos_emb="rope", num_kv_heads=1, mlp="moe", dropout_rate=0.1)
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(**kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MoEMLP(1, 8, 4)
    assert TransformerLM(device="cpu", **kw).flat_params.device.type == "cpu"


_SHARDED = [
    "distributed_learning_tpu_torch.parallel.multihost",
    "distributed_learning_tpu_torch.parallel.consensus",
    "distributed_learning_tpu_torch.parallel.robust",
    "distributed_learning_tpu_torch.parallel.compression",
    "distributed_learning_tpu_torch.ops.mixing",
    "distributed_learning_tpu_torch.ops.ring_attention",
    "distributed_learning_tpu_torch.models.transformer",
    "distributed_learning_tpu_torch.models.moe",
    "distributed_learning_tpu_torch.training.spmd_lm",
    "distributed_learning_tpu_torch.training.trainer",
    "distributed_learning_tpu_torch.training.tp",
    "distributed_learning_tpu_torch.training.fsdp",
    "distributed_learning_tpu_torch.training.gossip_fsdp",
    "distributed_learning_tpu_torch.convert",
]


def test_sharded_route_modules_and_the_rank_script_import_no_jax():
    """The sharded route (multihost and its two-axis mesh, the engine's
    ``mesh=`` half with the async, robust and CHOCO rounds, sequence
    parallel attention, the agents x seq LM step, the trainer, and item
    5a's tensor parallelism, FSDP, gossip x FSDP / TP, expert sharding
    and sharded conversion) with its public names, and the gloo rank
    script of the sharded tests, load no JAX and nothing of the JAX
    package."""
    code = "\n".join(
        ["import importlib, sys", f"sys.path.insert(0, {os.path.join(REPO, 'tests', 'torch_port')!r})"]
        + [f"importlib.import_module({m!r})" for m in _SHARDED]
        + ["from distributed_learning_tpu_torch.parallel.multihost import (AgentMesh,"
           " default_backend, hybrid_agent_mesh, initialize, order_devices_for_ring,"
           " process_local_agents)",
           "from distributed_learning_tpu_torch.parallel.consensus import (make_agent_mesh,"
           " ring_offset_weights, local_ring_mix, local_sq_deviation)",
           "from distributed_learning_tpu_torch.parallel.multihost import GridMesh",
           "from distributed_learning_tpu_torch.ops.ring_attention import (ring_attention,"
           " ulysses_attention, ring_flash_attention, make_ring_attention)",
           "from distributed_learning_tpu_torch.training.spmd_lm import (make_gossip_lm_step,"
           " stack_agent_states, reject_dropout_model)",
           "from distributed_learning_tpu_torch.parallel.multihost import (P, PartitionSpec,"
           " MeshPosition, shard_slice, local_shard, copy_to_axis, reduce_from_axis,"
           " gather_along_axis, tree_map_with_path)",
           "from distributed_learning_tpu_torch.training.tp import (transformer_tp_rules,"
           " shard_transformer_params, make_tp_train_step, constrain_decode_cache,"
           " make_tp_generate)",
           "from distributed_learning_tpu_torch.training.fsdp import (fsdp_spec,"
           " shard_params_fsdp, make_fsdp_train_step, reject_dropout_model)",
           "from distributed_learning_tpu_torch.training.gossip_fsdp import ("
           "make_gossip_fsdp_step, shard_stacked_fsdp, make_gossip_tp_step, shard_stacked_tp)",
           "from distributed_learning_tpu_torch.models.moe import moe_param_spec,"
           " shard_moe_params",
           "from distributed_learning_tpu_torch.convert import flax_to_torch_shards,"
           " lm_flax_path",
           "import sharded_ranks",
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


def _reference_all(relpath: str) -> list:
    """The names of a JAX-package module's ``__all__``, read from its
    source by ``ast`` (no JAX is imported); a starred entry is skipped."""
    import ast

    with open(os.path.join(REPO, "distributed_learning_tpu", relpath)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "__all__"
                                                for t in node.targets):
            return [ast.literal_eval(e) for e in node.value.elts
                    if not isinstance(e, ast.Starred)]
    raise AssertionError(f"{relpath} has no __all__")


@pytest.mark.parametrize("relpath, module", [
    ("__init__.py", "distributed_learning_tpu_torch"),
    ("parallel/__init__.py", "distributed_learning_tpu_torch.parallel"),
])
def test_package_tops_export_every_reference_name(relpath, module):
    """The port's top-level and ``parallel`` ``__all__`` hold every name of
    the reference's, and each resolves (``make_agent_mesh`` and
    ``__version__`` included)."""
    import importlib

    want = _reference_all(relpath)
    mod = importlib.import_module(module)
    missing = sorted(set(want) - set(mod.__all__))
    assert not missing, f"{module}.__all__ lacks {missing}"
    for name in want:
        assert getattr(mod, name) is not None, name
    if module == "distributed_learning_tpu_torch":
        assert mod.__version__ == "0.1.0"
        assert mod.make_agent_mesh.__module__ == "distributed_learning_tpu_torch.parallel.consensus"
