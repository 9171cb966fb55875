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
