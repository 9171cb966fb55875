"""The port's TCP backend carries a real model (mirror of
``tests/test_comm_model.py``): 3 OS processes of the port gossip a small
MLP's parameters, each agent's a nested mapping of torch tensors, to
their weighted mean through ``run_round`` with the bf16 wire on, beside
a port master process, all on the CPU.  Plus the tree codec's unit
checks with torch tensors.  The subprocesses have 60 s each.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from distributed_learning_tpu_torch.comm.pytree_codec import flat_to_tree, tree_to_flat
from distributed_learning_tpu_torch.models import ANNModel

SUBPROCESS_S = 60
WEIGHTS = {"A": 1.0, "B": 2.0, "C": 3.0}


def _params(token: str) -> dict:
    """The MLP (4 -> 8 -> 8 -> 8 -> 3) of agent ``token`` as a nested
    mapping, flax's names, seeded by the token."""
    model = ANNModel(hidden_dim=8, output_dim=3, input_shape=(4,), device="cpu", seed=ord(token))
    tree: dict = {}
    for name, p in model.stacked_parameters().items():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = p[0].detach().clone()
    return tree


def test_tree_codec_roundtrip_mixed_float_dtypes():
    tree = {"dense": {"kernel": torch.ones(3, 4, dtype=torch.bfloat16),
                      "bias": torch.arange(4, dtype=torch.float32)},
            "scale": torch.tensor(2.5)}
    flat, spec = tree_to_flat(tree)
    assert flat.dtype == np.float32 and flat.size == spec.total == 17
    back = flat_to_tree(flat, spec, device="cpu")
    for a, b in ((tree["dense"]["kernel"], back["dense"]["kernel"]),
                 (tree["dense"]["bias"], back["dense"]["bias"]), (tree["scale"], back["scale"])):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_tree_codec_rejects_integer_leaves_and_specs_agree_across_seeds():
    with pytest.raises(TypeError):
        tree_to_flat({"step": torch.tensor(3, dtype=torch.int32), "w": torch.ones(2)})
    assert tree_to_flat(_params("A"))[1] == tree_to_flat(_params("B"))[1]


_MASTER = r"""
import asyncio, sys
from distributed_learning_tpu_torch.comm.master import ConsensusMaster

async def main():
    master = ConsensusMaster([("A", "B"), ("B", "C"), ("C", "A")], port=int(sys.argv[1]),
                             convergence_eps=1e-3)
    await master.start()
    print("MASTER-UP", flush=True)
    await master._stopped.wait()

asyncio.run(main())
"""

_AGENT = r"""
import asyncio, socket, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[5])
from test_torch_comm_model import _params
from distributed_learning_tpu_torch.comm.agent import ConsensusAgent
from distributed_learning_tpu_torch.comm.pytree_codec import flat_to_tree, tree_to_flat

token, port, weight, outdir = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), sys.argv[4]
params = _params(token)
flat, spec = tree_to_flat(params)

deadline = time.monotonic() + 30
while True:  # wait for the master to listen
    try:
        socket.create_connection(("127.0.0.1", port), timeout=1).close()
        break
    except OSError:
        if time.monotonic() > deadline:
            raise
        time.sleep(0.05)

async def main():
    agent = ConsensusAgent(token, "127.0.0.1", port, bf16_wire=True)
    await agent.start()
    out = await agent.run_round(torch.from_numpy(flat), weight=weight)
    mixed = flat_to_tree(out.numpy(), spec, device="cpu")  # the model tree again
    assert mixed.keys() == params.keys()
    np.save(f"{outdir}/{token}.npy", out.numpy())
    await agent.close()

asyncio.run(asyncio.wait_for(main(), 50))
print(f"AGENT-DONE {token}", flush=True)
"""


def test_three_port_processes_gossip_mlp_params_to_weighted_mean():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    with tempfile.TemporaryDirectory() as outdir:
        master = subprocess.Popen([sys.executable, "-c", _MASTER, str(port)], env=env, cwd=repo,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        agents = {t: subprocess.Popen([sys.executable, "-c", _AGENT, t, str(port), str(w), outdir,
                                       here], env=env, cwd=repo, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                  for t, w in WEIGHTS.items()}
        try:
            outs = {t: p.communicate(timeout=SUBPROCESS_S)[0] for t, p in agents.items()}
            for t, p in agents.items():
                assert p.returncode == 0, f"agent {t} failed:\n{outs[t]}"
                assert f"AGENT-DONE {t}" in outs[t]
        finally:
            master.kill()
            master.communicate()
            for p in agents.values():
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        results = {t: np.load(f"{outdir}/{t}.npy") for t in WEIGHTS}
    flats = {t: tree_to_flat(_params(t))[0] for t in WEIGHTS}
    expect = sum(WEIGHTS[t] * flats[t] for t in WEIGHTS) / sum(WEIGHTS.values())
    for got in results.values():
        np.testing.assert_allclose(got, expect, atol=2e-2)  # bf16 quantizes each hop
    vals = list(results.values())
    for v in vals[1:]:
        np.testing.assert_allclose(v, vals[0], atol=5e-3)
