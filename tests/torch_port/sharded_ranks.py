"""Gloo ranks on the CPU for the sharded-route tests.

``Ranks(battery, n, inputs)`` writes ``inputs`` (numpy arrays) to a
temporary directory and starts ``n`` interpreters of this file (each with
``PYTHONPATH`` at the repo and a timeout), which join one gloo process
group, build the agent mesh, run the named battery on their rank and
save its results; ``results()`` returns them in rank order, and raises
with every rank's output if one fails (``run_ranks`` does both).  The ranks import PyTorch
and the port, never JAX: the test's own process computes the reference.

The batteries and the trainer configurations they share with the tests
live here too.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TIMEOUT_S = 120


class Ranks:
    """``n`` rank processes running one battery; :meth:`results` waits."""

    def __init__(self, battery: str, n: int, inputs: dict):
        self._tmp = tempfile.TemporaryDirectory()
        tmp = self._tmp.name
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        env.pop("JAX_PLATFORMS", None)
        self._procs = [subprocess.Popen(
            [sys.executable, __file__, battery, tmp, f"127.0.0.1:{port}", str(r), str(n)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        self._results = None

    def results(self) -> list:
        """The ranks' results in rank order; raises with every rank's
        output if one failed or outlived ``TIMEOUT_S``."""
        import torch

        if self._results is not None:
            return self._results
        outs, failed = [], False
        for p in self._procs:
            try:
                out, _ = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in self._procs:
                    q.kill()
                out, _ = p.communicate()
                out += f"\n[timed out after {TIMEOUT_S} s]"
            outs.append(out)
            failed |= p.returncode != 0
        try:
            if failed:
                raise RuntimeError("a rank failed:\n" + "\n".join(
                    f"--- rank {r} (exit {p.returncode}) ---\n{o[-3000:]}"
                    for r, (p, o) in enumerate(zip(self._procs, outs))))
            self._results = [torch.load(os.path.join(self._tmp.name, f"rank{r}.pt"),
                                        weights_only=False) for r in range(len(self._procs))]
        finally:
            self._tmp.cleanup()
        return self._results


def run_ranks(battery: str, n: int, inputs: dict) -> list:
    """The results of ``battery`` on ``n`` gloo CPU ranks, in rank order."""
    return Ranks(battery, n, inputs).results()


def gathered(results: list, key: str) -> np.ndarray:
    """The per-rank stacks of one ``key`` concatenated in agent order
    (agent ``i`` on rank ``i``)."""
    return np.concatenate([np.asarray(r[key]) for r in results])


# ---------------------------------------------------------------------- #
# Shared configurations                                                  #
# ---------------------------------------------------------------------- #
NODES = list(range(4))
MLP = dict(hidden_dim=16, output_dim=3)


def trainer_data(seed: int = 0):
    """Four 24-sample shards of 6 features and 3 classes, and a test set."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(4, 24, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=(4, 24)).astype(np.int32)
    Xt = rng.normal(size=(10, 6)).astype(np.float32)
    yt = rng.integers(0, 3, size=(10,)).astype(np.int32)
    return {a: (X[a], y[a]) for a in NODES}, (Xt, yt)


def trainer_common(**over):
    train, test = trainer_data()
    kw = dict(node_names=NODES, optimizer="adam", learning_rate=1e-2,
              error="cross_entropy", train_data=train, test_data=test, epoch=2,
              batch_size=4, epoch_len=3, mix_times=2, stat_step=1, eval_batch_size=4,
              seed=0)
    kw.update(over)
    return kw


def _er_schedule(epoch):
    from distributed_learning_tpu_torch.parallel import Topology

    return Topology.erdos_renyi(4, 0.7, seed=epoch + 3).metropolis_weights()


# name -> the trainer options of one gossip route (beside the ring).
ROUTES = {
    "plain": {},
    "topology_schedule": {"topology_schedule": _er_schedule},
    "chebyshev": {"chebyshev": True, "mix_times": 3},
    "mix_eps": {"mix_eps": 5e-2, "mix_times": 1},
    "global_avg": {"global_avg_every": 2},
}


# ---------------------------------------------------------------------- #
# Batteries (run on each rank)                                           #
# ---------------------------------------------------------------------- #
def _tensors(inp, prefix, bf16=()):
    import torch

    out = {}
    for k in inp.files:
        if k.startswith(prefix):
            name = k[len(prefix):]
            t = torch.from_numpy(inp[k])
            out[name] = t.to(torch.bfloat16) if name in bf16 else t
    return out


def _f32(tree):
    import torch

    if isinstance(tree, dict):
        return {k: v.to(torch.float32).numpy() for k, v in tree.items()}
    return tree.to(torch.float32).numpy()


def battery_engine(mesh, inp):
    """Every route of the sharded consensus engine on this rank."""
    import torch

    from distributed_learning_tpu_torch.obs.registry import MetricsRegistry, use_registry
    from distributed_learning_tpu_torch.ops import mixing as ops
    from distributed_learning_tpu_torch.parallel.consensus import (
        ConsensusEngine,
        ring_offset_weights,
    )

    W, W2 = inp["W"], inp["W2"]
    eng = ConsensusEngine(W, mesh=mesh)
    x = eng.shard(_tensors(inp, "x_", bf16=("c",)))
    eps = float(inp["eps"])
    r = {"agent": mesh.agent, "k_hops": ring_offset_weights(W2)[3],
         "route_auto": eng._route_for(W2.astype(np.float32), "auto")[0]}
    r["mix"] = _f32(eng.mix(x, 3))
    for route in ("ring", "allgather", "auto"):
        r[f"mix_with_{route}"] = _f32(eng.mix_with(x, W2, 2, route=route))
    # eps stopping on the float32 buckets (a bfloat16 state floors near 1e-2).
    xf = {k: v for k, v in x.items() if v.dtype == torch.float32}
    s, t, res = eng.mix_until(xf, eps=eps)
    r["mix_until"], r["mix_until_t"], r["mix_until_res"] = _f32(s), t, res
    s, t, res = eng.mix_until_with(xf, W2, eps=eps, route="ring")
    r["mix_until_with"], r["mix_until_with_t"], r["mix_until_with_res"] = _f32(s), t, res
    if "om" in inp.files:
        r["cheby"] = _f32(eng.mix_chebyshev(x, int(inp["om"].shape[0])))
        r["cheby_with"] = _f32(eng.mix_chebyshev(x, W=W2, omegas=inp["om2"], route="ring"))
        r["gavg"] = _f32(eng.global_average(x))
        r["devs"] = eng.deviations(xf).numpy()
        r["maxdev"] = float(eng.max_deviation(xf))
        r["maxstd"] = float(eng.max_std(xf))
        r["run_round"] = _f32(eng.run_round(xf, inp["weights"]))
        r["pairwise"] = _f32(eng.mix_pairwise_matchings(x, inp["draws"]))
        r["pool"] = eng.random_maximal_matchings()
        # The obs hooks: rounds and the bytes this rank sent.
        buffers, layout = ops.flatten_stacked(x)
        reg = MetricsRegistry()
        with use_registry(reg):
            eng.mix_(buffers, 3, layout=layout)
        r["rounds_run"] = reg.counters["consensus.rounds_run"]
        r["bytes_mixed"] = reg.counters["consensus.bytes_mixed"]
        r["bucket_bytes"] = sum(v.numel() * v.element_size() for v in buffers.values())
        r["matched"] = sum(p is not None for p in eng._partners)
        # Control: one matching's message dropped (zeros received) on agent 0.
        orig, state = mesh.exchange, {"dropped": False}

        def dropping(sends, recvs):
            orig(sends, recvs)
            if mesh.agent == 0 and not state["dropped"]:
                for _, t in recvs:
                    t.zero_()
                state["dropped"] = True

        mesh.exchange = dropping
        r["dropped"] = _f32(eng.mix(x, 1))
        mesh.exchange = orig
        r["mix1"] = _f32(eng.mix(x, 1))
    return r


def battery_tracking(mesh, inp):
    """DSGT, EXTRA and push-sum with ``mesh=`` on this rank."""
    import torch

    from distributed_learning_tpu_torch.models import logreg
    from distributed_learning_tpu_torch.parallel import (
        ExtraEngine,
        GradientTrackingEngine,
        PushSumEngine,
    )

    X, y = torch.from_numpy(inp["X"]), torch.from_numpy(inp["y"])
    tau, alpha, steps = float(inp["tau"]), float(inp["alpha"]), int(inp["steps"])

    def grad(w, i, step):
        with torch.enable_grad():
            w = w.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(logreg.loss_fn(w, X[i], y[i], tau).sum(), w)
        return g

    r = {}
    x0 = torch.zeros(mesh.size, X.shape[-1])
    eng = GradientTrackingEngine(inp["W"], grad, learning_rate=alpha, mesh=mesh)
    st, trace = eng.run(eng.init(x0), steps)
    r.update(dsgt_x=st.x.numpy(), dsgt_y=st.y.numpy(), dsgt_g=st.g.numpy(),
             dsgt_trace=trace.numpy(), dsgt_gap=eng.tracker_sum_gap(st))
    for every in (8, 2):
        eng = ExtraEngine(inp["W"], grad, learning_rate=alpha, project_every=every, mesh=mesh)
        st, trace = eng.run(eng.init(x0), steps)
        r.update({f"extra{every}_{f}": getattr(st, f).numpy()
                  for f in ("x", "c", "d", "r", "g_prev")})
        r[f"extra{every}_trace"] = trace.numpy()
    ps = PushSumEngine(inp["P"], mesh=mesh)
    v = ps.shard(torch.from_numpy(inp["v"]))
    r["ps_mix"] = ps.mix(v, int(inp["ps_times"]), weights=inp["ps_w"]).numpy()
    est, t, res = ps.mix_until(v, eps=float(inp["ps_eps"]), weights=inp["ps_w"])
    r.update(ps_until=est.numpy(), ps_t=t, ps_res=res)
    # The totals invariant: sum(x) and sum(w) kept across the ranks.
    num, den = ps.lift(v, inp["ps_w"])
    buf = num["float32"]
    tot0 = mesh.all_reduce(buf.sum(0), "sum")
    den = ps.rounds_(num, den, 7)
    r["ps_num_total"] = float((mesh.all_reduce(buf.sum(0), "sum") - tot0).abs().max())
    r["ps_den_total"] = float(mesh.all_reduce(den.clone(), "sum"))
    return r


def battery_trainer(mesh, inp):
    """``GossipTrainer(mesh=)`` on every route of :data:`ROUTES`, the
    superstep, and the options a mesh rejects."""
    import torch

    from distributed_learning_tpu_torch.models import moe
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import GossipTrainer

    p0 = {k[3:]: inp[k] for k in inp.files if k.startswith("p0_")}
    r = {}

    def trainer(**over):
        t = GossipTrainer(model="mlp", model_kwargs=MLP, weights=Topology.ring(4), mesh=mesh,
                          **trainer_common(**over))
        t.initialize_nodes(params=p0)
        return t

    for name, opts in ROUTES.items():
        t = trainer(**opts)
        pays = [t.train_epoch() for _ in range(2)]
        r[f"{name}_payloads"] = pays
        r[f"{name}_params"] = {k: v.detach().numpy().copy()
                               for k, v in t.model.stacked_parameters().items()}
        r[f"{name}_losses"] = [list(t.network[a].stats.train_loss) for a in NODES]
        r[f"{name}_deviation"] = t.parameter_deviation()
    for name in ("plain", "mix_eps"):
        t = trainer(**ROUTES[name])
        r[f"{name}_superstep"] = t.train_epochs(2)
        r[f"{name}_superstep_params"] = {k: v.detach().numpy().copy()
                                         for k, v in t.model.stacked_parameters().items()}
    raises = {}
    for name, over in (("compression", {"compression": "top_k:0.5"}),
                       ("async_gossip", {"async_gossip": {"staleness_bound": 1}}),
                       ("robust_mixing", {"robust_mixing": "median"})):
        try:
            trainer(**over)
            raises[name] = None
        except ValueError as err:
            raises[name] = str(err)
    for name, fn in (("shard_moe_params", moe.shard_moe_params),
                     ("moe_param_spec", moe.moe_param_spec)):
        try:
            fn(None, mesh)
            raises[name] = None
        except ValueError as err:
            raises[name] = str(err)
    r["raises"] = raises
    return r


def battery_multihost(mesh, inp):
    """The process-group plumbing: the hybrid mesh's order, this process's
    agents, the refusals, and eps-stopped gossip reaching the mean."""
    import torch

    from distributed_learning_tpu_torch.parallel import multihost
    from distributed_learning_tpu_torch.parallel.consensus import (
        ConsensusEngine,
        make_agent_mesh,
    )

    r = {"again": multihost.initialize(), "default_cpu": multihost.default_backend("cpu")}
    hybrid = multihost.hybrid_agent_mesh(device="cpu")
    r.update(ranks=hybrid.ranks, agent=hybrid.agent, shape=hybrid.shape,
             local=multihost.process_local_agents(hybrid))
    refused = {}
    for name, fn in (("no_card", lambda: make_agent_mesh(mesh.size)),
                     ("size", lambda: make_agent_mesh(mesh.size + 1, device="cpu")),
                     ("engine_size", lambda: ConsensusEngine(np.eye(2), mesh=mesh))):
        try:
            fn()
            refused[name] = None
        except (RuntimeError, ValueError) as err:
            refused[name] = f"{type(err).__name__}: {err}"
    r["refused"] = refused
    eng = ConsensusEngine(inp["W"], mesh=hybrid)
    x = eng.shard(torch.from_numpy(inp["x"]))
    out, t, res = eng.mix_until({"x": x}, eps=1e-5, max_rounds=800)
    r.update(mixed=out["x"].numpy(), rounds=t, res=res)
    r["mix_with"] = eng.mix_with({"x": out["x"]}, inp["W2"], 2, route="allgather")["x"].numpy()
    return r


BATTERIES = {"engine": battery_engine, "tracking": battery_tracking,
             "trainer": battery_trainer, "multihost": battery_multihost}


def _main(battery, tmp, coordinator, rank, n):
    import torch

    from distributed_learning_tpu_torch.parallel import multihost
    from distributed_learning_tpu_torch.parallel.consensus import make_agent_mesh

    torch.set_num_threads(1)
    if battery == "multihost":  # the address, size and rank from the environment
        host, port = coordinator.split(":")
        os.environ.update(MASTER_ADDR=host, MASTER_PORT=port, RANK=rank, WORLD_SIZE=n)
        backend = multihost.initialize(device="cpu", timeout_s=60)
    else:
        backend = multihost.initialize(coordinator, int(n), int(rank), device="cpu",
                                       timeout_s=60)
    assert backend == "gloo", backend
    mesh = make_agent_mesh(int(n), device="cpu")
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    out = BATTERIES[battery](mesh, inp)
    out["backend"] = backend
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:])
