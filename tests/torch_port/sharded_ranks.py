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


def one_intra_op_thread():
    """Generator for a module-scoped fixture: torch's CPU work on one
    intra-op thread while the module runs, the count restored after.  A
    worker of a parallel test run otherwise starts as many threads as the
    machine has cores, and six such workers oversubscribe it (the port's
    tests took 2.4x as long that way, 896 s against 375 s at one thread);
    one thread also fixes the CPU GEMMs' summation order."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


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


# name -> the trainer options of one gossip route (on the ring unless
# "weights" says otherwise).
ROUTES = {
    "plain": {},
    "topology_schedule": {"topology_schedule": _er_schedule},
    "chebyshev": {"chebyshev": True, "mix_times": 3},
    "mix_eps": {"mix_eps": 5e-2, "mix_times": 1},
    "global_avg": {"global_avg_every": 2},
    # ROADMAP item 3b: CHOCO, async and robust gossip.
    "choco": {"compression": "topk:0.5"},
    "choco_global_ef": {"compression": "topk:0.3", "compression_budget": "global",
                        "compression_error_feedback": True},
    "async": {"async_gossip": {"staleness_bound": 1, "publish_period": [1, 2, 1, 2]}},
    "clip": {"robust_mixing": {"kind": "clip", "radius": 0.05}},
    "async_trim": {"async_gossip": {"staleness_bound": 1, "publish_period": [1, 1, 1, 2]},
                   "robust_mixing": {"kind": "trim", "trim": 1}, "weights": "complete"},
}
ROUTES_3B = ("choco", "choco_global_ef", "async", "clip", "async_trim")
SUPERSTEP_ROUTES = ("plain", "mix_eps", "choco", "async", "async_trim")


def route_options(name):
    """A route's trainer options with its mixing matrix as ``weights``."""
    from distributed_learning_tpu_torch.parallel import Topology

    opts = dict(ROUTES[name])
    topo = opts.pop("weights", "ring")
    opts["weights"] = Topology.ring(4) if topo == "ring" else Topology.complete(4)
    return opts


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
    """``GossipTrainer(mesh=)`` on every route of :data:`ROUTES` and the
    superstep."""
    from distributed_learning_tpu_torch.parallel import Topology
    from distributed_learning_tpu_torch.training.trainer import GossipTrainer

    p0 = {k[3:]: inp[k] for k in inp.files if k.startswith("p0_")}
    r = {}

    def trainer(weights=None, **over):
        t = GossipTrainer(model="mlp", model_kwargs=MLP,
                          weights=Topology.ring(4) if weights is None else weights, mesh=mesh,
                          **trainer_common(**over))
        t.initialize_nodes(params=p0)
        return t

    for name in ROUTES:
        t = trainer(**route_options(name))
        pays = [t.train_epoch() for _ in range(2)]
        r[f"{name}_payloads"] = pays
        r[f"{name}_params"] = {k: v.detach().numpy().copy()
                               for k, v in t.model.stacked_parameters().items()}
        r[f"{name}_losses"] = [list(t.network[a].stats.train_loss) for a in NODES]
        r[f"{name}_deviation"] = t.parameter_deviation()
        r[f"{name}_masses"] = list(t._robust_masses)
    for name in SUPERSTEP_ROUTES:
        t = trainer(**route_options(name))
        r[f"{name}_superstep"] = t.train_epochs(2)
        r[f"{name}_superstep_params"] = {k: v.detach().numpy().copy()
                                         for k, v in t.model.stacked_parameters().items()}
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


def _mixed_state(n, seed=3):
    """``tests/test_robust.py``'s mixed-dtype state: float32 "w" and
    zero "b" beside a bfloat16 "h" (as float32 numpy; "h" is cast)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 3, 2)).astype(np.float32),
            "b": np.zeros((n, 5), np.float32),
            "h": rng.normal(size=(n, 4)).astype(np.float32)}


# name -> (matrix, kind, knobs) of the sharded async and robust routes.
ASYNC = {"p1212_tau0": ((1, 2, 1, 2), 0), "p1113_tau1": ((1, 1, 1, 3), 1)}
# The robust rounds held against the JAX package, and the neutral knobs,
# held bit for bit against the sharded plain round on the ranks.
ROBUST = {"clip": ("ring", {"kind": "clip", "radius": 1.0}),
          "clip_adaptive": ("ring", {"kind": "clip", "radius": 0.7, "adaptive": True}),
          "trim1": ("complete", {"kind": "trim", "trim": 1})}
NEUTRAL = {"clip_inf": ("ring", {"kind": "clip", "radius": float("inf")}),
           "clip_inf_adaptive": ("ring", {"kind": "clip", "radius": float("inf"),
                                          "adaptive": True}),
           "trim0": ("complete", {"kind": "trim", "trim": 0})}
ASYNC_ROBUST = {"async_clip": ("ring", {"kind": "clip", "radius": 1.0}),
                "async_trim": ("complete", {"kind": "trim", "trim": 1})}
ASYNC_ROBUST_KNOBS = ((1, 2, 1, 3), 2)


def _matrix(name, n=4):
    from distributed_learning_tpu_torch.parallel import Topology

    topo = Topology.ring(n) if name == "ring" else Topology.complete(n)
    return topo.metropolis_weights()


def battery_async_robust(mesh, inp):
    """The sharded async, robust and async-robust rounds on the mixed
    state: every route's mixed row, carry and total mass."""
    import torch

    from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine

    x0 = _tensors(inp, "x_", bf16=("h",))
    r = {}

    def row(t):
        return {k: v.to(torch.float32).numpy() for k, v in t.items()}

    engines = {m: ConsensusEngine(_matrix(m), mesh=mesh) for m in ("ring", "complete")}
    plain = {m: eng.mix(eng.shard(x0), 1) for m, eng in engines.items()}
    ring = engines["ring"]
    for name, (periods, tau) in ASYNC.items():
        out, st = ring.mix_async(ring.shard(x0), tau=tau, periods=periods, times=3)
        out2, st2 = ring.mix_async(out, st, tau=tau, periods=periods, times=2)
        r[f"{name}_x"], r[f"{name}_x2"], r[f"{name}_pub"] = row(out), row(out2), row(st2.pub)
        r[f"{name}_age"], r[f"{name}_rnd"] = st2.age.numpy(), int(st2.rnd)
    # One round on the mixed state, three on its float32 leaves (a clip's
    # scale reads every bucket, so an ulp of the bfloat16 one would reach
    # the float32 leaves in the next round).
    x32 = {k: v for k, v in x0.items() if k != "h"}
    for name, (m, spec) in ROBUST.items():
        eng = engines[m]
        for tag, x, times in (("1", x0, 1), ("3", x32, 3)):
            out, mass = eng.mix_robust(eng.shard(x), spec, times=times)
            r[f"{name}_x{tag}"], r[f"{name}_mass{tag}"] = row(out), float(mass)
        r[f"{name}_is_plain"] = all(torch.equal(out[k], plain[m][k]) for k in out)
    for name, (m, spec) in NEUTRAL.items():
        out, mass = engines[m].mix_robust(engines[m].shard(x0), spec, times=1)
        r[f"{name}_is_plain"] = all(torch.equal(out[k], plain[m][k]) for k in out)
        r[f"{name}_mass1"] = float(mass)
    periods, tau = ASYNC_ROBUST_KNOBS
    for name, (m, spec) in ASYNC_ROBUST.items():
        eng = engines[m]
        for tag, x, times in (("1", x0, 1), ("3", x32, 3)):
            out, st, mass = eng.mix_async_robust(eng.shard(x), spec=spec, tau=tau,
                                                 periods=periods, times=times)
            r[f"{name}_x{tag}"], r[f"{name}_mass{tag}"] = row(out), float(mass)
            r[f"{name}_pub{tag}"] = row(st.pub)
    # Neutral knobs: the async-robust route at radius inf is mix_async.
    out, _ = ring.mix_async(ring.shard(x0), tau=tau, periods=periods, times=3)
    neutral, _, m0 = ring.mix_async_robust(ring.shard(x0), spec="clip", tau=tau,
                                           periods=periods, times=3)
    r["async_neutral_bitwise"] = all(torch.equal(out[k], neutral[k]) for k in out)
    r["async_neutral_mass"] = float(m0)
    return r


CHOCO = {"topk_perleaf": dict(spec="topk:0.3"),
         "topk_global_ef": dict(spec="topk:0.2", budget="global", error_feedback=True,
                                gamma=0.05),
         "topk_perleaf_oracle": dict(spec="topk:0.3", fused=False),
         "randk_perleaf": dict(spec="randk:0.3"),
         "randk_global_ef": dict(spec="randk:0.3", budget="global", error_feedback=True)}
CHOCO_ROUNDS = 6


def battery_choco(mesh, inp):
    """``ChocoGossipEngine(mesh=)``: every configuration's run (state,
    estimates, error-feedback bank, residual trace), the bytes this rank
    counts, and random-k's kept sets drawn on the rank."""
    import torch

    from distributed_learning_tpu_torch.obs.registry import MetricsRegistry, use_registry
    from distributed_learning_tpu_torch.ops import mixing as ops
    from distributed_learning_tpu_torch.parallel import compression as tc

    x0 = _tensors(inp, "x_")
    W = _matrix("ring")
    r = {}
    for name, cfg in CHOCO.items():
        cfg = dict(cfg)
        spec = cfg.pop("spec")
        eng = tc.ChocoGossipEngine(W, tc.compressor_from_spec(spec), gamma=cfg.pop("gamma", 0.2),
                                   mesh=mesh, **cfg)
        reg = MetricsRegistry()
        with use_registry(reg):
            st, trace = eng.run(eng.init(x0, seed=3), CHOCO_ROUNDS)
        for field in ("x", "xhat") + (("ef",) if st.ef is not None else ()):
            r[f"{name}_{field}"] = {k: v.numpy() for k, v in getattr(st, field).items()}
        r[f"{name}_trace"] = trace.numpy()
        r[f"{name}_maxdev"] = eng.max_deviation(st)
        r[f"{name}_bytes"] = reg.counters.get("consensus.compressed_bytes")
    # Random-k's kept sets for this agent, from a generator every rank seeds alike.
    buffers, layout = ops.flatten_stacked({k: v[mesh.agent:mesh.agent + 1] + 10.0
                                           for k, v in x0.items()})
    for budget in ("per-leaf", "global"):
        fc = tc.FusedCompressor(tc.random_k(0.4), budget=budget)
        q = fc.compress(buffers, layout, torch.Generator().manual_seed(5), n=mesh.size,
                        agent=mesh.agent)
        r[f"kept_{budget}"] = (q["float32"] != 0).numpy()
        # top-k's compressed values on this rank's row.
        q = tc.FusedCompressor(tc.top_k(0.3), budget=budget).compress(
            buffers, layout, None, n=mesh.size, agent=mesh.agent)
        r[f"topk_{budget}"] = q["float32"].numpy()
    return r


def battery_ring(mesh, inp):
    """``make_ring_attention`` for every strategy, causal and not: the
    global output and the gradients of ``sum(out * cot)``."""
    import torch

    from distributed_learning_tpu_torch.ops.ring_attention import make_ring_attention

    q, k, v, cot = (torch.from_numpy(inp[n]) for n in ("q", "k", "v", "cot"))
    r = {}
    for strategy in ("ring", "ulysses", "ring_flash"):
        for causal in (True, False):
            fn = make_ring_attention(mesh, strategy=strategy, causal=causal)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            out = fn(*leaves)
            (out * cot).sum().backward()
            tag = f"{strategy}_{'causal' if causal else 'full'}"
            r[f"{tag}_out"] = out.detach().numpy()
            for name, t in zip("qkv", leaves):
                r[f"{tag}_d{name}"] = t.grad.numpy()
    # The controls: a wrong source index, and a skipped rotation.
    from distributed_learning_tpu_torch.ops import ring_attention as ra

    orig = ra._blocks

    def wrong_src(mesh_, k_, v_):
        return [(kb, vb, (s + 1) % mesh_.size if i == 1 else s)
                for i, (kb, vb, s) in enumerate(orig(mesh_, k_, v_))]

    def skipped(mesh_, k_, v_):
        out = orig(mesh_, k_, v_)
        return [out[0], (out[0][0], out[0][1], out[1][2])] + out[2:]

    for name, fake in (("wrong_src", wrong_src), ("skipped_rotation", skipped)):
        ra._blocks = fake
        try:
            with torch.no_grad():
                r[f"control_{name}"] = make_ring_attention(mesh, strategy="ring_flash")(
                    q, k, v).numpy()
        finally:
            ra._blocks = orig
    return r


SPMD_LM = dict(vocab_size=16, num_layers=2, num_heads=2, head_dim=8, max_len=16)
SPMD_STEPS = 2


def battery_spmd_lm(mesh, inp):
    """``make_gossip_lm_step`` on the 4 ranks regrouped as agents 2 x seq
    2: each sequence-parallel attention, ``SPMD_STEPS`` steps from the
    given init; the losses and this rank's replica after them."""
    from distributed_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.spmd_lm import (
        make_gossip_lm_step,
        stack_agent_states,
    )
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    import torch

    grid = GridMesh({"agents": 2, "seq": 2}, "cpu")
    a, s = grid.coords["agents"], grid.coords["seq"]
    X, Y = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    t = X.shape[-1] // 2
    p0 = {k[3:]: inp[k] for k in inp.files if k.startswith("p0_")}
    r = {"coords": (a, s)}
    for impl in ("ring", "ring_flash", "ulysses"):
        model = TransformerLM(**SPMD_LM, attn_impl=impl, mesh=grid, device="cpu")
        opt = stack_agent_states(model, make_optimizer("adam", None, 3e-3), params=p0, agent=a)
        step = make_gossip_lm_step(grid, model, opt)
        r[f"{impl}_losses"] = [float(step(X[a][:, s * t:(s + 1) * t], Y[a][:, s * t:(s + 1) * t]))
                               for _ in range(SPMD_STEPS)]
        r[f"{impl}_params"] = {k: v.detach().numpy().copy()
                               for k, v in model.stacked_parameters().items()}
    return r


# ROADMAP item 5a: tensor parallelism, FSDP, gossip x FSDP / TP, experts.
PAR_LM = dict(vocab_size=32, num_layers=1, num_heads=4, head_dim=8, max_len=16)
PAR_KV = {"mha": None, "gqa": 2, "mqa": 1}
PAR_MOE = dict(mlp="moe", num_experts=4, moe_top_k=2)
# SGD in these oracles: the steps take any optimizer factory (the port's
# Adam is held to optax in test_torch_adam.py), and the JAX side's Adam
# steps cost 2-3x SGD's to compile, the bulk of the module's time.
PAR_STEPS, PAR_LR, PAR_AUX = 2, 0.1, 0.01
PAR_PROMPT, PAR_GEN_STEPS = 8, 6
PAR_SAMPLING = dict(temperature=0.7, top_k=8, top_p=0.9)
PAR_W = [[0.75, 0.25], [0.25, 0.75]]


def battery_tp_fsdp(mesh, inp):
    """The model-parallel routes on the 4 ranks regrouped: the TP step and
    TP decode on (data 2, model 2) for MHA, GQA and MQA; FSDP on data 4
    (dense and MoE); gossip x FSDP on (agents 2, data 2) and gossip x TP
    on (agents 2, model 2); the expert-parallel MoE LM on (data 2, expert
    2).  Each from the given full init, converted to this rank's blocks."""
    import torch

    from distributed_learning_tpu_torch.convert import flax_to_torch_shards, torch_to_flax
    from distributed_learning_tpu_torch.models.transformer import TransformerLM, generate
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.fsdp import make_fsdp_train_step
    from distributed_learning_tpu_torch.training.gossip_fsdp import (
        make_gossip_fsdp_step,
        make_gossip_tp_step,
    )
    from distributed_learning_tpu_torch.training.tp import (
        constrain_decode_cache,
        make_tp_generate,
        make_tp_train_step,
    )
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    X, Y, prompt = (torch.from_numpy(inp[k]) for k in ("x", "y", "prompt"))
    GX, GY = torch.from_numpy(inp["gx"]), torch.from_numpy(inp["gy"])
    sgd = make_optimizer("sgd", None, PAR_LR)
    r = {}

    def full(prefix):
        return {k: v.numpy() for k, v in _tensors(inp, prefix).items()}

    def params(model):
        return {k: v.detach().numpy().copy() for k, v in model.stacked_parameters().items()}

    grid = GridMesh({"data": 2, "model": 2}, "cpu")
    r["tp_coords"] = dict(grid.coords)
    for kind, kv in PAR_KV.items():
        whole = full(f"tp_{kind}_")
        cfg = dict(PAR_LM, num_kv_heads=kv)

        def sharded():
            m = TransformerLM(**cfg, tp_axis="model", mesh=grid, device="cpu")
            m.load_stacked(flax_to_torch_shards(torch_to_flax(whole), grid, "tp"))
            return m

        m = sharded()
        step = make_tp_train_step(grid, m, sgd, moe_aux_coef=PAR_AUX)
        r[f"tp_{kind}_losses"] = [float(step(X, Y)) for _ in range(PAR_STEPS)]
        r[f"tp_{kind}_params"] = params(m)
        r[f"tp_{kind}_partial"] = list(m.tp_partial_grads)
        g = sharded()
        gen = make_tp_generate(grid, g)
        r[f"gen_{kind}"] = gen(prompt, PAR_GEN_STEPS).numpy()
        one = TransformerLM(**cfg, device="cpu")
        one.load_stacked(whole)
        got = gen(prompt, PAR_GEN_STEPS, key=torch.Generator().manual_seed(42), **PAR_SAMPLING)
        want = generate(one, prompt[None], PAR_GEN_STEPS, key=torch.Generator().manual_seed(42),
                        **PAR_SAMPLING)[0]
        r[f"sampled_{kind}"] = (got.numpy(), want.numpy())
        b = prompt.shape[0] // grid.shape["data"]
        r[f"cache_{kind}"] = [tuple(t.shape) for t in g.init_cache(b).keys + g.init_cache(b).values]
        whole_cache = one.init_cache(prompt.shape[0])
        r[f"constrained_{kind}"] = [tuple(t.shape) for t in
                                    constrain_decode_cache(whole_cache, grid).keys]
    grid4 = GridMesh({"data": 4}, "cpu")
    for kind, extra in (("dense", {}), ("moe", PAR_MOE)):
        whole = full(f"fsdp_{kind}_")
        m = TransformerLM(**PAR_LM, **extra, device="cpu")
        m.load_stacked(whole)
        step = make_fsdp_train_step(grid4, m, sgd, moe_aux_coef=PAR_AUX)
        gathered = step.gather_params()
        r[f"fsdp_{kind}_gathered_bitwise"] = all(
            np.array_equal(gathered[k].numpy()[0], v) for k, v in whole.items())
        r[f"fsdp_{kind}_losses"] = [float(step(X, Y)) for _ in range(PAR_STEPS)]
        r[f"fsdp_{kind}_params"] = {k: v.numpy().copy() for k, v in step.local_params().items()}
    stacked = full("gossip_")
    for kind, shape in (("fsdp", {"agents": 2, "data": 2}), ("tp", {"agents": 2, "model": 2})):
        g2 = GridMesh(shape, "cpu")
        a = g2.coords["agents"]
        if kind == "fsdp":
            m = TransformerLM(**PAR_LM, device="cpu")
            m.load_stacked({k: v[a:a + 1] for k, v in stacked.items()})
            step = make_gossip_fsdp_step(g2, m, sgd, PAR_W, moe_aux_coef=PAR_AUX)
        else:
            m = TransformerLM(**PAR_LM, tp_axis="model", mesh=g2, device="cpu")
            m.load_stacked(flax_to_torch_shards(torch_to_flax(stacked), g2, "tp", n_agents=2))
            step = make_gossip_tp_step(g2, m, sgd, PAR_W, moe_aux_coef=PAR_AUX)
        r[f"gossip_{kind}_coords"] = dict(g2.coords)
        r[f"gossip_{kind}_losses"] = [float(step(GX, GY)) for _ in range(PAR_STEPS)]
        r[f"gossip_{kind}_params"] = ({k: v.numpy().copy()
                                       for k, v in step.inner.local_params().items()}
                                      if kind == "fsdp" else params(m))
    g3 = GridMesh({"data": 2, "expert": 2}, "cpu")
    whole = full("ep_")
    m = TransformerLM(**PAR_LM, **PAR_MOE, moe_expert_axis="expert", mesh=g3, device="cpu")
    m.load_stacked(flax_to_torch_shards(torch_to_flax(whole), g3, "ep"))
    step = make_tp_train_step(g3, m, sgd, model_axis="expert", moe_aux_coef=PAR_AUX)
    b = X.shape[0] // 2
    with torch.no_grad():
        rows = X[g3.coords["data"] * b:(g3.coords["data"] + 1) * b]
        r["ep_logits"] = m(rows[None])[0].numpy()
    r["ep_coords"] = dict(g3.coords)
    r["ep_loss"] = float(step(X, Y))
    r["ep_grads"] = {k: v.grad.numpy().copy() for k, v in m.stacked_parameters().items()}
    r.update(_expert_layer_errors(g3["expert"]))
    return r


def _expert_layer_errors(ep):
    """A lone ``MoEMLP(expert_mesh=ep)`` holding its rank's experts of a
    whole layer against that layer, both routes (capacity dispatch and
    decode's drop-free path): the largest differences of the output, the
    gate's gradient and this rank's experts' gradients."""
    import torch

    from distributed_learning_tpu_torch.models.moe import MoEMLP, shard_moe_params

    g = torch.Generator().manual_seed(3)
    whole = MoEMLP(1, 8, 4, 4, 1.25, 2, device="cpu")
    with torch.no_grad():
        for p in whole.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    x = torch.randn(1, 2, 8, 8, generator=g)
    cot = torch.randn(1, 2, 8, 8, generator=g)
    mine = MoEMLP(1, 8, 4, 4, 1.25, 2, device="cpu", expert_mesh=ep)
    blocks = shard_moe_params({k: v.detach()[0] for k, v in whole.named_parameters()}, ep,
                              ep.axis_name)
    with torch.no_grad():
        for k, v in mine.named_parameters():
            v.copy_(blocks[k][None])
    out = {}
    for route, drop in (("dispatch", True), ("dropfree", False)):
        errs = {}
        for layer in (whole, mine):
            layer.zero_grad()
        y_whole, y_mine = whole(x, drop), mine(x, drop)
        (y_whole * cot).sum().backward()
        (y_mine * cot).sum().backward()
        errs["out"] = float((y_whole - y_mine).abs().max())
        wgrads = shard_moe_params({k: v.grad[0] for k, v in whole.named_parameters()}, ep,
                                  ep.axis_name)
        errs.update({k: float((wgrads[k] - v.grad[0]).abs().max())
                     for k, v in mine.named_parameters()})
        out[f"ep_layer_{route}"] = errs
    return out


# ROADMAP items 5b / 5c: the pipeline (training/pp*.py).
PP_S, PP_L, PP_D, PP_MB = 4, 2, 16, 4   # the generic tanh stack: stages x layers, width
PP_V, PP_VD = 2, 8                       # interleaved chunks, their width


def pp_stack_fn(p, act):
    """The reference tests' stage: ``tanh(act @ W + b)`` over its layers."""
    import torch

    for W, b in zip(p["W"], p["b"]):
        act = torch.tanh(act @ W + b)
    return act


def pp_chunk_fn(p, act):
    import torch

    return torch.tanh(act @ p["W"] + p["b"])


def pp_mse(out, y):
    return ((out - y) ** 2).mean()


def battery_pp(mesh, inp):
    """The generic executors on stage 4 (GPipe apply with its gradient,
    with and without ``remat_stage``; 1F1B for M 3 and 12; interleaved
    (S 4, V 2, M 6)), interleaved on data 2 x stage 2 (V 2, M 4), the
    two controls (every stage seeding from the head; an input filed one
    stash slot off) and the refusal of a wrong microbatch count."""
    import torch

    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training import pp, pp_interleaved as ppi

    t = {k: torch.from_numpy(inp[k]) for k in inp.files}
    r = {}
    grid = GridMesh({"stage": PP_S}, "cpu")
    params = {"W": t["W"], "b": t["b"]}
    for remat in (False, True):
        apply = pp.make_pipeline_apply(grid, pp_stack_fn, remat_stage=remat)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        x = t["x"].clone().requires_grad_(True)
        out = apply(p, x)
        (out * t["co"]).sum().backward()
        r[f"gpipe_{remat}"] = {"out": out.detach().numpy(), "dx": x.grad.numpy(),
                               **{f"g_{k}": v.grad.numpy() for k, v in p.items()},
                               "stats": dict(apply.stats)}
    step = pp.make_1f1b_train_step(grid, pp_stack_fn, pp_mse)
    for m in (3, 12):
        grads, loss = step(params, t[f"x{m}"], t[f"y{m}"])
        r[f"1f1b_{m}"] = {"loss": float(loss), "stats": dict(step.stats),
                          **{f"g_{k}": v.numpy() for k, v in grads.items()}}
    real_head, real_put = pp._is_head_stage, pp._Stash.put
    for tag in ("head_every_stage", "slot_off"):
        if tag == "head_every_stage":
            pp._is_head_stage = lambda v, n: True
        else:
            pp._Stash.put = lambda self, m, a: real_put(self, m + 1, a)
        try:
            grads, loss = step(params, t["x12"], t["y12"])
        finally:
            pp._is_head_stage, pp._Stash.put = real_head, real_put
        r[f"control_{tag}"] = {"loss": float(loss), **{f"g_{k}": v.numpy()
                                                        for k, v in grads.items()}}
    cparams = {"W": t["cW"], "b": t["cb"]}
    istep = ppi.make_interleaved_1f1b_train_step(grid, pp_chunk_fn, pp_mse, n_chunks=PP_V,
                                                 n_microbatches=6)
    grads, loss = istep(cparams, t["cx6"], t["cy6"])
    r["inter_4"] = {"loss": float(loss), **{f"g_{k}": v.numpy() for k, v in grads.items()}}
    try:
        istep(cparams, t["cx4"], t["cy4"])
    except ValueError as e:
        r["refused_microbatch_count"] = str(e)
    g2 = GridMesh({"data": 2, "stage": 2}, "cpu")
    dparams = {"W": t["dW"], "b": t["db"]}
    istep = ppi.make_interleaved_1f1b_train_step(g2, pp_chunk_fn, pp_mse, n_chunks=PP_V,
                                                 n_microbatches=4)
    grads, loss = istep(dparams, t["cx4"], t["cy4"])
    r["inter_dp"] = {"loss": float(loss), "coords": dict(g2.coords),
                     **{f"g_{k}": v.numpy() for k, v in grads.items()}}
    r["coords"] = dict(grid.coords)
    return r


PP_LM = dict(vocab_size=32, head_dim=8, max_len=8, mlp_ratio=2)
PP_LM_M, PP_LM_MB, PP_LM_T, PP_COEF = 3, 2, 8, 0.5
# name -> (model configuration with its seed).
PP_CONFIGS = {
    "dense": dict(num_layers=4, num_heads=2, seed=0),
    "rope": dict(num_layers=4, num_heads=2, pos_emb="rope", seed=1),
    "deep": dict(num_layers=8, num_heads=2, seed=2),
    "gqa": dict(num_layers=4, num_heads=4, num_kv_heads=2, seed=3),
    "moe": dict(num_layers=4, num_heads=2, mlp="moe", num_experts=4, seed=4),
}
# (case, grid shape, configuration, schedule, model options, step options).
PP_LM_CASES = [
    ("gpipe", {"stage": 4}, "dense", "gpipe", {}, {}),
    ("gpipe_remat", {"stage": 4}, "dense", "remat", {}, {}),
    ("gpipe_rope", {"stage": 4}, "rope", "gpipe", {}, {}),
    ("1f1b", {"stage": 4}, "dense", "1f1b", {}, {}),
    ("1f1b_rope", {"stage": 4}, "rope", "1f1b", {}, {}),
    ("inter", {"stage": 4}, "deep", "inter", {}, {}),
    ("gpipe_moe", {"stage": 4}, "moe", "gpipe", {}, {"moe_aux_coef": PP_COEF}),
    ("1f1b_moe", {"stage": 4}, "moe", "1f1b", {}, {"moe_aux_coef": PP_COEF}),
    ("inter_moe", {"stage": 2, "data": 2}, "moe", "inter", {}, {"moe_aux_coef": PP_COEF}),
    ("gpipe_tp", {"stage": 2, "model": 2}, "dense", "gpipe", {"tp_axis": "model"},
     {"tp_axis": "model"}),
    ("1f1b_tp_gqa", {"stage": 2, "model": 2}, "gqa", "1f1b", {"tp_axis": "model"},
     {"tp_axis": "model"}),
    ("inter_tp", {"stage": 2, "model": 2}, "dense", "inter", {"tp_axis": "model"},
     {"tp_axis": "model"}),
    ("gpipe_ring", {"stage": 2, "seq": 2}, "dense", "gpipe", {"attn_impl": "ring"}, {}),
    ("1f1b_ring_flash", {"stage": 2, "seq": 2}, "rope", "1f1b", {"attn_impl": "ring_flash"}, {}),
    ("inter_ulysses", {"stage": 2, "seq": 2}, "dense", "inter", {"attn_impl": "ulysses"}, {}),
    ("1f1b_ep", {"stage": 2, "expert": 2}, "moe", "1f1b", {"moe_expert_axis": "expert"},
     {"moe_aux_coef": PP_COEF, "expert_axis": "expert"}),
    ("inter_ep", {"stage": 2, "expert": 2}, "moe", "inter", {"moe_expert_axis": "expert"},
     {"moe_aux_coef": PP_COEF, "expert_axis": "expert"}),
    ("1f1b_dp", {"data": 2, "stage": 2}, "dense", "1f1b", {}, {}),
    ("gpipe_dp", {"data": 2, "stage": 2}, "dense", "gpipe", {}, {}),
]


def pp_lm_model(config, grid=None, **over):
    """A CPU ``TransformerLM`` of configuration ``config`` (its seed
    included) with ``over`` applied, on ``grid`` when an option names an
    axis of it."""
    from distributed_learning_tpu_torch.models.transformer import TransformerLM

    kw = dict(PP_LM, **PP_CONFIGS[config])
    kw.update(over)
    seed = kw.pop("seed")
    on_mesh = any(k in over for k in ("tp_axis", "moe_expert_axis")) or \
        over.get("attn_impl") in ("ring", "ring_flash", "ulysses")
    return TransformerLM(**kw, mesh=grid if on_mesh else None, device="cpu", seed=seed)


def pp_lm_step(schedule, grid, model, tx, n_microbatches=PP_LM_M, **kw):
    from distributed_learning_tpu_torch.training import pp_lm

    if schedule in ("gpipe", "remat"):
        return pp_lm.make_lm_pipeline_train_step(grid, model, tx, remat_stage=schedule == "remat",
                                                 **kw)
    if schedule == "1f1b":
        return pp_lm.make_lm_1f1b_train_step(grid, model, tx, **kw)
    return pp_lm.make_lm_interleaved_train_step(grid, model, tx, PP_V, n_microbatches, **kw)


def _refusal(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def battery_pp_lm(mesh, inp):
    """Every ``PP_LM_CASES`` step (one SGD step at lr 1 from the seed's
    init): the loss, this rank's parameters after it (and at init for two
    cases), the stash or graph counts; then the builders' refusals."""
    import torch

    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    tok, y = torch.from_numpy(inp["tok"]), torch.from_numpy(inp["y"])
    sgd = make_optimizer("sgd", None, 1.0)
    r, grids = {}, {}
    for name, shape, config, schedule, mkw, skw in PP_LM_CASES:
        key = tuple(shape.items())
        if key not in grids:
            grids[key] = GridMesh(shape, "cpu")
        grid = grids[key]
        step = pp_lm_step(schedule, grid, pp_lm_model(config, grid, **mkw), sgd, **skw)
        init = {k: v.detach().numpy().copy() for k, v in step.local_params().items()}
        loss = float(step(tok, y))
        r[name] = {"loss": loss, "coords": dict(grid.coords), "stats": dict(step.stats),
                   "layers": step.layers,
                   "params": {k: v.detach().numpy().copy()
                              for k, v in step.local_params().items()}}
        if name in ("gpipe", "1f1b_tp_gqa", "inter"):
            r[name]["init"] = init
        if name in ("1f1b_tp_gqa", "inter_tp", "1f1b_ep"):
            r[name]["specs"] = step.parts.build_param_specs(n_chunks=step.n_chunks)
    g4, g_tp, g_ep = grids[(("stage", 4),)], grids[(("stage", 2), ("model", 2))], \
        grids[(("stage", 2), ("expert", 2))]
    refused = {
        "dropout": lambda: pp_lm_step("gpipe", g4, pp_lm_model("dense", dropout_rate=0.1), sgd),
        "layers": lambda: pp_lm_step("gpipe", g4, pp_lm_model("dense", num_layers=6), sgd),
        "layers_chunks": lambda: pp_lm_step("inter", g4, pp_lm_model("dense"), sgd),
        "seq_axis": lambda: pp_lm_step("1f1b", g4, pp_lm_model("dense", g4["stage"],
                                                               attn_impl="ring"), sgd),
        "tp_moe": lambda: pp_lm_step("gpipe", g_tp, pp_lm_model("moe", g_tp, tp_axis="model"),
                                     sgd, tp_axis="model"),
        "tp_mesh": lambda: pp_lm_step("gpipe", g_tp, pp_lm_model("dense", g_tp, tp_axis="model"),
                                      sgd, tp_axis="nope"),
        "tp_heads": lambda: pp_lm_step("gpipe", g_tp, pp_lm_model("dense", g_tp, num_heads=3,
                                                                  tp_axis="model"),
                                       sgd, tp_axis="model"),
        "tp_mqa": lambda: pp_lm_step("1f1b", g_tp, pp_lm_model("gqa", g_tp, num_kv_heads=1,
                                                               tp_axis="model"),
                                     sgd, tp_axis="model"),
        "tp_unbuilt": lambda: pp_lm_step("gpipe", g_tp, pp_lm_model("dense"), sgd,
                                         tp_axis="model"),
        "ep_dense": lambda: pp_lm_step("gpipe", g_ep, pp_lm_model("dense"), sgd,
                                       expert_axis="expert"),
        "ep_mesh": lambda: pp_lm_step("gpipe", g_ep, pp_lm_model("moe"), sgd,
                                      expert_axis="nope"),
        "microbatches": lambda: pp_lm_step("inter", g_tp, pp_lm_model("dense", g_tp,
                                                                      tp_axis="model"),
                                           sgd, tp_axis="model")(tok[:2], y[:2]),
    }
    r["refused"] = {k: _refusal(fn) for k, fn in refused.items()}
    return r


# dp x pp x sp x tp on 16 ranks (test_pp_lm_4d.py's sizes), and on the
# same ranks dp x pp x tp (the data rows over two axes) and pp x sp x ep.
PP4D_LM = dict(vocab_size=32, num_layers=4, num_heads=4, head_dim=8, max_len=8, mlp_ratio=2)
PP4D_M, PP4D_MB, PP4D_T, PP4D_SEED = 3, 4, 8, 0
PP4D_ADAM_STEPS = 4


def battery_pp_4d(mesh, inp):
    """16 ranks: the 4-D 1F1B step (data 2, stage 2, seq 2, model 2) with
    ring attention and the 3-D one (data 2, stage 2, model 2, a second
    data axis 2) with full attention, one SGD step at lr 1 each; then pp x
    sp x ep (data 2, stage 2, seq 2, expert 2) with Adam, its losses."""
    import torch

    from distributed_learning_tpu_torch.models.transformer import TransformerLM
    from distributed_learning_tpu_torch.parallel.multihost import GridMesh
    from distributed_learning_tpu_torch.training import pp_lm
    from distributed_learning_tpu_torch.training.trainer import make_optimizer

    tok, y = torch.from_numpy(inp["tok"]), torch.from_numpy(inp["y"])
    r = {}
    for name, shape, impl in (("4d", {"data": 2, "stage": 2, "seq": 2, "model": 2}, "ring"),
                              ("3d", {"data": 2, "stage": 2, "model": 2, "rows": 2}, "full")):
        grid = GridMesh(shape, "cpu")
        model = TransformerLM(**PP4D_LM, attn_impl=impl, tp_axis="model", mesh=grid,
                              device="cpu", seed=PP4D_SEED)
        step = pp_lm.make_lm_1f1b_train_step(grid, model, make_optimizer("sgd", None, 1.0),
                                             tp_axis="model")
        r[name] = {"loss": float(step(tok, y)), "coords": dict(grid.coords),
                   "params": {k: v.detach().numpy().copy()
                              for k, v in step.local_params().items()}}
    grid = GridMesh({"data": 2, "stage": 2, "seq": 2, "expert": 2}, "cpu")
    model = TransformerLM(**PP4D_LM, attn_impl="ring", mlp="moe", num_experts=4,
                          moe_expert_axis="expert", mesh=grid, device="cpu", seed=PP4D_SEED)
    step = pp_lm.make_lm_1f1b_train_step(grid, model, make_optimizer("adam", None, 3e-3),
                                         expert_axis="expert", moe_aux_coef=0.01)
    r["sp_ep"] = {"losses": [float(step(tok, y)) for _ in range(PP4D_ADAM_STEPS)],
                  "w_up": tuple(model.get_parameter(f"blocks.{step.layers[0][0]}.moe.w_up").shape)}
    return r


BATTERIES = {"engine": battery_engine, "tracking": battery_tracking,
             "trainer": battery_trainer, "multihost": battery_multihost,
             "async_robust": battery_async_robust, "choco": battery_choco,
             "ring": battery_ring, "spmd_lm": battery_spmd_lm, "tp_fsdp": battery_tp_fsdp,
             "pp": battery_pp, "pp_lm": battery_pp_lm, "pp_4d": battery_pp_4d}


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
