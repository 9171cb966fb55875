"""Pipeline parallelism on a ``stage`` axis of ranks: GPipe and 1F1B
(port of ``distributed_learning_tpu/training/pp.py``).

The model's block stack is cut into ``S`` stages, stage ``s`` held by the
ranks at coordinate ``s`` of the ``stage`` axis of a
:class:`~distributed_learning_tpu_torch.parallel.multihost.GridMesh`, and
microbatches flow stage to stage.  The reference writes one SPMD scan in
which every device runs every tick and a ``lax.ppermute`` rotates the
activations; here each rank runs the ticks of its own stage, and the
reference's one-hop ``ppermute`` is a paired send / receive with the
neighbouring stages on the rank's stage line (:meth:`AgentMesh.exchange`,
one ``batch_isend_irecv`` a tick, every rank posting its side of each
pair in one fixed order).

* :func:`make_pipeline_apply` — GPipe: tick ``t``, stage ``s`` runs
  microbatch ``t - s``; ``M + S - 1`` ticks.  Differentiable: ONE
  ``torch.autograd.Function`` holds the whole pipeline interior, its
  forward keeping each microbatch's stage graph (or only its input under
  ``remat_stage``) and its backward walking the ticks in reverse (receive
  the cotangent from ``s + 1``, backward the stage, send the input
  cotangent to ``s - 1``).  Left to autograd, per-tick exchanges would run
  in whatever order the engine picks on each rank, and the pairs would
  stop matching.
* :func:`make_1f1b_train_step` — one-forward-one-backward: tick ``t``,
  stage ``s`` runs the forward of ``t - s`` and the backward of ``t - (2S
  - 2 - s)``; a circular stash of depth ``min(M, 2S - 1)`` holds stage
  inputs, and each backward recomputes its stage from the stashed input.

Bubble ticks launch nothing: a rank runs its stage only on ticks where
it holds a real microbatch (the reference computes on zeros there and
masks the result).  That is sound because every collective INSIDE a
stage runs over a line that lies within one stage row — ``seq`` for
ring / Ulysses attention, ``model`` for tensor parallelism's exits,
``expert`` for expert parallelism — whose ranks share the stage
coordinate, hence every schedule entry.

The reference's psum "collections" replicate a value that one stage
holds (the last stage's outputs, loss and head gradient, stage 0's input
cotangent): each is a broadcast from its owner on the stage line here.

Other mesh axes.  An axis named in ``extra_manual_axes`` (the sequence
axis) splits the microbatches' token dimension (``microbatch_spec``);
the reference's contract that ``loss_fn`` / ``head_fn`` end reduced over
it becomes, without a partitioner, that they return this shard's SHARE
of the microbatch loss (the shares sum to it over the axis, e.g. the
shard's token mean over the number of shards), and the step sums the
loss and the gradients over the axis.  An axis named in ``param_specs``
(tensor or expert parallelism) is handled inside ``stage_fn``.  Every
other axis is data parallelism (the reference leaves it to the
partitioner): the microbatch rows split over it, and the steps seed
each rank's loss with its ``1/n`` share and sum the gradients over it
with one ``all_reduce`` (their mean).

Parameters.  ``stage_params`` may be given whole, every leaf with the
reference's leading ``S`` axis (the rank takes its block under
``param_specs``), or as this rank's block (leading axis 1).  The
gradients come back as this rank's block; the reference returns the
global array with the same placement.  Microbatches and labels are the
global ``(M, mb, ...)`` arrays on every rank; each rank takes its block.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from distributed_learning_tpu_torch.parallel.multihost import (
    PartitionSpec as P,
    local_shard,
)

__all__ = ["make_pipeline_apply", "make_1f1b_train_step"]


# ---------------------------------------------------------------------- #
# Trees (nested mappings of tensors)                                      #
# ---------------------------------------------------------------------- #
def _leaves(tree, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs of a nested mapping, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _unflatten(paths: Sequence[Tuple[str, ...]], values: Sequence) -> Any:
    """The nested dict with ``values`` at ``paths`` (a bare leaf for the
    empty path)."""
    if len(paths) == 1 and paths[0] == ():
        return values[0]
    out: Dict[str, Any] = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _spec_at(specs, path):
    """The spec of the leaf at ``path`` in a specs tree (``None`` when
    the tree has none)."""
    node = specs
    for k in path:
        if not isinstance(node, dict):
            break
        node = node[k]
    return node


# ---------------------------------------------------------------------- #
# Shared helpers                                                          #
# ---------------------------------------------------------------------- #
def _aux_seed_value(coef: float, n_microbatches: int, n_stages: int,
                    extra_sizes: Sequence[int] = ()) -> float:
    """The constant aux cotangent ``d(loss)/d(aux_{m,s}) = coef / (M * S *
    prod(extra axis sizes))`` — ONE definition of the regularized
    objective's normalisation shared by every schedule executor (this
    module and ``pp_interleaved``), so they cannot drift."""
    return coef / (n_microbatches * n_stages * math.prod(int(n) for n in extra_sizes))


def _check_param_specs(param_specs: Any, stage_axis: str) -> None:
    """Every spec must lead with the stage axis.  A leaf spec that omits
    it would hand each rank the FULL stacked array, so ``a[0]`` picks
    stage 0's parameters on every stage — shapes all match and the
    forward silently computes garbage."""
    for path, spec in _leaves(param_specs):
        if len(spec) == 0 or spec[0] != stage_axis:
            raise ValueError(
                f"param_specs at {'/'.join(path)} is {spec!r}: every spec must put "
                f"{stage_axis!r} on the leading (stacked-stage) dim, or each rank would "
                "silently run stage 0's parameters")


def _spec_axes(param_specs) -> set:
    axes = set()
    if param_specs is not None:
        for _, spec in _leaves(param_specs):
            for entry in spec:
                if entry is None:
                    continue
                axes.update(entry if isinstance(entry, tuple) else (entry,))
    return axes


def _is_head_stage(v: int, n: int) -> bool:
    """Whether virtual stage ``v`` of ``n`` seeds its backward from the
    loss head: the last one alone (every other stage takes the cotangent
    its successor sends)."""
    return v == n - 1


class _Stash:
    """The 1F1B input stash: a circular buffer of ``depth`` stage inputs,
    microbatch ``m`` filed at slot ``m % depth`` (zeros before the first
    fill, as the reference's buffer).  ``peak`` counts the most inputs
    in flight at once (filed, backward not yet run)."""

    def __init__(self, depth: int, like: torch.Tensor):
        self.depth = int(depth)
        zero = torch.zeros_like(like)
        self.slots = [zero] * self.depth
        self.inflight: set = set()
        self.peak = 0

    def put(self, m: int, a: torch.Tensor) -> None:
        self.slots[m % self.depth] = a
        self.inflight.add(m)
        self.peak = max(self.peak, len(self.inflight))

    def get(self, m: int) -> torch.Tensor:
        self.inflight.discard(m)
        return self.slots[m % self.depth]


class _Clock:
    """Seconds of a step's parts on this rank: stage compute (CUDA events
    on a card, so the host's launch queue does not count), the hops, the
    end broadcasts on the stage line and the reductions over the other
    axes (host clock; the transport blocks)."""

    KEYS = ("stage_s", "hops_s", "broadcast_s", "reduce_s")

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.reset()

    def reset(self) -> None:
        self.s = dict.fromkeys(self.KEYS, 0.0)
        self._events: List[tuple] = []

    @contextlib.contextmanager
    def stage(self):
        if self.cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._events.append((a, b))
        else:
            t0 = time.perf_counter()
            yield
            self.s["stage_s"] += time.perf_counter() - t0

    @contextlib.contextmanager
    def host(self, key: str):
        t0 = time.perf_counter()
        yield
        self.s[key] += time.perf_counter() - t0

    def read(self) -> Dict[str, float]:
        if self._events:
            torch.cuda.synchronize()
            self.s["stage_s"] += sum(a.elapsed_time(b) for a, b in self._events) / 1e3
            self._events = []
        return dict(self.s)


class _Plan:
    """A rank's place in the pipeline on ``mesh``: its stage line, the
    lines of the extra (sequence) axes and of the data axes, and the
    transport with its clock."""

    def __init__(self, mesh, stage_axis: str, extra_manual_axes: Sequence[str] = (),
                 spec_axes: Sequence[str] = ()):
        if stage_axis not in mesh.shape:
            raise ValueError(f"stage axis {stage_axis!r} is not on the mesh {tuple(mesh.shape)}")
        self.mesh = mesh
        self.line = mesh[stage_axis]
        self.S, self.s = self.line.size, self.line.agent
        self.extra_axes = tuple(extra_manual_axes)
        manual = {stage_axis, *spec_axes, *self.extra_axes}
        self.data_axes = tuple(a for a in mesh.shape if a not in manual)
        self.extras = [mesh[a] for a in self.extra_axes]
        self.data = [mesh[a] for a in self.data_axes]
        self.n_extra = math.prod(m.size for m in self.extras)
        self.n_data = math.prod(m.size for m in self.data)
        self.device = self.line.device
        self.clock = _Clock(self.device)

    def hop(self, sends, recvs) -> None:
        """One tick's hops on the stage line (``(agent, tensor)`` pairs); on
        a line of one stage the (at most one) message goes to this rank
        itself and is delivered in place."""
        if self.S == 1:
            for (_, dst), (_, src) in zip(recvs, sends):
                dst.copy_(src)
            return
        with self.clock.host("hops_s"):
            self.line.exchange(sends, recvs)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        if self.S == 1:
            return t
        with self.clock.host("broadcast_s"):
            return self.line.broadcast(t, src)

    def stage_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.S == 1:
            return t
        with self.clock.host("broadcast_s"):
            return self.line.all_reduce(t, "sum")

    def reduce(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over the extra axes and the data axes, in place
        (one ``all_reduce`` a line)."""
        with self.clock.host("reduce_s"):
            for line in self.extras + self.data:
                if line.size > 1:
                    line.all_reduce(flat, "sum")
        return flat

    def block(self, t: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """This rank's block of global (M, mb, ...) microbatches: ``spec``
        (over the extra axes) with the rows (dim 1) split over the data
        axes too."""
        ent = list(spec) + [None] * max(0, 2 - len(spec))
        if self.data_axes:
            have = ent[1]
            have = () if have is None else (have if isinstance(have, tuple) else (have,))
            ent[1] = tuple(have) + tuple(a for a in self.data_axes if a not in have)
        return local_shard(t, P(*ent), self.mesh)


def _rank_block(stage_params, specs, plan: _Plan, stage_axis: str, lead: int = 1):
    """``(paths, blocks)``: this rank's block of every leaf (its leading
    stage axis kept, size 1) — the leaf itself when it is already a block."""
    paths, blocks = [], []
    for path, leaf in _leaves(stage_params):
        n = leaf.shape[0]
        spec = _spec_at(specs, path) if specs is not None else None
        if n == plan.S:
            blocks.append(local_shard(leaf, spec if spec is not None else P(stage_axis), plan.mesh))
        elif n == 1:
            blocks.append(leaf)
        else:
            raise ValueError(
                f"stage_params leading axis {n} at {'/'.join(path)} != {plan.S} mesh stages — "
                "a mismatch would silently drop stages after sharding")
        paths.append(path)
    return paths, blocks


class _StageRunner:
    """How a rank runs its stage (or its chunk ``c`` of ``V``): ``forward``
    without a graph, ``recompute`` with one (its backward accumulates the
    parameters' gradients), each returning ``(out, aux)`` (aux ``None``
    without ``stage_aux``)."""

    def __init__(self, fn: Callable, aux: bool):
        self.fn, self.aux = fn, aux

    def _call(self, c, a):
        res = self.fn(c, a)
        if self.aux:
            out, aux = res
            return out, aux
        return res, None

    def forward(self, c: int, a: torch.Tensor):
        with torch.no_grad():
            return self._call(c, a)

    def recompute(self, c: int, a: torch.Tensor):
        leaf = a.detach().requires_grad_(a.is_floating_point())
        with torch.enable_grad():
            out, aux = self._call(c, leaf)
        return leaf, out, aux


def _backward(leaf, out, aux, cot, aux_ct) -> torch.Tensor:
    """Backpropagate ``cot`` (and the aux's ``aux_ct``) through one stage
    graph; the cotangent of its input (zeros when it has none)."""
    outs, cots = [out], [cot.to(out.dtype)]
    if aux is not None:
        outs.append(aux)
        cots.append(torch.full_like(aux, float(aux_ct)))
    torch.autograd.backward(outs, cots)
    return leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)


def head_seed(head_fn: Callable, head_params: Any, out: torch.Tensor, y: torch.Tensor,
              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Loss-head forward + backward for one microbatch, shared by the plain
    and the interleaved 1F1B executors: returns ``(loss, seed)``, the
    head's float32 loss and the cotangent of ``out`` that seeds the
    stage's backward, the head's parameter gradients (``scale`` times
    the loss's) accumulated into ``head_params``' ``.grad``.  Only the
    stage that really is the last one calls it (:func:`_is_head_stage`),
    so only it pays the head's FLOPs and only its head gradient counts:
    the steps broadcast that one from the last stage, never a sum over
    stages (the reference's vma trap, ``pp.py:100-127``)."""
    o = out.detach().requires_grad_(True)
    with torch.enable_grad():
        lval = head_fn(head_params, o, y)
    torch.autograd.backward(lval, torch.full_like(lval, scale))
    return lval.detach().to(torch.float32), o.grad


def _run_1f1b(plan: _Plan, runner: _StageRunner, inputs: torch.Tensor, labels, M: int,
              head: Callable, scale: float, aux_seed: float, collect: bool) -> dict:
    """One rank's 1F1B ticks.  ``inputs`` (M, ...) feed stage 0, ``head(out,
    y) -> (loss, seed)`` seeds the last stage.  Returns the rank's
    accumulated loss (``scale`` times the microbatch losses, last stage),
    stage-aux sum, stash and (stage 0, ``collect``) input cotangents."""
    S, s = plan.S, plan.s
    depth = min(M, 2 * S - 1)  # max in flight per stage is 2(S-1)+1
    stash = _Stash(depth, inputs[0])
    like = inputs[0]
    lacc = torch.zeros((), dtype=torch.float32, device=like.device)
    aacc = torch.zeros((), dtype=torch.float32, device=like.device)
    d_in: List[Optional[torch.Tensor]] = [None] * M if collect else []
    fwd_in = bwd_in = None
    for t in range(M + 2 * S - 2):
        mf, mb = t - s, t - (2 * S - 2 - s)
        send_f = send_b = None
        if 0 <= mf < M:
            a = inputs[mf] if s == 0 else fwd_in
            stash.put(mf, a)
            with plan.clock.stage():
                out, _ = runner.forward(0, a)  # the aux is banked on the recompute
            if s < S - 1:
                send_f = out
        if 0 <= mb < M:
            with plan.clock.stage():
                leaf, out, aux = runner.recompute(0, stash.get(mb))
                if _is_head_stage(s, S):
                    lval, cot = head(out, labels[mb])
                    lacc += lval * scale
                else:
                    cot = bwd_in
                if aux is not None:
                    aacc += aux.detach().to(torch.float32)
                dact = _backward(leaf, out, aux, cot, aux_seed)
            if s > 0:
                send_b = dact
            elif collect:
                d_in[mb] = dact
        sends, recvs = [], []
        if send_f is not None:
            sends.append((s + 1, send_f))
        if send_b is not None:
            sends.append((s - 1, send_b))
        fwd_in = bwd_in = None
        if s > 0 and 0 <= t - (s - 1) < M:
            fwd_in = torch.empty_like(like)
            recvs.append((s - 1, fwd_in))
        if s < S - 1 and 0 <= t - (2 * S - 2 - (s + 1)) < M:
            bwd_in = torch.empty_like(like)
            recvs.append((s + 1, bwd_in))
        plan.hop(sends, recvs)
    return {"loss": lacc, "aux": aacc, "stash": stash, "d_in": d_in}


def _flat(ts: Sequence[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    dtype = torch.float64 if any(t.dtype == torch.float64 for t in ts) else torch.float32
    if not ts:
        return torch.zeros(0, dtype=dtype, device=like.device)
    return torch.cat([t.reshape(-1).to(dtype) for t in ts])


def _unflat(flat: torch.Tensor, likes: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, off = [], 0
    for t in likes:
        n = t.numel()
        out.append(flat[off:off + n].view(t.shape).to(t.dtype))
        off += n
    return out


def _finish_step(plan: _Plan, grads: List[torch.Tensor], head_grads: List[torch.Tensor],
                 res: dict, aux_coef: Optional[float], n_virtual: int, M: int,
                 collect: bool, like: torch.Tensor) -> tuple:
    """The end of a 1F1B-family step: the last stage's loss and head
    gradient broadcast over the stage line, the stage-aux total (a real
    sum over stages), stage 0's input cotangents broadcast, then the loss
    and every gradient summed over the extra and data axes."""
    S = plan.S
    head = _flat([res["loss"].view(1)] + list(head_grads), like)
    plan.broadcast(head, S - 1)
    tail = [head]
    if aux_coef is not None:
        aux = plan.stage_sum(res["aux"].view(1).clone())
        tail.append(aux * aux_coef / (n_virtual * M * plan.n_extra * plan.n_data))
    flat = _flat(list(grads) + tail, like)
    if plan.extras or plan.data:
        plan.reduce(flat)
    ng = sum(g.numel() for g in grads)
    g_out = _unflat(flat[:ng], grads)
    loss = flat[ng]
    h_out = _unflat(flat[ng + 1: ng + 1 + sum(h.numel() for h in head_grads)], head_grads)
    if aux_coef is not None:
        loss = loss + flat[-1]
    d_mbs = None
    if collect:
        d_mbs = torch.stack(res["d_in"]) if plan.s == 0 else \
            torch.empty((M,) + tuple(like.shape), dtype=like.dtype, device=like.device)
        plan.broadcast(d_mbs, 0)
    return g_out, h_out, d_mbs, loss.to(torch.float32)


# ---------------------------------------------------------------------- #
# GPipe                                                                   #
# ---------------------------------------------------------------------- #
class _GPipe(torch.autograd.Function):
    """The whole GPipe interior on one rank: forward over the ticks,
    outputs broadcast from the last stage; backward over the ticks in
    reverse, the input cotangent broadcast from stage 0 (see the module
    docstring for why this is one Function)."""

    @staticmethod
    def forward(ctx, pipe, x, *leaves):
        plan: _Plan = pipe.plan
        S, s = plan.S, plan.s
        M = x.shape[0]
        aliases = [t.detach().requires_grad_(t.is_floating_point()) for t in leaves]
        with torch.enable_grad():  # the stage's views of the aliases carry their grads
            runner = pipe.runner(aliases)
        held: Dict[int, tuple] = {}
        outs = [None] * M
        aacc = torch.zeros((), dtype=torch.float32, device=x.device)
        act_in = None
        for t in range(M + S - 1):
            m = t - s
            send = None
            if 0 <= m < M:
                a = x[m] if s == 0 else act_in
                with plan.clock.stage():
                    if pipe.remat_stage:
                        held[m] = (a,)
                        out, aux = runner.forward(0, a)
                    else:
                        leaf, out, aux = runner.recompute(0, a)
                        held[m] = (leaf, out, aux)
                if aux is not None:
                    aacc += aux.detach().to(torch.float32)
                if s == S - 1:
                    outs[m] = out.detach()
                else:
                    send = out.detach()
            recvs = []
            act_in = None
            if s > 0 and 0 <= t - (s - 1) < M:
                act_in = torch.empty_like(x[0])
                recvs.append((s - 1, act_in))
            plan.hop([(s + 1, send)] if send is not None else [], recvs)
        pipe.stats["graphs_held_peak"] = max(pipe.stats.get("graphs_held_peak", 0), len(held))
        y = torch.stack(outs) if s == S - 1 else torch.zeros_like(x)
        if pipe.replicate_outputs:
            plan.broadcast(y, S - 1)
        ctx.pipe, ctx.held, ctx.aliases, ctx.runner = pipe, held, aliases, runner
        ctx.M, ctx.like = M, x[0]
        if not pipe.stage_aux:
            return y
        aux = plan.stage_sum(aacc.view(1).clone()) / (S * M)
        for line in plan.extras:
            if line.size > 1:
                with plan.clock.host("reduce_s"):
                    line.all_reduce(aux, "sum")
                aux = aux / line.size
        return y, aux[0]

    @staticmethod
    def backward(ctx, g_out, g_aux=None):
        pipe, held, runner, M = ctx.pipe, ctx.held, ctx.runner, ctx.M
        plan: _Plan = pipe.plan
        S, s = plan.S, plan.s
        aux_ct = 0.0 if g_aux is None else float(g_aux) / (S * M)
        d_x: List[Optional[torch.Tensor]] = [None] * M
        cot_in = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            send = None
            if 0 <= m < M:
                cot = (g_out[m] if g_out is not None else torch.zeros_like(ctx.like)) \
                    if _is_head_stage(s, S) else cot_in
                with plan.clock.stage():
                    if pipe.remat_stage:
                        leaf, out, aux = runner.recompute(0, held.pop(m)[0])
                    else:
                        leaf, out, aux = held.pop(m)
                    dact = _backward(leaf, out, aux, cot, aux_ct)
                if s == 0:
                    d_x[m] = dact
                else:
                    send = dact
            recvs = []
            cot_in = None
            if s < S - 1 and 0 <= t - (s + 1) < M:
                cot_in = torch.empty_like(ctx.like)
                recvs.append((s + 1, cot_in))
            plan.hop([(s - 1, send)] if send is not None else [], recvs)
        dx = torch.stack(d_x) if s == 0 else torch.empty((M,) + tuple(ctx.like.shape),
                                                           dtype=ctx.like.dtype,
                                                           device=ctx.like.device)
        plan.broadcast(dx, 0)
        grads = [a.grad if a.grad is not None else torch.zeros_like(a) for a in ctx.aliases]
        return (None, dx) + tuple(grads)


class _Pipe:
    """What :class:`_GPipe` needs: the plan, a factory of the stage runner
    over the parameter aliases, the remat and aux flags, and ``stats``."""

    def __init__(self, plan: _Plan, runner: Callable, remat_stage: bool, stage_aux: bool):
        self.plan, self.runner = plan, runner
        self.remat_stage, self.stage_aux = bool(remat_stage), bool(stage_aux)
        # False: the outputs stay on the last stage (a caller whose head
        # runs there alone), the other ranks' output being zeros.
        self.replicate_outputs = True
        self.stats: Dict[str, int] = {}


def make_pipeline_apply(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    *,
    stage_axis: str = "stage",
    param_specs: Any = None,
    remat_stage: bool = False,
    extra_manual_axes: tuple = (),
    microbatch_spec: Sequence = P(),
    stage_aux: bool = False,
) -> Callable[[Any, torch.Tensor], torch.Tensor]:
    """Build ``apply(stage_params, microbatches) -> outputs`` (GPipe) on
    ``mesh`` (a ``GridMesh`` with ``stage_axis``).

    ``stage_fn(params_for_one_stage, act) -> act`` applies one stage's
    layer group (its parameters are this rank's block without the stage
    axis); activations keep one shape and dtype throughout.
    ``microbatches`` are the global ``(M, mb, ...)``; the outputs are this
    rank's block of the ``(M, mb, ...)`` outputs of the full stack, the
    same on every rank of the stage line.  Differentiable in the
    parameters and the microbatches: every rank of the line must
    backpropagate through its outputs (the last stage's cotangent is the
    one used; stage 0's input cotangent comes back on every rank).

    ``remat_stage=True`` keeps only each microbatch's stage input between
    the forward and the backward, which recomputes the stage (the FLOPs
    for memory trade; 1F1B always recomputes).  ``param_specs`` (a tree of
    ``PartitionSpec`` matching ``stage_params``, each leading with
    ``stage_axis``) composes with tensor or expert parallelism inside
    ``stage_fn``; ``extra_manual_axes`` / ``microbatch_spec`` with
    sequence parallelism (e.g. ``("seq",)`` and ``P(None, None,
    "seq")``).  The rows of every other axis are this rank's data rows;
    their gradients are the caller's to reduce.

    ``stage_aux=True``: ``stage_fn(p, act) -> (act, aux_scalar)`` and the
    return is ``(outputs, aux)``, ``aux`` the mean of the per-(stage,
    microbatch) scalars (bubble ticks never run), averaged over the extra
    axes; its cotangent reaches each (stage, microbatch) scalar divided by
    ``S * M`` (so a rank's loss share adds ``coef * aux / n_extra``)."""
    if param_specs is not None:
        _check_param_specs(param_specs, stage_axis)
    plan = _Plan(mesh, stage_axis, extra_manual_axes, _spec_axes(param_specs))
    stats: Dict[str, int] = {}

    def apply(stage_params, microbatches):
        paths, blocks = _rank_block(stage_params, param_specs, plan, stage_axis)
        x = plan.block(microbatches, microbatch_spec)

        def runner(aliases):
            p = _unflatten(paths, [a[0] for a in aliases])
            return _StageRunner(lambda c, a: stage_fn(p, a), stage_aux)

        pipe = _Pipe(plan, runner, remat_stage, stage_aux)
        pipe.stats = stats
        return _GPipe.apply(pipe, x, *blocks)

    apply.plan, apply.stats = plan, stats
    from distributed_learning_tpu_torch.obs import instrument_step

    return instrument_step(apply, "pp.apply")


# ---------------------------------------------------------------------- #
# 1F1B                                                                    #
# ---------------------------------------------------------------------- #
def make_1f1b_train_step(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    *,
    stage_axis: str = "stage",
    param_specs: Any = None,
    head_fn: Optional[Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    collect_input_grads: bool = False,
    extra_manual_axes: tuple = (),
    microbatch_spec: Sequence = P(),
    stage_aux_coef: Optional[float] = None,
) -> Callable[..., tuple]:
    """Build ``step(stage_params, microbatches, labels) -> (grads, loss)``
    under the 1F1B schedule on ``mesh``.

    ``loss_fn(last_stage_out, labels_mb) -> scalar`` is the per-microbatch
    loss; the step returns this rank's block of the gradient of ``mean_m
    loss_fn(out_m, y_m)`` with respect to ``stage_params`` (the block's
    leading stage axis kept) and that mean loss, the same on every rank.
    The caller owns the optimizer.

    Schedule: tick ``t``, stage ``s`` runs the forward of microbatch ``t -
    s`` and the backward of ``t - (2S - 2 - s)`` (each when in ``[0,
    M)``), the last stage seeding each backward from the loss the tick its
    forward completes; activations hop ``s -> s+1``, cotangents ``s ->
    s-1``; ``M + 2S - 2`` ticks.  A backward recomputes its stage from
    the stashed INPUT (depth ``min(M, 2S - 1)``).

    Extensions, as the reference's (``training/pp_lm.py`` uses them):
    ``head_fn(head_params, out, labels_mb) -> scalar`` replaces ``loss_fn``
    with a trainable head (exactly one of the two): the step then takes
    ``head_params`` (a tree of tensors, the same on every rank) after
    ``stage_params`` and returns their gradient after the stage gradient,
    accumulated at the last stage alone and broadcast from it;
    ``collect_input_grads=True`` also returns ``d_microbatches``, the
    cotangent of this rank's block of the microbatches (stage 0's,
    broadcast over the stage line), for the caller to chain into whatever
    made them.  Returns ``(grads[, head_grads][, d_microbatches], loss)``.

    ``param_specs`` / ``extra_manual_axes`` / ``microbatch_spec`` as in
    :func:`make_pipeline_apply` (``microbatch_spec`` applies to the labels
    too); under extra axes the head returns this shard's share of the
    microbatch loss and the step sums.  Data axes: rows split, gradients
    and loss averaged.  ``stage_aux_coef``: ``stage_fn(p, act) -> (act,
    aux)`` and ``coef * mean_{m,s} aux`` (mean also over the extra axes)
    joins the objective, each stage seeding its aux cotangent with
    :func:`_aux_seed_value` on its backward; the returned loss includes
    it.  The step's ``stats`` hold the stash depth and its peak."""
    if (loss_fn is None) == (head_fn is None):
        raise ValueError("exactly one of loss_fn / head_fn is required")
    if param_specs is not None:
        _check_param_specs(param_specs, stage_axis)
    plan = _Plan(mesh, stage_axis, extra_manual_axes, _spec_axes(param_specs))
    hfn = head_fn if head_fn is not None else (lambda hp, o, y: loss_fn(o, y))
    stats: Dict[str, int] = {}

    def step(stage_params, *args):
        if head_fn is not None:
            head_params, microbatches, labels = args
        else:
            (microbatches, labels), head_params = args, {}
        paths, blocks = _rank_block(stage_params, param_specs, plan, stage_axis)
        aliases = [b.detach().requires_grad_(True) for b in blocks]
        p = _unflatten(paths, [a[0] for a in aliases])
        hpaths, hleaves = zip(*_leaves(head_params)) if head_params else ((), ())
        haliases = [h.detach().requires_grad_(True) for h in hleaves]
        hp = _unflatten(list(hpaths), haliases) if haliases else {}
        x = plan.block(microbatches, microbatch_spec)
        y = plan.block(labels, microbatch_spec)
        M = x.shape[0]
        scale = 1.0 / (M * plan.n_data)
        aux_seed = 0.0
        if stage_aux_coef is not None:
            aux_seed = _aux_seed_value(stage_aux_coef, M, plan.S,
                                       [m.size for m in plan.extras]) / plan.n_data
        runner = _StageRunner(lambda c, a: stage_fn(p, a), stage_aux_coef is not None)
        res = _run_1f1b(plan, runner, x, y, M, lambda o, yy: head_seed(hfn, hp, o, yy, scale),
                        scale, aux_seed, collect_input_grads)
        stats.update(stash_depth=res["stash"].depth, stash_peak=res["stash"].peak)
        g = [a.grad if a.grad is not None else torch.zeros_like(a) for a in aliases]
        h = [a.grad if a.grad is not None else torch.zeros_like(a) for a in haliases]
        g, h, d_mbs, loss = _finish_step(plan, g, h, res, stage_aux_coef, plan.S, M,
                                         collect_input_grads, x[0])
        outs = [_unflatten(paths, g)]
        if head_fn is not None:
            outs.append(_unflatten(list(hpaths), h) if h else {})
        if collect_input_grads:
            outs.append(d_mbs)
        outs.append(loss)
        return tuple(outs)

    step.plan, step.stats = plan, stats
    from distributed_learning_tpu_torch.obs import instrument_step

    return instrument_step(step, "pp.1f1b_step")
