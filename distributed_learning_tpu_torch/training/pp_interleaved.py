"""Interleaved-1F1B pipeline parallelism (virtual pipeline stages; port
of ``distributed_learning_tpu/training/pp_interleaved.py``).

Megatron-LM's interleaved schedule (arXiv:2104.04473 §2.2): each of the
``S`` stage ranks hosts ``V`` chunks of the layer stack instead of one,
so virtual stage ``v`` (of ``S*V``) lives on stage ``v mod S`` — the
fill/drain bubble shrinks by ~``V``.  Activations hop a +1 ring and
cotangents a -1 ring on the stage line; :func:`build_schedule` (a plain
numpy copy of the reference's, tick tables equal to its) says which
(chunk, microbatch, direction) a stage runs at each tick and where each
incoming message is filed.

The executor (:func:`make_interleaved_1f1b_train_step`) walks the tables
on each rank and runs the tick's op directly: idle, a chunk forward, or
a chunk backward recomputed from its stashed input.  The reference must
run an unconditional masked forward + backward every tick under pp x sp
(its executor note, ``pp_interleaved.py:286-301``): inside one SPMD
program a ``ppermute`` inside a ``lax.switch`` branch rendezvouses across
every device, and the stage rows that took another branch never arrive.
Here a sequence-parallel attention's ring runs on the rank's ``seq``
line, a subgroup inside one stage row whose ranks share every table
entry, so dispatching on the op is sound under every composition, and
an idle tick launches nothing.

The same exact-gradient contract as ``training/pp.py``, whose module
docstring states the port's conventions (parameter blocks, extra and
data axes, the head's share, broadcasts from the owning stage).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from distributed_learning_tpu_torch.parallel.multihost import PartitionSpec as P
from distributed_learning_tpu_torch.training.pp import (
    _aux_seed_value,
    _backward,
    _check_param_specs,
    _finish_step,
    _is_head_stage,
    _leaves,
    _Plan,
    _rank_block,
    _spec_axes,
    _StageRunner,
    _unflatten,
    head_seed,
)

__all__ = ["build_schedule", "make_interleaved_1f1b_train_step"]


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """Static tick tables, all shaped (ticks, S) unless noted.

    ``op``: 0 idle, 1 forward, 2 backward.  ``chunk``: which of the
    device's V chunks.  ``mb``: microbatch index.  ``recv_f_*`` /
    ``recv_b_*``: where THIS tick's incoming activation / cotangent
    message (sent by the neighbor at tick t-1) must be filed —
    (valid, chunk, slot).  ``slots``: stash depth (max in-flight per
    chunk, measured on the simulated schedule).
    """

    op: np.ndarray
    chunk: np.ndarray
    mb: np.ndarray
    recv_f_valid: np.ndarray
    recv_f_chunk: np.ndarray
    recv_f_slot: np.ndarray
    recv_b_valid: np.ndarray
    recv_b_chunk: np.ndarray
    recv_b_slot: np.ndarray
    slots: int
    ticks: int


def build_schedule(S: int, V: int, M: int) -> _Schedule:
    """Greedy backward-first list schedule for S devices x V chunks x M
    microbatches.

    Dependencies (virtual stage ``v = c*S + d``):

    * fwd(v, m) needs fwd(v-1, m) completed at an EARLIER tick (the
      activation hops between ticks); fwd(0, m) is always ready.
    * bwd(v, m) needs fwd(v, m) (same device, may be the same tick at
      the LAST virtual stage only — it seeds from the loss) and
      bwd(v+1, m) at an earlier tick.

    Policy per device per tick: run the ready backward with the
    smallest (mb, chunk) if any (1F1B drains eagerly to bound the
    stash), else the ready forward with the smallest (chunk, mb) —
    chunk-minor forward order is what lets later chunks start before
    earlier chunks finish every microbatch (the interleave).
    """
    SV = S * V
    fwd_done = -np.ones((SV, M), np.int64)  # tick at which fwd finished
    bwd_done = -np.ones((SV, M), np.int64)
    op_rows, chunk_rows, mb_rows = [], [], []
    t = 0
    total = 2 * SV * M
    done = 0
    max_ticks = 8 * (M + 2 * SV) + 64  # generous safety net
    while done < total and t < max_ticks:
        op_r = np.zeros(S, np.int64)
        ch_r = np.zeros(S, np.int64)
        mb_r = np.zeros(S, np.int64)
        for d in range(S):
            picked = None
            # Backward first (smallest mb drains the oldest in-flight).
            for m in range(M):
                for c in range(V):
                    v = c * S + d
                    if bwd_done[v, m] >= 0:
                        continue
                    if fwd_done[v, m] < 0:
                        continue
                    if v == SV - 1:
                        # Loss-seeded: needs its OWN fwd at an earlier
                        # tick (the executor recomputes from the stash,
                        # so same-tick fwd+bwd fusion is not modeled).
                        if fwd_done[v, m] >= t:
                            continue
                    else:
                        if bwd_done[v + 1, m] < 0 or bwd_done[v + 1, m] >= t:
                            continue
                    picked = (2, c, m)
                    break
                if picked:
                    break
            if picked is None:
                for c in range(V):
                    for m in range(M):
                        v = c * S + d
                        if fwd_done[v, m] >= 0:
                            continue
                        if v > 0 and (
                            fwd_done[v - 1, m] < 0 or fwd_done[v - 1, m] >= t
                        ):
                            continue
                        picked = (1, c, m)
                        break
                    if picked:
                        break
            if picked is not None:
                o, c, m = picked
                v = c * S + d
                op_r[d], ch_r[d], mb_r[d] = o, c, m
                if o == 1:
                    fwd_done[v, m] = t
                else:
                    bwd_done[v, m] = t
                done += 1
        op_rows.append(op_r)
        chunk_rows.append(ch_r)
        mb_rows.append(mb_r)
        t += 1
    if done < total:
        raise RuntimeError(
            f"schedule did not complete: {done}/{total} ops in {t} ticks"
        )

    op = np.stack(op_rows)
    chunk = np.stack(chunk_rows)
    mb = np.stack(mb_rows)
    ticks = op.shape[0]

    # Buffer depth: the stash holds (fwd done -> bwd pending), the
    # fwd-in buffer (producer's fwd+1 -> this stage's fwd), the cot-in
    # buffer (downstream bwd+1 -> this stage's bwd).  All three windows
    # advance in microbatch order under the bwd-first policy, so a
    # depth of the max in-flight count makes m % slots collision-free.
    # One pass measures the depth; a second pass over the SAME windows
    # asserts collision-freedom against the final depth (monotonicity
    # is a property of the CURRENT greedy policy — check the simulated
    # run rather than assume it survives a policy tweak).
    def _lifetimes(v):
        yield fwd_done[v], bwd_done[v]                        # stash
        if v > 0:
            yield fwd_done[v - 1] + 1, fwd_done[v]            # fwd-in
        if v < SV - 1:
            yield bwd_done[v + 1] + 1, bwd_done[v]            # cot-in

    # Vectorized over ticks (the per-tick Python loops here used to
    # dominate build time at production scale): alive[tt, m] says
    # window m is in flight at tick tt.
    tts = np.arange(ticks)[:, None]                           # (ticks, 1)
    alive_mats = []
    slots = 1
    for v in range(SV):
        for st, en in _lifetimes(v):
            alive = (
                (st[None, :] <= tts) & (st[None, :] >= 0)
                & ((en[None, :] > tts) | (en[None, :] < 0))
            )                                                 # (ticks, M)
            alive_mats.append((v, alive))
            slots = max(slots, int(alive.sum(axis=1).max(initial=0)))
    mods = np.arange(M) % slots
    for v, alive in alive_mats:
        for r in range(slots):
            assert alive[:, mods == r].sum(axis=1).max(initial=0) <= 1, (
                f"slot collision at v={v} (residue {r})"
            )

    # A consumable message produced at the final tick would never be
    # filed; the schedule's structure (the last ops are v=0 backwards /
    # last-stage forwards, both send-masked) should make this
    # impossible — assert it rather than assume it.
    for d in range(S):
        if op[-1, d] == 1:
            assert chunk[-1, d] * S + d == SV - 1, (
                "final-tick forward would lose its activation"
            )
        if op[-1, d] == 2:
            assert chunk[-1, d] * S + d == 0, (
                "final-tick backward would lose its cotangent"
            )

    # Receive routing: the message device d-1 SENT at tick t-1 (its fwd
    # output, unless its virtual stage was the last) arrives at d for
    # filing at tick t; symmetrically for cotangents from d+1.
    rfv = np.zeros((ticks, S), bool)
    rfc = np.zeros((ticks, S), np.int64)
    rfs = np.zeros((ticks, S), np.int64)
    rbv = np.zeros((ticks, S), bool)
    rbc = np.zeros((ticks, S), np.int64)
    rbs = np.zeros((ticks, S), np.int64)
    for t_ in range(1, ticks):
        for d in range(S):
            src = (d - 1) % S
            if op[t_ - 1, src] == 1:
                v_src = chunk[t_ - 1, src] * S + src
                if v_src < SV - 1 and (v_src + 1) % S == d:
                    rfv[t_, d] = True
                    rfc[t_, d] = (v_src + 1) // S
                    rfs[t_, d] = mb[t_ - 1, src] % slots
            src_b = (d + 1) % S
            if op[t_ - 1, src_b] == 2:
                v_src = chunk[t_ - 1, src_b] * S + src_b
                if v_src > 0 and (v_src - 1) % S == d:
                    rbv[t_, d] = True
                    rbc[t_, d] = (v_src - 1) // S
                    rbs[t_, d] = mb[t_ - 1, src_b] % slots
    return _Schedule(op, chunk, mb, rfv, rfc, rfs, rbv, rbc, rbs,
                     slots, ticks)




def _run_interleaved(plan, sched: _Schedule, V: int, runner: _StageRunner,
                     inputs: torch.Tensor, labels, head: Callable, scale: float,
                     aux_seed: float, collect: bool) -> dict:
    """One rank's ticks of ``sched`` (``V`` chunks a stage).  ``inputs``
    (M, ...) feed virtual stage 0, ``head(out, y) -> (loss, seed)`` seeds
    the last one.  Returns what ``pp._run_1f1b`` returns (``stash``: its
    depth, ``V`` times the schedule's slots, and the most inputs filed at
    once)."""
    S, s = plan.S, plan.s
    SV = S * V
    K = sched.slots
    like = inputs[0]
    M = inputs.shape[0]
    stash: Dict[tuple, torch.Tensor] = {}
    fbuf: Dict[tuple, torch.Tensor] = {}
    bbuf: Dict[tuple, torch.Tensor] = {}
    lacc = torch.zeros((), dtype=torch.float32, device=like.device)
    aacc = torch.zeros((), dtype=torch.float32, device=like.device)
    d_in: List[Optional[torch.Tensor]] = [None] * M if collect else []
    act_in = cot_in = None
    peak = 0
    for t in range(sched.ticks):
        # 1) File the messages that arrived this tick.
        if sched.recv_f_valid[t, s]:
            fbuf[(int(sched.recv_f_chunk[t, s]), int(sched.recv_f_slot[t, s]))] = act_in
        if sched.recv_b_valid[t, s]:
            bbuf[(int(sched.recv_b_chunk[t, s]), int(sched.recv_b_slot[t, s]))] = cot_in
        o, c, m = int(sched.op[t, s]), int(sched.chunk[t, s]), int(sched.mb[t, s])
        v, key = c * S + s, (c, m % K)
        sends = []
        if o == 1:
            a = inputs[m] if v == 0 else fbuf.pop(key)
            stash[key] = a
            peak = max(peak, len(stash))
            with plan.clock.stage():
                out, _ = runner.forward(c, a)  # the aux is banked on the recompute
            if v != SV - 1:  # the last virtual stage feeds only its own backward
                sends.append(((s + 1) % S, out))
        elif o == 2:
            with plan.clock.stage():
                leaf, out, aux = runner.recompute(c, stash.pop(key))
                if _is_head_stage(v, SV):
                    lval, cot = head(out, labels[m])
                    lacc += lval * scale
                else:
                    cot = bbuf.pop(key)
                if aux is not None:
                    aacc += aux.detach().to(torch.float32)
                dact = _backward(leaf, out, aux, cot, aux_seed)
            if v != 0:
                sends.append(((s - 1) % S, dact))
            elif collect:
                d_in[m] = dact
        # 2) Post this tick's send and the receives the next tick files.
        recvs = []
        act_in = cot_in = None
        if t + 1 < sched.ticks:
            if sched.recv_f_valid[t + 1, s]:
                act_in = torch.empty_like(like)
                recvs.append(((s - 1) % S, act_in))
            if sched.recv_b_valid[t + 1, s]:
                cot_in = torch.empty_like(like)
                recvs.append(((s + 1) % S, cot_in))
        plan.hop(sends, recvs)
    return {"loss": lacc, "aux": aacc, "stash": SimpleNamespace(depth=K * V, peak=peak),
            "d_in": d_in}


def make_interleaved_1f1b_train_step(
    mesh,
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    *,
    n_chunks: int,
    n_microbatches: int,
    stage_axis: str = "stage",
    param_specs: Any = None,
    head_fn: Optional[Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]] = None,
    collect_input_grads: bool = False,
    extra_manual_axes: tuple = (),
    microbatch_spec: Sequence = P(),
    stage_aux_coef: Optional[float] = None,
) -> Callable[..., tuple]:
    """Build ``step(stage_params, microbatches, labels) -> (grads, loss)``
    under the interleaved schedule on ``mesh``.

    ``stage_params`` has leading dims ``(S, V, ...)`` (or this rank's
    ``(1, V, ...)`` block): dim 0 over ``stage_axis``, dim 1 the rank's
    chunks in virtual-stage order (chunk ``c`` of stage ``d`` is virtual
    stage ``c*S + d``); ``stage_fn(chunk_params, act) -> act`` applies ONE
    chunk.  ``microbatches`` / ``labels`` are ``(M, mb, ...)`` with ``M =
    n_microbatches`` (the schedule is built for it).  The gradients come
    back as this rank's ``(1, V, ...)`` block; ``loss`` is the mean
    microbatch loss.  ``head_fn``, ``collect_input_grads``,
    ``param_specs``, ``extra_manual_axes`` / ``microbatch_spec`` and
    ``stage_aux_coef`` as in ``pp.make_1f1b_train_step``; the aux
    normalisation divides by the VIRTUAL stage count ``S*V``.  Returns
    ``(grads[, head_grads][, d_microbatches], loss)``."""
    if (loss_fn is None) == (head_fn is None):
        raise ValueError("exactly one of loss_fn / head_fn is required")
    V, M = int(n_chunks), int(n_microbatches)
    if param_specs is not None:
        _check_param_specs(param_specs, stage_axis)
        # The chunk dim (dim 1) must stay whole: a rank indexes its chunks
        # by it, and a split chunk dim would hand it the wrong chunks.
        for path, spec in _leaves(param_specs):
            if len(spec) > 1 and spec[1] is not None:
                raise ValueError(
                    f"param_specs at {'/'.join(path)} is {spec!r}: dim 1 is the chunk dim "
                    "and must be None (unsharded) — sharding it would hand each rank "
                    "the wrong chunks")
    plan = _Plan(mesh, stage_axis, extra_manual_axes, _spec_axes(param_specs))
    sched = build_schedule(plan.S, V, M)
    hfn = head_fn if head_fn is not None else (lambda hp, o, y: loss_fn(o, y))
    stats: Dict[str, int] = {}

    def step(stage_params, *args):
        if head_fn is not None:
            head_params, microbatches, labels = args
        else:
            (microbatches, labels), head_params = args, {}
        if microbatches.shape[0] != M:
            raise ValueError(f"schedule was built for {M} microbatches, got "
                             f"{microbatches.shape[0]}")
        for path, leaf in _leaves(stage_params):
            if leaf.ndim < 2 or leaf.shape[1] != V:
                raise ValueError(
                    f"stage_params at {'/'.join(path)} has shape {tuple(leaf.shape)}; expected "
                    f"leading (S, V={V}, ...) — a mismatched chunk dim would silently train "
                    "only some chunks")
        paths, blocks = _rank_block(stage_params, param_specs, plan, stage_axis)
        aliases = [b.detach().requires_grad_(True) for b in blocks]
        chunks = [_unflatten(paths, [a[0, c] for a in aliases]) for c in range(V)]
        hpaths, hleaves = zip(*_leaves(head_params)) if head_params else ((), ())
        haliases = [h.detach().requires_grad_(True) for h in hleaves]
        hp = _unflatten(list(hpaths), haliases) if haliases else {}
        x = plan.block(microbatches, microbatch_spec)
        y = plan.block(labels, microbatch_spec)
        scale = 1.0 / (M * plan.n_data)
        aux_seed = 0.0
        if stage_aux_coef is not None:
            aux_seed = _aux_seed_value(stage_aux_coef, M, plan.S * V,
                                       [m.size for m in plan.extras]) / plan.n_data
        runner = _StageRunner(lambda c, a: stage_fn(chunks[c], a), stage_aux_coef is not None)
        res = _run_interleaved(plan, sched, V, runner, x, y,
                               lambda o, yy: head_seed(hfn, hp, o, yy, scale), scale, aux_seed,
                               collect_input_grads)
        stats.update(stash_depth=res["stash"].depth, stash_peak=res["stash"].peak)
        g = [a.grad if a.grad is not None else torch.zeros_like(a) for a in aliases]
        h = [a.grad if a.grad is not None else torch.zeros_like(a) for a in haliases]
        g, h, d_mbs, loss = _finish_step(plan, g, h, res, stage_aux_coef, plan.S * V, M,
                                         collect_input_grads, x[0])
        outs = [_unflatten(paths, g)]
        if head_fn is not None:
            outs.append(_unflatten(list(hpaths), h) if h else {})
        if collect_input_grads:
            outs.append(d_mbs)
        outs.append(loss)
        return tuple(outs)

    step.plan, step.stats, step.schedule = plan, stats, sched
    from distributed_learning_tpu_torch.obs import instrument_step

    return instrument_step(step, "pp.interleaved_step")
