"""EXTRA: exact first-order decentralized optimization (Shi et al. 2015),
dense and sharded (port of ``distributed_learning_tpu/parallel/extra.py``).

The one-variable sibling of gradient tracking: EXTRA cancels the
constant-step bias of decentralized gradient descent with a memory of the
previous iterate through ``W`` and ``W~ = (I + W) / 2``:

    x^1     = W x^0 - alpha * g(x^0)
    x^{k+2} = (I + W) x^{k+1} - W~ x^k - alpha * (g(x^{k+1}) - g(x^k))

Its fixed point is consensus AND first-order stationarity of the global
objective at a constant step size, with one mixing product a step.

Numerical design (the reference's, kept operation for operation): the
textbook form cancels O(|x|) quantities every step and floors a float32
run around 1e-3, so the engine runs the algebraically identical
**difference form**, with ``d^k = x^{k+1} - x^k`` and
``r^k = (W x^k - x^k) / 2``:

    d^{k+1} = W d^k + r^k - alpha * (g^{k+1} - g^k)
    r^{k+1} = r^k + (W d^k - d^k) / 2
    x^{k+2} = x^{k+1} + d^{k+1}          (compensated / Kahan add)

Every variable but ``x`` is O(step size).  Two float32 safeguards act on
the consensus direction, where ``I - W`` is singular and round-off
integrates: ``r`` is re-projected onto ``sum_i r_i = 0``, and a sub-ulp
across-agent mean of ``d`` is zeroed (:meth:`ExtraEngine._guard`), every
``project_every``-th step.  The reference decides that branch with
``lax.cond`` on the device; here it is decided on the host's step
counter, which costs no sync.  The reference records an f32 optimality
gap floor of ~2.4e-6 on its quadratic suite against ~1e-3 for the
textbook form; ``tests/torch_port/test_torch_tracking_extra.py`` holds
the port to the same floor.

With ``mesh=`` (one agent a rank) each rank holds its agent as a stack
of one, the mix is the consensus engine's matching exchanges, and the
guard's three across-agent means (``r``, ``d`` and the per-tensor scale)
are one fused ``all_reduce``, as the reference's one ``pmean``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from distributed_learning_tpu_torch.parallel._spmd import (
    Tree,
    leaves,
    mix_once,
    per_agent_grads,
    place,
    run_steps,
    tree_map,
)
from distributed_learning_tpu_torch.parallel.consensus import ConsensusEngine

__all__ = ["ExtraState", "ExtraEngine"]

_ULP = float(4.0 * np.finfo(np.float32).eps)


class ExtraState(NamedTuple):
    """Difference-form EXTRA state: iterate ``x = x^{k+1}``, its Kahan
    compensation ``c`` (the float32 bits lost accumulating ``d`` into
    ``x``), difference ``d = x^{k+1} - x^k``, mixing residual
    ``r = (W x^k - x^k) / 2``, previous gradients ``g_prev = g(x^k)``,
    and the step counter (a host int)."""

    x: Tree
    c: Tree
    d: Tree
    r: Tree
    g_prev: Tree
    step: int


def _kahan_add(x: torch.Tensor, c: torch.Tensor,
               inc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compensated ``x + (inc + c)`` (Kahan-Babuska/Neumaier two-sum), run
    once for both outputs.  Returns ``(x_new, c_new)``: ``x_new`` in
    ``x``'s dtype, ``c_new`` the float32 round-off the stored value
    dropped, including a sub-float32 storage dtype's cast error.  For a
    float32 ``x`` that cast term is exactly 0.0 and is not computed."""
    xf = x.float()
    y = inc.float() + c  # both small; this add is benign
    t = xf + y
    e = torch.where(xf.abs() >= y.abs(), (xf - t) + y, (y - t) + xf)
    if x.dtype == torch.float32:
        return t, e
    x_new = t.to(x.dtype)
    return x_new, e + (t - x_new.float())


class ExtraEngine:
    """Runs EXTRA over a mixing matrix, dense or sharded.

    Same constructor contract as :class:`GradientTrackingEngine` (the
    per-agent or, with ``stacked_grads=True``, the stacked gradient
    oracle; ``mesh`` one agent a rank; ``device`` the card unless
    ``"cpu"``), but a constant
    ``learning_rate`` only: a schedule raises ``TypeError``.
    ``project_every`` sets the cadence of the float32 safeguards
    (:meth:`_guard`); 1 runs them every step.
    """

    def __init__(self, W: np.ndarray, grad_fn: Callable, *, learning_rate: float = 1e-2,
                 project_every: int = 8, stacked_grads: bool = False, mesh=None, device=None):
        self.engine = ConsensusEngine(W, mesh=mesh, device=device)
        self.mesh = mesh
        self.n = self.engine.n
        self.device = self.engine.device
        self.grad_fn = grad_fn
        self.stacked_grads = bool(stacked_grads)
        if callable(learning_rate):
            # The telescoping that makes EXTRA exact needs
            # alpha_{k+1} g^{k+1} - alpha_k g^k; the recurrence applies ONE
            # alpha to both terms.
            raise TypeError(
                "ExtraEngine takes a constant learning_rate (a schedule "
                "breaks the telescoping that makes EXTRA exact); use "
                "GradientTrackingEngine for scheduled steps"
            )
        self._alpha = float(np.float32(learning_rate))
        if int(project_every) < 1:
            raise ValueError(f"project_every must be >= 1, got {project_every}")
        self.project_every = int(project_every)

    def _grads(self, x: Tree, step: int) -> Tree:
        return per_agent_grads(self, self.grad_fn, x, step, stacked=self.stacked_grads)

    def _guard(self, r: Tree, d: Tree, x: Tree) -> Tuple[Tree, Tree]:
        """The consensus-direction float32 safeguards.

        1. Re-project ``r`` onto its exact-arithmetic invariant
           ``sum_i r_i = 0``: an ulp-scale bias frozen into ``mean(r)``
           would integrate into a linear drift of every iterate, since
           ``I - W`` is singular along the consensus direction.
        2. Zero the across-agent mean of ``d`` where it is ulp-scale noise
           against the tensor's mean magnitude ``mean(|x|)``: once the
           float32 iterate stops moving nothing else damps that mode.
        """
        mesh = self.engine.mesh
        if mesh is None:
            def project(rv):
                return rv - rv.mean(dim=0, keepdim=True)

            def stall_kill(dv, xv):
                md = dv.mean(dim=0, keepdim=True)
                scale = xv.float().abs().mean()
                return dv - torch.where(md.abs() <= _ULP * scale, md, torch.zeros_like(md))

            return tree_map(project, r), tree_map(stall_kill, d, x)
        # Sharded: the three means in one fused all_reduce over the ranks.
        rl, dl = leaves(r), leaves(d)
        scales = [xv.float().abs().mean().reshape(1) for xv in leaves(x)]
        parts = rl + dl + scales
        flat = torch.cat([t.reshape(-1).float() for t in parts])
        means = iter(torch.split(mesh.all_reduce(flat, "sum") / self.n,
                                 [t.numel() for t in parts]))
        m_r = [next(means).view(t.shape) for t in rl]
        m_d = [next(means).view(t.shape) for t in dl]
        m_sc = [next(means)[0] for _ in scales]
        r_new = [rv - mr for rv, mr in zip(rl, m_r)]
        d_new = [dv - torch.where(md.abs() <= _ULP * ms, md, torch.zeros_like(md))
                 for dv, md, ms in zip(dl, m_d, m_sc)]
        if isinstance(r, dict):
            return dict(zip(r, r_new)), dict(zip(d, d_new))
        return r_new[0], d_new[0]

    def _step(self, s: ExtraState) -> ExtraState:
        """One difference-form iteration: mix the small difference ``d``,
        update the residual ``r`` from the same product, fold the new
        difference into ``x`` compensated."""
        alpha = self._alpha
        g = self._grads(s.x, s.step)
        Wd = mix_once(self.engine, s.d)
        d_new = tree_map(
            lambda wd, rv, gn, gp: torch.add(wd.float() + rv, gn.float() - gp.float(),
                                             alpha=-alpha),
            Wd, s.r, g, s.g_prev)
        r_new = tree_map(lambda rv, wd, dv: torch.add(rv, wd.float() - dv, alpha=0.5),
                         s.r, Wd, s.d)
        del Wd
        if s.step % self.project_every == 0:
            r_new, d_new = self._guard(r_new, d_new, s.x)
        xc = tree_map(lambda x, c, i: _kahan_add(x, c, i), s.x, s.c, d_new)
        return ExtraState(x=tree_map(lambda p: p[0], xc), c=tree_map(lambda p: p[1], xc),
                          d=d_new, r=r_new, g_prev=g, step=s.step + 1)

    def init(self, x0: Tree) -> ExtraState:
        """The first step ``x^1 = W x^0 - alpha g(x^0)``, as
        ``d^0 = (W x^0 - x^0) - alpha g^0``, so the one large-term
        cancellation happens once, here; ``r^0`` is guarded at once."""
        alpha = self._alpha
        x = place(self, x0)
        g0 = self._grads(x, 0)
        mix_res = tree_map(lambda wx, xv: wx.float() - xv.float(), mix_once(self.engine, x), x)
        d0 = tree_map(lambda mr, gv: torch.add(mr, gv.float(), alpha=-alpha), mix_res, g0)
        xc = tree_map(lambda xv, i: _kahan_add(xv, torch.zeros_like(xv, dtype=torch.float32), i),
                      x, d0)
        r0, _ = self._guard(tree_map(lambda mr: 0.5 * mr, mix_res), d0, x)
        return ExtraState(x=tree_map(lambda p: p[0], xc), c=tree_map(lambda p: p[1], xc),
                          d=d0, r=r0, g_prev=g0, step=1)

    def run(self, state: ExtraState, steps: int) -> Tuple[ExtraState, torch.Tensor]:
        """``steps`` EXTRA iterations; returns the final state and the
        ``(steps,)`` consensus-residual trace of ``x`` (a device tensor).
        ``state`` is left as it was."""
        return run_steps(self, state, steps, self._step)
