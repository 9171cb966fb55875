"""FSDP / ZeRO-3 training: parameters sharded over the data axis (port of
``distributed_learning_tpu/training/fsdp.py``).

The reference places each parameter's largest divisible dimension over
``data_axis`` and lets XLA's partitioner schedule the gathers and
reduce-scatters.  The port writes ZeRO-3 out (arXiv:1910.02054):

* each rank keeps its :func:`fsdp_spec` block of every leaf in one flat
  float32 buffer, and the optimizer's moments of that block only;
* the model runs as gather units (the embeddings, each block, the final
  LayerNorm and head): a unit's whole weights are gathered (one
  ``all_gather``) just before it runs and freed after; the backward
  gathers them again and recomputes the unit (one
  ``torch.autograd.Function`` a unit), so at most one unit's weights are
  whole at a time;
* a unit's gradients leave through one ``reduce_scatter`` (the mean over
  ``data``) straight into this rank's block of the gradient buffer;
* the optimizer updates the blocks.

The batch is split over the same axis.  MoE blocks route the gathered
global batch (``TransformerLM.set_batch_mesh``), as the reference's
partitioner routes a data-sharded one.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from distributed_learning_tpu_torch.parallel.multihost import (
    MeshPosition,
    PartitionSpec as P,
    local_shard,
    tree_map_with_path,
)

__all__ = ["fsdp_spec", "shard_params_fsdp", "make_fsdp_train_step", "reject_dropout_model",
           "FsdpStep"]


def reject_dropout_model(model) -> None:
    """Refuse a dropout-configured model instead of silently training it
    unregularised: the step builders draw no dropout masks
    (``GossipTrainer`` is the path that draws them)."""
    if getattr(model, "dropout_rate", 0.0):
        raise ValueError(
            "model has dropout_rate > 0 but this train step does not "
            "thread dropout rngs; train via GossipTrainer or set "
            "dropout_rate=0"
        )


def fsdp_spec(leaf, axis_size: int, data_axis: str, avoid: Optional[P] = None) -> P:
    """The placement sharding ``leaf``'s largest dimension that divides
    by ``axis_size`` over ``data_axis`` (``fsdp.py:50``).  Scalars and
    leaves with no such dimension stay whole; ``avoid`` marks dimensions
    another rule set already splits (tensor parallelism), which are
    skipped."""
    ndim = getattr(leaf, "ndim", 0)
    if ndim == 0:
        return P()
    taken = tuple(avoid) if avoid is not None else ()
    best = None
    for d in range(ndim):
        if d < len(taken) and taken[d] is not None:
            continue
        if leaf.shape[d] % axis_size == 0 and leaf.shape[d] > 0:
            if best is None or leaf.shape[d] > leaf.shape[best]:
                best = d
    if best is None:
        return P() if avoid is None else P(*avoid)
    spec = list(taken) + [None] * (ndim - len(taken))
    spec[best] = data_axis
    return P(*spec)


def shard_params_fsdp(params: Any, mesh, data_axis: str = "data") -> Any:
    """This rank's :func:`fsdp_spec` block of every leaf of a full tree."""
    n = mesh.shape[data_axis]
    return tree_map_with_path(lambda _path, a: local_shard(a, fsdp_spec(a, n, data_axis), mesh),
                              params)


class _Unit:
    """One gather unit: its leaves' blocks are ``flat[0, lo:hi]`` (leaf by
    leaf, each a ``(1, *block)`` run), its gradient blocks the same range
    of ``grads``."""

    def __init__(self, step: "FsdpStep", names: List[str], lo: int):
        self.step, self.names, self.lo = step, names, lo
        self.hi = lo + sum(step.local_numel[n] for n in names)

    def gather(self, buf: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Every leaf whole (a fresh tensor, bit for bit the unsharded
        leaf): one ``all_gather`` of the unit's blocks (of ``buf``, the
        parameters' layout, when given)."""
        st = self.step
        t0 = time.perf_counter()
        mine = (st.flat if buf is None else buf)[0, self.lo:self.hi]
        parts = st.data.all_gather(mine)                            # (n, size)
        out, off = {}, 0
        for name in self.names:
            size, dim = st.local_numel[name], st.dims[name]
            shape = st.local_shapes[name]
            if dim is None:
                out[name] = mine[off:off + size].view(shape).clone()
            else:
                out[name] = torch.cat([parts[r, off:off + size].view(shape)
                                       for r in range(st.data.size)], dim=dim + 1)
            off += size
        st.timing["gather_s"] += time.perf_counter() - t0
        return out

    def scatter_grads(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """The unit's whole gradients summed over the ranks and averaged,
        this rank's blocks written into the gradient buffer: one
        ``reduce_scatter`` (block ``r`` of each leaf to rank ``r``; a whole
        leaf goes whole to every rank)."""
        st = self.step
        t0 = time.perf_counter()
        n = st.data.size
        blocks = torch.zeros((n, self.hi - self.lo), dtype=torch.float32, device=st.flat.device)
        off = 0
        for name in self.names:
            size, dim = st.local_numel[name], st.dims[name]
            g = grads.get(name)
            if g is not None:
                if dim is None:
                    blocks[:, off:off + size] = g.reshape(1, -1)
                else:
                    for r, c in enumerate(g.chunk(n, dim + 1)):
                        blocks[r, off:off + size] = c.reshape(-1)
            off += size
        mine = st.data.reduce_scatter(blocks)[0]
        st.grads[0, self.lo:self.hi].copy_(mine.div_(n))
        st.timing["reduce_scatter_s"] += time.perf_counter() - t0


class _GatheredUnit(torch.autograd.Function):
    """``run(whole weights, *inputs)`` with the unit's weights gathered
    for the call and freed after; the backward gathers them again,
    recomputes the unit, and sends its weight gradients out through the
    unit's ``reduce_scatter``.  ``anchor`` (an empty leaf that requires a
    gradient) makes autograd call the backward of a unit whose inputs
    need none (the token embedding)."""

    @staticmethod
    def forward(ctx, anchor, unit, run, *inputs):
        ctx.unit, ctx.run = unit, run
        ctx.save_for_backward(*inputs)
        with torch.no_grad():
            outs = run(unit.gather(), *inputs)
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        inputs = ctx.saved_tensors
        whole = {k: v.requires_grad_(True) for k, v in ctx.unit.gather().items()}
        xs = [t.detach().requires_grad_(t.is_floating_point()) for t in inputs]
        with torch.enable_grad():
            outs = ctx.run(whole, *xs)
        pairs = [(o, g) for o, g in zip(outs, gouts) if o.requires_grad]
        torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])
        ctx.unit.scatter_grads({k: v.grad for k, v in whole.items()})
        return (None, None, None) + tuple(x.grad if x.requires_grad else None for x in xs)


class FsdpStep:
    """The ZeRO-3 step of :func:`make_fsdp_train_step`; also holds this
    rank's blocks (:meth:`local_params`), the optimizer over them, and the
    seconds of the last call's gathers and reduce-scatters
    (:attr:`timing`)."""

    def __init__(self, mesh, model, tx, *, data_axis: str = "data", moe_aux_coef: float = 0.01):
        reject_dropout_model(model)
        if model.n_agents != 1 or getattr(model, "parallel", None) or model.seq_mesh is not None:
            raise ValueError("make_fsdp_train_step takes a plain one-replica TransformerLM "
                             "(n_agents=1, no tp/expert/sequence axis)")
        self.model, self.data = model, mesh[data_axis]
        self.moe_aux_coef = float(moe_aux_coef)
        n = self.data.size
        model.set_batch_mesh(self.data)
        params = model.stacked_parameters()
        pos = MeshPosition({data_axis: n}, {data_axis: self.data.agent})
        self.specs: Dict[str, P] = {}
        self.dims: Dict[str, Optional[int]] = {}
        self.local_shapes: Dict[str, Tuple[int, ...]] = {}
        self.local_numel: Dict[str, int] = {}
        for name, p in params.items():
            spec = fsdp_spec(torch.empty(p.shape[1:], device="meta"), n, data_axis)
            self.specs[name] = spec
            self.dims[name] = next((d for d, a in enumerate(spec) if a is not None), None)
            block = local_shard(p, spec, pos, offset=1)
            self.local_shapes[name] = tuple(block.shape)
            self.local_numel[name] = block.numel()
        dev = model.flat_params.device
        total = sum(self.local_numel.values())
        self.flat = torch.empty((1, total), dtype=torch.float32, device=dev)
        self.grads = torch.zeros_like(self.flat)
        # Units in the order the forward runs them; blocks laid out so.
        order = (["embed"] + (["pos_embed"] if "pos_embed" in params else []),)
        order += tuple([k for k in params if k.startswith(f"blocks.{i}.")]
                       for i in range(len(model.blocks)))
        order += ([k for k in params if k.startswith(("ln_f.", "head."))],)
        self.units, lo = [], 0
        for names in order:
            self.units.append(_Unit(self, names, lo))
            lo = self.units[-1].hi
        with torch.no_grad():
            for u in self.units:
                off = u.lo
                for name in u.names:
                    size = self.local_numel[name]
                    block = local_shard(params[name], self.specs[name], pos, offset=1)
                    self.flat[0, off:off + size].copy_(block.reshape(-1))
                    off += size
        # The whole replica goes: only the blocks and their moments stay.
        model.flat_params.untyped_storage().resize_(0)
        model.flat_grads.untyped_storage().resize_(0)
        self.flat.grad = self.grads
        self.optimizer = tx(self.flat)
        self._anchor = torch.empty(0, device=dev, requires_grad=True)
        self.timing = {"gather_s": 0.0, "reduce_scatter_s": 0.0}

    # -- the units' computations --------------------------------------- #
    def _run_embed(self, w, tokens):
        m = self.model
        return (m.embed_tokens(w["embed"], w.get("pos_embed"), tokens, None),)

    def _run_block(self, i):
        blk, pre = self.model.blocks[i], f"blocks.{i}."

        def run(w, x, positions):
            y = torch.func.functional_call(blk, {k[len(pre):]: v for k, v in w.items()},
                                           (x, positions))
            if not hasattr(blk, "moe"):
                return (y,)
            aux, blk.moe.aux = blk.moe.aux, None
            return y, aux

        return run

    def _run_head(self, w, x):
        m = self.model
        h = torch.func.functional_call(m.ln_f, {"scale": w["ln_f.scale"],
                                                "bias": w["ln_f.bias"]}, (x,))
        logits = torch.func.functional_call(m.head, {"kernel": w["head.kernel"],
                                                     "bias": w["head.bias"]}, (h,))
        return (logits.to(torch.float32),)

    def __call__(self, x_tok: torch.Tensor, y_tok: torch.Tensor) -> torch.Tensor:
        from distributed_learning_tpu_torch.training.tp import _rows

        dev = self.flat.device
        x, y = _rows(x_tok, self.data).to(dev), _rows(y_tok, self.data).to(dev)
        T = x.shape[-1]
        if T > self.model.max_len:
            raise ValueError(f"sequence length {T} exceeds max_len {self.model.max_len}")
        self.timing = {"gather_s": 0.0, "reduce_scatter_s": 0.0}
        positions = torch.arange(T, device=dev)
        self.grads.zero_()
        units = self.units
        h, = _GatheredUnit.apply(self._anchor, units[0], self._run_embed, x[None].long())
        auxes = []
        for i, unit in enumerate(units[1:-1]):
            outs = _GatheredUnit.apply(self._anchor, unit, self._run_block(i), h, positions)
            h = outs[0]
            auxes.extend(outs[1:])
        logits, = _GatheredUnit.apply(self._anchor, units[-1], self._run_head, h)
        loss = F.cross_entropy(logits[0].reshape(-1, logits.shape[-1]), y.reshape(-1).long())
        if auxes:
            aux = auxes[0]
            for a in auxes[1:]:
                aux = aux + a
            loss = loss + self.moe_aux_coef * (aux / len(auxes))[0]
        loss.backward()
        loss = loss.detach().reshape(1).clone()
        self.data.all_reduce(loss, "sum")
        self.optimizer.step()
        return loss[0] / self.data.size

    # -- state --------------------------------------------------------- #
    def local_params(self) -> Dict[str, torch.Tensor]:
        """``{name: (1, *block)}`` views of this rank's blocks."""
        out = {}
        for u in self.units:
            off = u.lo
            for name in u.names:
                size = self.local_numel[name]
                out[name] = self.flat[0, off:off + size].view(self.local_shapes[name])
                off += size
        return out

    def gather_params(self, buf: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """Every leaf whole, ``{name: (1, ...)}`` (one ``all_gather`` a
        unit; every rank must call it): the parameters, or ``buf`` laid
        out as they are (the gradient buffer :attr:`grads`)."""
        out = {}
        for u in self.units:
            out.update(u.gather(buf))
        return out

    def persistent_bytes(self) -> int:
        """The bytes this rank keeps between steps: its blocks, their
        gradient buffer and the optimizer's state tensors."""
        state = sum(t.numel() * t.element_size() for st in self.optimizer.state.values()
                    for t in st.values() if isinstance(t, torch.Tensor))
        return (self.flat.numel() + self.grads.numel()) * 4 + state


def make_fsdp_train_step(mesh, model, tx, *, data_axis: str = "data",
                         moe_aux_coef: float = 0.01) -> Callable[..., torch.Tensor]:
    """The ZeRO-3 step on ``mesh``'s ``data_axis`` (a ``GridMesh``; other
    axes, such as gossip's agents, are left alone) for this rank's
    ``model`` (a one-replica ``TransformerLM``, its parameters the whole
    init, which the step takes its blocks of and then frees) and ``tx``,
    an optimizer factory as ``make_optimizer`` returns.

    ``step(x, y) -> loss``: the global (B, T) batch (B divisible by the
    axis), of which this rank takes its rows; ``loss`` is the global mean
    (plus ``moe_aux_coef`` times the blocks' mean load-balance loss for an
    MoE model), the same on every rank.  Returns an :class:`FsdpStep`."""
    return FsdpStep(mesh, model, tx, data_axis=data_axis, moe_aux_coef=moe_aux_coef)
