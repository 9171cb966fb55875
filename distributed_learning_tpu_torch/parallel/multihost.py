"""Multi-process agent meshes on ``torch.distributed`` (port of
``distributed_learning_tpu/parallel/multihost.py``).

The reference brings every host's chips into one JAX runtime and lays a
one-axis agent mesh over them, so that ring neighbours are physical
neighbours.  Here every agent is one rank, a process of its own:
:func:`initialize` joins the process group (``torch.distributed.
init_process_group``) with its address, world size and rank taken from
the arguments or the environment, and :class:`AgentMesh` is the port's
mesh: the group, the rank of each agent and this rank's device.  It is a
small class of the port's own rather than a ``torch.distributed.
device_mesh.DeviceMesh``, because a ``DeviceMesh`` binds one device type
to the whole mesh and one rank to each device, and the ranks of this
port may share one card (gloo) or sit on the CPU: what the engines need
is the peer rank of each agent, this rank's device, and a transport that
knows whether its tensors must pass through the host.

The transport (:meth:`AgentMesh.exchange`, :meth:`AgentMesh.all_reduce`,
:meth:`AgentMesh.all_gather`): with ``nccl`` the device tensors go to the
collectives as they are; with ``gloo`` and a card, each message is copied
to a pinned host buffer once, exchanged, and copied back once, and the
arithmetic stays on the card (gloo's send and recv take CPU tensors
only).  :attr:`AgentMesh.clock` keeps the seconds and bytes of each leg.

Two named axes (:class:`GridMesh`): the reference's ``(agents, seq)``
device mesh, for the agents x sequence-parallel LM step.  The ranks are
laid out row-major over the axes; ``grid[axis]`` is an :class:`AgentMesh`
over this rank's line along that axis (the ranks that share every other
coordinate with it), with a process subgroup of its own for the
collectives, the same transport and a clock of its own.

Placements (:class:`PartitionSpec`, :func:`shard_slice`,
:func:`local_shard`): the reference lays a parameter over a mesh with a
``PartitionSpec`` and XLA's partitioner gives each device its block.
Here a spec is the same tuple of axis names (``None`` for a dimension
kept whole), and this rank's block of a full tensor is the slice the
reference's spec puts on the device of the same index (ranks row-major,
as ``Mesh(np.array(devices).reshape(...))`` orders its devices).  The
model-parallel collectives with autograd (:func:`copy_to_axis`,
:func:`reduce_from_axis`, :func:`gather_along_axis`) are the Megatron
f/g pair and the all-gather whose gradient is a reduce-scatter: PyTorch
on gloo has no partitioner, so the port writes each collective where
the reference's partitioner would place it.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "AgentMesh",
    "GridMesh",
    "MeshPosition",
    "P",
    "PartitionSpec",
    "RankDevice",
    "copy_to_axis",
    "default_backend",
    "gather_along_axis",
    "hybrid_agent_mesh",
    "initialize",
    "local_shard",
    "order_devices_for_ring",
    "path_names",
    "process_local_agents",
    "reduce_from_axis",
    "shard_slice",
    "tree_map_with_path",
]

_log = logging.getLogger(__name__)


def default_backend(device=None, local_world_size: Optional[int] = None) -> str:
    """``nccl`` when every rank of this host has a card of its own, else
    ``gloo`` (CPU ranks, or ranks that share one card).  ``device`` "cpu"
    means CPU ranks; ``local_world_size`` defaults to ``LOCAL_WORLD_SIZE``
    or, without it, ``WORLD_SIZE`` (every rank on this host)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        return "gloo"
    if local_world_size is None:
        local_world_size = int(os.environ.get("LOCAL_WORLD_SIZE",
                                              os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if torch.cuda.device_count() >= int(local_world_size) else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 300.0,
) -> str:
    """Join this process to the process group; returns the backend.

    The address is ``coordinator_address`` (``host:port``), else
    ``DLT_COORDINATOR``, else ``MASTER_ADDR``/``MASTER_PORT``; the world
    size ``num_processes`` or ``WORLD_SIZE``; the rank ``process_id`` or
    ``RANK``.  ``backend`` is taken as given, else chosen by
    :func:`default_backend` for ``device``; the choice is logged.  A
    second call is a no-op that returns the group's backend (the
    idempotence guard the upstream call lacks)."""
    if dist.is_initialized():
        return dist.get_backend()
    if coordinator_address is None:
        coordinator_address = os.environ.get("DLT_COORDINATOR")
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        raise ValueError("no coordinator address: pass coordinator_address or set "
                         "DLT_COORDINATOR (or MASTER_ADDR and MASTER_PORT)")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = default_backend(device, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                             num_processes)))
    dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    _log.info("process group: backend %s, world size %d, rank %d", backend,
              int(num_processes), int(process_id))
    return backend


class RankDevice(NamedTuple):
    """What the ring order reads of a rank: its host (``process_index``),
    its slice (``None`` where the platform has none) and its id (the
    global rank)."""

    process_index: int
    slice_index: Optional[int]
    id: int


def order_devices_for_ring(devices: Sequence) -> list:
    """Sort devices by (process, slice, id), so a ring laid over the order
    crosses a host or slice boundary only where it must.  Pure ordering on
    any objects with those attributes (``slice_index`` absent or ``None``
    counts as slice 0), so layouts are testable without the hardware."""
    return sorted(devices, key=lambda d: (d.process_index, getattr(d, "slice_index", 0) or 0,
                                          d.id))


class PartitionSpec(tuple):
    """A placement: entry ``i`` names the mesh axis that dimension ``i``
    is split over, or ``None`` for a dimension kept whole; dimensions past
    the last entry are whole.  A tuple, so ``tuple(spec)`` compares with a
    ``jax.sharding.PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        # Unpickled as P(*entries), not P(entries).
        return tuple(self)

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshPosition:
    """A rank's place on named axes without a process group: ``shape``
    ``{axis: size}`` and ``coords`` ``{axis: index}`` (what
    :class:`GridMesh` and :class:`AgentMesh` also carry)."""

    shape: Mapping[str, int]
    coords: Mapping[str, int]

    @classmethod
    def of_rank(cls, shape: Mapping[str, int], rank: int) -> "MeshPosition":
        """Rank ``rank`` of a row-major grid of ``shape``."""
        sizes = [int(v) for v in shape.values()]
        idx = np.unravel_index(int(rank), sizes)
        return cls(dict(shape), {k: int(c) for k, c in zip(shape, idx)})


def shard_slice(full, spec: Sequence, shape: Mapping[str, int], coords: Mapping[str, int],
                offset: int = 0):
    """The block of ``full`` at ``coords`` under ``spec``: dimension
    ``offset + i`` is cut into ``shape[spec[i]]`` equal blocks and block
    ``coords[spec[i]]`` kept (a tuple entry splits over its axes row-major,
    as JAX does).  ``offset`` skips leading dimensions the spec does not
    cover (an agent axis).  A view for tensors and numpy arrays alike."""
    index = [slice(None)] * len(full.shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        n, c = 1, 0
        for a in names:
            n, c = n * int(shape[a]), c * int(shape[a]) + int(coords[a])
        size = full.shape[offset + i]
        if size % n:
            raise ValueError(f"dimension {offset + i} of {tuple(full.shape)} does not split "
                             f"into {n} blocks ({spec})")
        k = size // n
        index[offset + i] = slice(c * k, (c + 1) * k)
    return full[tuple(index)]


def path_names(path) -> List[str]:
    """The keys of a parameter path as strings: a tuple of keys (strings,
    or JAX's path entries with a ``key``) or a dotted name."""
    if isinstance(path, str):
        return path.split(".")
    return [str(getattr(k, "key", k)) for k in path]


def tree_map_with_path(fn, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over nested mappings, the same nesting returned;
    a key with dots counts as that many path entries (so ``{dotted name:
    leaf}`` maps like the nested tree it names)."""
    if not isinstance(tree, Mapping):
        return fn(prefix, tree)
    return {k: tree_map_with_path(fn, v, prefix + tuple(str(k).split(".")))
            for k, v in tree.items()}


def local_shard(full, spec: Sequence, mesh, offset: int = 0):
    """This rank's block of ``full`` under ``spec`` on ``mesh`` (a
    :class:`GridMesh`, an :class:`AgentMesh` or a :class:`MeshPosition`)."""
    return shard_slice(full, spec, mesh.shape, mesh.coords, offset)


@dataclasses.dataclass
class TransportClock:
    """Seconds and bytes of the transport's legs on this rank: device to
    host, the exchange or collective itself, host to device."""

    d2h_s: float = 0.0
    exchange_s: float = 0.0
    h2d_s: float = 0.0
    bytes_sent: int = 0

    def reset(self) -> None:
        self.d2h_s = self.exchange_s = self.h2d_s = 0.0
        self.bytes_sent = 0


class AgentMesh:
    """One agent a rank over the default process group.

    ``ranks[i]`` is the global rank that holds agent ``i``; this rank's
    agent is :attr:`agent`, its tensors live on :attr:`device` (``cuda:<local>``
    on a card, ``cpu`` for CPU ranks).  ``axis_name`` and :attr:`shape`
    mirror the reference's one-axis ``Mesh``.  With ``group`` (a process
    subgroup of exactly ``ranks``, as :class:`GridMesh` makes) the mesh
    spans those ranks only: its collectives run on the subgroup and its
    messages go to the global ranks of ``ranks``."""

    def __init__(self, ranks: Sequence[int], device, *, axis_name: str = "agents",
                 group=None):
        if not dist.is_initialized():
            raise RuntimeError("AgentMesh needs the process group: call multihost.initialize")
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in ranks)
        world = dist.get_world_size()
        if group is None and sorted(self.ranks) != list(range(world)):
            raise ValueError(f"ranks {self.ranks} must cover the {world} "
                             "ranks of the group once each")
        if group is not None and (len(set(self.ranks)) != len(self.ranks)
                                  or not all(0 <= r < world for r in self.ranks)):
            raise ValueError(f"ranks {self.ranks} must be distinct ranks of the {world}")
        self.group = group
        self.size = len(self.ranks)
        self.rank = dist.get_rank()
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not in the mesh's ranks {self.ranks}")
        self.agent = self.ranks.index(self.rank)
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.backend = dist.get_backend()
        # gloo moves CPU tensors: a card's messages pass through pinned host buffers.
        self.staged = self.device.type == "cuda" and self.backend == "gloo"
        self.axis_name = axis_name
        self.clock = TransportClock()
        self._pinned: Dict[Tuple, torch.Tensor] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_name: self.size}

    @property
    def coords(self) -> Dict[str, int]:
        return {self.axis_name: self.agent}

    def __repr__(self) -> str:
        return (f"AgentMesh(agent {self.agent} of {self.size}, rank {self.rank}, "
                f"{self.backend}, {self.device})")

    # -- host staging ------------------------------------------------------ #
    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host buffer of ``like``'s shape and dtype, kept per
        ``key`` (pinning is slow; the rounds reuse their buffers)."""
        k = (key, tuple(like.shape), like.dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_wire(self, tensors: List[torch.Tensor], tag: str) -> List[torch.Tensor]:
        """The tensors as the backend takes them: pinned host copies when
        staged (one device-to-host copy each), else themselves."""
        if not self.staged:
            return [t.contiguous() for t in tensors]
        t0 = time.perf_counter()
        out = []
        for i, t in enumerate(tensors):
            buf = self._host((tag, i), t)
            buf.copy_(t)
            out.append(buf)
        self.clock.d2h_s += time.perf_counter() - t0
        return out

    def _from_wire(self, wire: List[torch.Tensor], dst: List[torch.Tensor]) -> None:
        if not self.staged:
            for w, d in zip(wire, dst):
                if w is not d:
                    d.copy_(w)
            return
        t0 = time.perf_counter()
        for w, d in zip(wire, dst):
            d.copy_(w)
        self._sync()
        self.clock.h2d_s += time.perf_counter() - t0

    # -- point to point ------------------------------------------------------ #
    def exchange(self, sends: Sequence[Tuple[int, torch.Tensor]],
                 recvs: Sequence[Tuple[int, torch.Tensor]]) -> None:
        """Send each ``(agent, tensor)`` of ``sends`` to that agent and
        receive each ``(agent, tensor)`` of ``recvs`` from it, posted as one
        ``batch_isend_irecv`` (sends first, then receives, in the order
        given: every rank posts its side of a pair in the same order).  A
        tensor sent twice is staged once."""
        if not sends and not recvs:
            return
        uniq: Dict[int, int] = {}
        send_list: List[torch.Tensor] = []
        for _, t in sends:
            if id(t) not in uniq:
                uniq[id(t)] = len(send_list)
                send_list.append(t)
        wire_send = self._to_wire(send_list, "send")
        recv_dst = [t for _, t in recvs]
        if self.staged:
            wire_recv = [self._host(("recv", i), t) for i, t in enumerate(recv_dst)]
        else:
            wire_recv = [t if t.is_contiguous() else torch.empty_like(t) for t in recv_dst]
        ops = [dist.P2POp(dist.isend, wire_send[uniq[id(t)]], self.ranks[a])
               for a, t in sends]
        ops += [dist.P2POp(dist.irecv, w, self.ranks[a]) for (a, _), w in zip(recvs, wire_recv)]
        t0 = time.perf_counter()
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.clock.exchange_s += time.perf_counter() - t0
        self.clock.bytes_sent += sum(t.numel() * t.element_size() for _, t in sends)
        self._from_wire(wire_recv, recv_dst)

    # -- collectives --------------------------------------------------------- #
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the agents (``"sum"`` or ``"max"``), in place."""
        wire, = self._to_wire([t], "reduce")
        self.clock.bytes_sent += t.numel() * t.element_size()
        t0 = time.perf_counter()
        dist.all_reduce(wire, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self.group)
        self.clock.exchange_s += time.perf_counter() - t0
        self._from_wire([wire], [t])
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every agent's ``t`` stacked on a new leading axis in agent order
        (an ``(n, ...)`` tensor on this rank's device)."""
        wire, = self._to_wire([t], "gather")
        self.clock.bytes_sent += t.numel() * t.element_size()
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        t0 = time.perf_counter()
        dist.all_gather(parts, wire, group=self.group)
        self.clock.exchange_s += time.perf_counter() - t0
        # A subgroup numbers its ranks in ascending global order.
        order = sorted(self.ranks)
        by_agent = [parts[order.index(r)] for r in self.ranks]
        out = torch.empty((self.size,) + tuple(t.shape), dtype=t.dtype, device=self.device)
        self._from_wire(by_agent, list(out.unbind(0)))
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (leading dimension ``size * k``) summed over the agents,
        and this agent's block of ``k`` rows of the sum: one
        ``reduce_scatter``, staged through one pinned host buffer as
        :meth:`all_reduce` is (block ``i`` goes to agent ``i``)."""
        if t.shape[0] % self.size:
            raise ValueError(f"leading dimension {t.shape[0]} does not split over "
                             f"{self.size} agents")
        wire, = self._to_wire([t], "rscatter")
        self.clock.bytes_sent += t.numel() * t.element_size()
        blocks = list(wire.chunk(self.size))
        order = sorted(self.ranks)  # a subgroup numbers its ranks in ascending global order
        inputs = [blocks[self.ranks.index(r)] for r in order]
        recv = (self._host(("rscatter_out",), blocks[0]) if self.staged
                else torch.empty_like(blocks[0]))
        t0 = time.perf_counter()
        dist.reduce_scatter(recv, inputs, op=dist.ReduceOp.SUM, group=self.group)
        self.clock.exchange_s += time.perf_counter() - t0
        out = torch.empty(blocks[0].shape, dtype=t.dtype, device=self.device)
        self._from_wire([recv], [out])
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Agent ``src``'s ``t`` on every rank, in place."""
        wire, = self._to_wire([t], "bcast")
        t0 = time.perf_counter()
        dist.broadcast(wire, src=self.ranks[src], group=self.group)
        self.clock.exchange_s += time.perf_counter() - t0
        self._from_wire([wire], [t])
        return t

    def all_to_all(self, chunks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """``chunks[i]`` sent to agent ``i``; returns the chunks received,
        ``out[i]`` from agent ``i`` (this agent's own chunk kept as it is).
        One exchange with every other agent, so it stages as
        :meth:`exchange` does (gloo's ``all_to_all`` takes CPU tensors)."""
        if len(chunks) != self.size:
            raise ValueError(f"{len(chunks)} chunks for {self.size} agents")
        out = [c if i == self.agent else torch.empty_like(c, memory_format=torch.contiguous_format)
               for i, c in enumerate(chunks)]
        others = [i for i in range(self.size) if i != self.agent]
        self.exchange([(i, chunks[i].contiguous()) for i in others], [(i, out[i]) for i in others])
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


class GridMesh:
    """Ranks on named axes, row-major (the last axis varies fastest):
    ``GridMesh({"agents": 2, "seq": 2}, device)`` over 4 ranks puts agent
    ``a``'s row on ranks ``2a`` and ``2a + 1``.  ``grid[axis]`` is the
    :class:`AgentMesh` of this rank's line along ``axis``; :attr:`coords`
    its position on every axis.  Every rank creates every line's
    subgroup, axis by axis and line by line in the same order, as
    ``torch.distributed.new_group`` asks."""

    def __init__(self, shape: Mapping[str, int], device):
        if not dist.is_initialized():
            raise RuntimeError("GridMesh needs the process group: call multihost.initialize")
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in shape.items()}
        sizes = list(self.shape.values())
        world = dist.get_world_size()
        if math.prod(sizes) != world:
            raise ValueError(f"mesh shape {self.shape} needs {math.prod(sizes)} ranks, the "
                             f"group has {world}")
        self.rank = dist.get_rank()
        grid = np.arange(world).reshape(sizes)
        self.coords: Dict[str, int] = {
            k: int(c) for k, c in zip(self.shape, np.unravel_index(self.rank, sizes))}
        device = torch.device(device)
        self.axes: Dict[str, AgentMesh] = {}
        for ax, name in enumerate(self.shape):
            lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self.axes[name] = AgentMesh(ranks, device, axis_name=name, group=group)
        self.device = self.axes[next(iter(self.shape))].device

    def __contains__(self, axis: str) -> bool:
        return axis in self.axes

    def __getitem__(self, axis: str) -> AgentMesh:
        if axis not in self.axes:
            raise KeyError(f"mesh has no axis {axis!r} (axes {tuple(self.shape)})")
        return self.axes[axis]

    def __repr__(self) -> str:
        return f"GridMesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


# ---------------------------------------------------------------------- #
# Collectives with autograd (model parallelism inside one replica)        #
# ---------------------------------------------------------------------- #
class _CopyToAxis(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous().clone(), "sum"), None


class _ReduceFromAxis(torch.autograd.Function):
    """Megatron's g: the partial products summed over the axis, the
    gradient passed through."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x.contiguous().clone(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlongAxis(torch.autograd.Function):
    """Every agent's ``x`` concatenated along ``dim`` in agent order; the
    gradient of this agent's block is the sum over the agents of theirs
    (one ``reduce_scatter``)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return torch.cat(mesh.all_gather(x.contiguous()).unbind(0), dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        blocks = torch.stack(g.chunk(mesh.size, ctx.dim))
        return mesh.reduce_scatter(blocks)[0], None, None


def copy_to_axis(x: torch.Tensor, mesh: AgentMesh) -> torch.Tensor:
    """Enter a region whose ranks along ``mesh`` each compute a part from
    the same ``x``: ``x`` itself forward, its gradient summed over the
    ranks backward.  Every rank of the line must call it in the same
    order."""
    return _CopyToAxis.apply(x, mesh)


def reduce_from_axis(x: torch.Tensor, mesh: AgentMesh) -> torch.Tensor:
    """Leave such a region: the ranks' partial ``x`` summed (one
    ``all_reduce``), the gradient passed through unchanged."""
    return _ReduceFromAxis.apply(x, mesh)


def gather_along_axis(x: torch.Tensor, mesh: AgentMesh, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (one ``all_gather``);
    the gradient of this rank's block is the sum of the ranks' gradients
    of it (one ``reduce_scatter``)."""
    return _GatherAlongAxis.apply(x, mesh, dim)


def _rank_devices() -> List[RankDevice]:
    """Every rank's (host, slice, rank), gathered: the host is the rank's
    ``GROUP_RANK`` (torchrun's node index) or 0."""
    mine = RankDevice(int(os.environ.get("GROUP_RANK", "0")), None, dist.get_rank())
    out: List[Optional[RankDevice]] = [None] * dist.get_world_size()
    dist.all_gather_object(out, tuple(mine))
    return [RankDevice(*d) for d in out]


def hybrid_agent_mesh(n_agents: Optional[int] = None, *, device=None,
                      axis_name: str = "agents") -> AgentMesh:
    """The agent mesh over every rank, agents in ring order (host, slice,
    rank; :func:`order_devices_for_ring`), so adjacent agents share a host
    where they can.  ``device`` is this rank's (default: the card of its
    local rank).  With ``n_agents`` set it must equal the world size: one
    agent a rank."""
    order = order_devices_for_ring(_rank_devices())
    n = n_agents or len(order)
    if n != len(order):
        raise ValueError(f"{n} agents on {len(order)} ranks: the port puts one agent on each rank")
    if device is None:
        from distributed_learning_tpu_torch.device import resolve_device

        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = resolve_device(f"cuda:{local % max(torch.cuda.device_count(), 1)}"
                                if torch.cuda.is_available() else None)
    return AgentMesh([d.id for d in order], device, axis_name=axis_name)


def process_local_agents(mesh: AgentMesh, *, axis_name: str = "agents") -> Sequence[int]:
    """Agent indices held by this process: the set its data pipeline must
    feed (one agent a rank, so this rank's agent)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"mesh has no axis {axis_name!r}")
    return (mesh.agent,)
