"""Deterministic fault injection for the comm stack (port of
``distributed_learning_tpu/comm/faults.py``: the same decisions from the
same seed, the same frames through the port's native crc).

Every survival claim this repo makes — crc rejection of torn frames
(``framing.py``), validate-before-scatter (``tensor_codec.py`` /
``native/wire.cpp``), straggler-tolerant async rounds
(``async_runtime.py``), elastic membership healing (``master.py``) —
was built against failure modes that nothing in the repo could actually
*produce* on demand.  This module closes that gap: a seeded, replayable
:class:`FaultPlan` decides per frame index whether to drop, duplicate,
reorder, corrupt (two flavors — see below), delay, or byzantine-mutate
the frame, and :class:`FaultyStream` applies those decisions while
speaking the real wire format through the real transport, so the
production receive path is exercised end-to-end.

Corruption flavors map to the two rejection layers:

* ``corrupt`` (wire-level) flips body bytes AFTER the crc is stamped —
  the receiver's checksum fails:
  :class:`~distributed_learning_tpu_torch.comm.framing.FrameError`
  (a ConnectionError: the multiplexer evicts the stream, the async
  runtime's heal path takes over).
* ``truncate`` (payload-level) removes tail bytes BEFORE the crc is
  stamped — the frame arrives checksum-clean but structurally invalid,
  driving the codec's validate-before-scatter path:
  :class:`~distributed_learning_tpu_torch.comm.tensor_codec.CodecError`,
  counted and dropped at the multiplexer service point, stream intact
  (the length-prefixed framing stays aligned: the body was fully
  consumed before decode).

Determinism: every decision is a pure function of ``(seed, frame
index)`` (a per-index :func:`numpy.random.default_rng` stream), so the
same plan replays the identical fault schedule — the property the
determinism tests in ``tests/torch_port/test_torch_comm_faults.py`` pin.

Delays are applied through ``asyncio.sleep`` and carry no wall-clock
state, so a plan replays the same way under any event-loop clock.

The reference's transport (``utils/consensus_tcp/pickled_socket.py``)
has no failure injection at all — its failure story is whatever pickle
does with a torn byte stream; this harness is the framework's addition
the ROADMAP's fleet-churn item builds on.
"""

from __future__ import annotations

import asyncio
import dataclasses
import struct
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from distributed_learning_tpu_torch import native
from distributed_learning_tpu_torch.comm import protocol as P
from distributed_learning_tpu_torch.comm.framing import (
    _HEADER,
    WIRE_VERSION,
    FramedStream,
)
from distributed_learning_tpu_torch.obs import get_registry

__all__ = [
    "FaultDecision",
    "FaultPlan",
    "FaultyStream",
    "inject_neighbor_faults",
    "lying_fields_mutator",
    "poison_value_mutator",
]


#: Exclusive per-frame fault kinds, in decision priority order.
_KINDS = (
    "drop", "corrupt", "truncate", "dup", "reorder", "byzantine"
)


class FaultDecision(NamedTuple):
    """What the plan does to ONE outgoing frame: an exclusive ``kind``
    (``"none"`` or one of drop / corrupt / truncate / dup / reorder /
    byzantine / crash) plus an independent bounded ``delay_s``."""

    kind: str = "none"
    delay_s: float = 0.0


class FaultPlan:
    """Seeded, replayable per-frame fault schedule.

    Probabilities are exclusive (at most one kind per frame, chosen by
    one uniform draw against cumulative thresholds, in :data:`_KINDS`
    order); ``delay_p``/``delay_max_s`` is an independent bounded hold
    before the frame is written (straggler storms).  ``crash_at``
    overrides everything from that send index on: the transport is torn
    down abruptly (mid-round agent crash).  ``mutate`` is the byzantine
    arm's message transform (default:
    :func:`lying_fields_mutator` — protocol-field lies the async
    runtime's validation must catch).
    """

    def __init__(
        self,
        seed: int,
        *,
        drop_p: float = 0.0,
        corrupt_p: float = 0.0,
        truncate_p: float = 0.0,
        dup_p: float = 0.0,
        reorder_p: float = 0.0,
        byzantine_p: float = 0.0,
        delay_p: float = 0.0,
        delay_max_s: float = 0.0,
        crash_at: Optional[int] = None,
        mutate: Optional[Callable[[int, Any], Any]] = None,
    ):
        probs = {
            "drop": drop_p, "corrupt": corrupt_p,
            "truncate": truncate_p, "dup": dup_p,
            "reorder": reorder_p, "byzantine": byzantine_p,
        }
        for name, p in probs.items():
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name}_p must be in [0, 1], got {p}")
        if sum(probs.values()) > 1.0:
            raise ValueError(
                "fault probabilities must sum to <= 1 (kinds are "
                f"exclusive per frame), got {sum(probs.values())}"
            )
        if not 0.0 <= delay_p <= 1.0:
            raise ValueError(f"delay_p must be in [0, 1], got {delay_p}")
        self.seed = int(seed)
        self.probs = probs
        self.delay_p = float(delay_p)
        self.delay_max_s = float(delay_max_s)
        self.crash_at = None if crash_at is None else int(crash_at)
        self.mutate = mutate if mutate is not None else lying_fields_mutator

    def decide(self, index: int) -> FaultDecision:
        """The decision for frame ``index`` — a pure function of
        ``(seed, index)``, so replays are bit-identical regardless of
        timing or interleaving."""
        if self.crash_at is not None and index >= self.crash_at:
            return FaultDecision(kind="crash")
        rng = np.random.default_rng([self.seed, int(index)])
        u, v, w = rng.random(3)
        kind = "none"
        acc = 0.0
        for name in _KINDS:
            acc += self.probs[name]
            if u < acc:
                kind = name
                break
        delay = self.delay_max_s * w if v < self.delay_p else 0.0
        return FaultDecision(kind=kind, delay_s=delay)

    def schedule(self, n: int) -> List[FaultDecision]:
        """The first ``n`` decisions — the replayable schedule the
        determinism tests compare across plan instances."""
        return [self.decide(i) for i in range(n)]

    def corrupt_bytes(self, index: int, body: bytes) -> bytes:
        """Wire-level corruption: flip one deterministically-chosen byte
        (applied after the crc is stamped -> receiver FrameError)."""
        if not body:
            return body
        rng = np.random.default_rng([self.seed, int(index), 1])
        pos = int(rng.integers(0, len(body)))
        mask = int(rng.integers(1, 256))
        return body[:pos] + bytes([body[pos] ^ mask]) + body[pos + 1:]

    def truncate_bytes(self, index: int, body: bytes) -> bytes:
        """Payload-level corruption: cut a deterministic tail slice
        (applied BEFORE the crc is stamped -> checksum-clean frame whose
        decode fails structurally: CodecError, never a scatter)."""
        if len(body) <= 1:
            return body
        rng = np.random.default_rng([self.seed, int(index), 2])
        # Keep at least 1 byte, drop at least 1: always structurally
        # short for the codec's length validation.
        keep = int(rng.integers(1, len(body)))
        return body[:keep]

    def wrap(self, stream: FramedStream, *, peer: str = "",
             edge: str = "") -> "FaultyStream":
        return FaultyStream(stream, self, peer=peer, edge=edge)


def lying_fields_mutator(index: int, msg: Any) -> Any:
    """Default byzantine mutation: protocol-field lies on AsyncValue
    pushes — alternating an absurdly-far-future round claim, a
    backwards round counter, and a negative staleness — exactly the
    violations :class:`~distributed_learning_tpu_torch.comm.async_runtime.
    AsyncGossipRunner`'s wire validation must reject."""
    if not isinstance(msg, P.AsyncValue):
        return msg
    arm = index % 3
    if arm == 0:
        return dataclasses.replace(msg, round_id=2 ** 40)
    if arm == 1:
        return dataclasses.replace(msg, round_id=-1)
    return dataclasses.replace(msg, staleness=-7)


def poison_value_mutator(
    scale: float = 1e6,
) -> Callable[[int, Any], Any]:
    """Byzantine VALUE mutation: a well-formed frame carrying a poisoned
    payload (``value * scale``) — invisible to wire validation, the case
    the robust mixing programs (``parallel/robust.py``) exist for."""

    def mutate(index: int, msg: Any) -> Any:
        if isinstance(msg, P.AsyncValue):
            return dataclasses.replace(
                msg, value=np.asarray(msg.value, np.float32) * scale
            )
        return msg

    return mutate


class FaultyStream:
    """A :class:`FramedStream` lookalike whose ``send`` routes every
    frame through a :class:`FaultPlan`.

    Speaks the real wire format onto the inner stream's transport, so
    the receiving side runs the production path end-to-end (framing crc,
    codec validation, multiplexer eviction/drop accounting).  ``recv``
    and everything else delegate to the inner stream — wrap the sender's
    side of an edge to inject into the peer's receive path.

    Visible state: ``send_index`` (frames offered so far), ``events``
    (``(index, kind)`` log, the replay-assertion surface), ``counters``
    (per-kind tallies, also mirrored into the obs registry as
    ``comm.faults.<kind>`` — plus ``comm.faults.<kind>/<edge>`` and a
    ``comm.fault`` registry event carrying (fault, peer, frame_index,
    round) when the wrapper knows its edge, so every injected decision
    is attributable in the merged run log and the per-edge profile).
    """

    def __init__(self, inner: FramedStream, plan: FaultPlan, *,
                 peer: str = "", edge: str = ""):
        self.inner = inner
        self.plan = plan
        self.peer = peer
        self.edge = edge  # directed "src->dst" label, "" when unknown
        self.send_index = 0
        self.events: List[Tuple[int, str]] = []
        self.counters: Dict[str, int] = {}
        self._held: Optional[bytes] = None  # reorder buffer (one frame)
        self._round: Optional[int] = None  # round_id of the frame in flight

    def _note(self, index: int, kind: str) -> None:
        if kind == "none":
            return
        self.events.append((index, kind))
        self.counters[kind] = self.counters.get(kind, 0) + 1
        reg = get_registry()
        reg.inc(f"comm.faults.{kind}")
        if self.edge:
            reg.inc(f"comm.faults.{kind}/{self.edge}")
        reg.event(
            "comm.fault", fault=kind, peer=self.peer,
            frame_index=index, round=self._round, edge=self.edge,
        )

    def _encode(self, msg: Any, decision: FaultDecision, index: int) -> bytes:
        code, body = P.pack_message(msg)
        if decision.kind == "truncate":
            body = self.plan.truncate_bytes(index, body)
        crc = native.crc32(body)
        if decision.kind == "corrupt":
            body = self.plan.corrupt_bytes(index, body)
        header = _HEADER.pack(len(body), WIRE_VERSION, code, 0)
        return header + body + struct.pack("<I", crc)

    async def _write(self, frame: bytes) -> None:
        async with self.inner._send_lock:
            self.inner.writer.write(frame)
            await self.inner.writer.drain()
        self.inner.bytes_sent += len(frame)
        self.inner.frames_sent += 1

    async def send(self, msg: Any) -> None:
        index = self.send_index
        self.send_index += 1
        decision = self.plan.decide(index)
        self._round = getattr(msg, "round_id", None)
        self._note(index, decision.kind)
        if decision.kind == "crash":
            # Mid-round agent crash: abrupt transport teardown — the
            # peer sees an incomplete read, the master a death sentinel.
            self.inner.close()
            raise ConnectionResetError("fault-injected crash")
        if decision.kind == "byzantine":
            msg = self.plan.mutate(index, msg)
        if decision.delay_s > 0.0:
            self._note(index, "delay")
            await asyncio.sleep(decision.delay_s)
        if decision.kind == "drop":
            return
        frame = self._encode(msg, decision, index)
        if decision.kind == "reorder" and self._held is None:
            # Swap-with-next: held until the next frame is written.  (A
            # trailing reorder on a stream that then goes quiet stays
            # held — inherent to swapping with a frame that never comes.)
            self._held = frame
            return
        await self._write(frame)
        if self._held is not None:
            held, self._held = self._held, None
            await self._write(held)
        if decision.kind == "dup":
            await self._write(frame)

    async def recv(self, timeout: Optional[float] = None) -> Any:
        return await self.inner.recv(timeout)

    def close(self) -> None:
        self._held = None
        self.inner.close()

    async def wait_closed(self) -> None:
        await self.inner.wait_closed()

    def __getattr__(self, name: str) -> Any:
        # Counter/introspection passthrough (bytes_sent, peername, ...):
        # the wrapper must be drop-in wherever a FramedStream is held.
        return getattr(self.inner, name)


def inject_neighbor_faults(
    agent: Any, token: str, plan: FaultPlan
) -> FaultyStream:
    """Wrap ``agent``'s installed stream to ``token`` so every frame the
    agent pushes to that neighbor routes through ``plan`` — the
    one-liner the breakdown tests use to turn a healthy in-process
    deployment into a byzantine one.  Returns the wrapper (its
    ``events``/``counters`` are the assertion surface)."""
    stream = agent._neighbors[token]
    wrapped = plan.wrap(
        stream, peer=token, edge=f"{agent.token}->{token}"
    )
    agent._neighbors[token] = wrapped
    return wrapped
