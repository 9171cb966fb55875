"""Typed message protocol for the multi-process comm backend (port of
``distributed_learning_tpu/comm/protocol.py``: the same type codes and
layouts).

Parity: ``utils/consensus_tcp/protocol.py:4-84`` — the same message set and
invariants ("every request gets exactly one response"; agents talk to the
master for control and to each other for data), but messages serialize to a
fixed binary layout instead of pickle (see the reference's
``ProtoErrorException``/dataclass definitions at :15-84 and the security
note in SURVEY.md §2: pickle-over-TCP must not survive into the new
design).

Every message is a dataclass with a one-byte type code and explicit
``_pack``/``_unpack`` methods; tensors go through
:mod:`~distributed_learning_tpu_torch.comm.tensor_codec`.
"""

from __future__ import annotations

import dataclasses
import json
import struct
from typing import Any, ClassVar, Dict, List, Optional, Tuple, Type

import numpy as np

from distributed_learning_tpu_torch.comm.tensor_codec import (
    CodecError,
    decode_tensor,
    encode_tensor,
)
# The run-wide observability plane's structured Telemetry payload: a
# per-agent registry delta, marked by payload["kind"] ==
# OBS_PAYLOAD_KIND and versioned by payload["v"] == OBS_PAYLOAD_VERSION.
# The schema lives with its producer/consumer (obs/aggregate.py:
# ObsDeltaSource.pack / RunAggregator.process) and is re-exported here
# because it IS wire surface: any payload claiming the kind must follow
# the versioned layout, exactly like a message's binary fields.
from distributed_learning_tpu_torch.obs.aggregate import (  # noqa: F401
    OBS_PAYLOAD_KIND,
    OBS_PAYLOAD_SECTIONS,
    OBS_PAYLOAD_VERSION,
    is_obs_payload,
)

__all__ = [
    "Message",
    "Register",
    "Ok",
    "ErrorException",
    "Neighbor",
    "NeighborhoodData",
    "NewRoundRequest",
    "NewRoundNotification",
    "ValueRequest",
    "ValueResponse",
    "Converged",
    "NotConverged",
    "Done",
    "Shutdown",
    "Telemetry",
    "ValueResponseSparse",
    "ValueResponseFusedSparse",
    "AsyncValue",
    "AsyncPoke",
    "TraceContext",
    "TRACE_CTX_VERSION",
    "pack_message",
    "unpack_message",
    "OBS_PAYLOAD_KIND",
    "OBS_PAYLOAD_SECTIONS",
    "OBS_PAYLOAD_VERSION",
    "is_obs_payload",
]

#: Version of the trace-context trailer carried by the value-bearing
#: frames (ValueResponse*/AsyncValue/AsyncPoke).  Wire surface: the
#: layout below is cross-checked against ``native/wire.cpp``'s
#: ``kTraceCtxVersion`` and ``dlt_abi.h``'s ``DLT_TRACE_CTX_VERSION``
#: by tests/torch_port/test_torch_wire.py — bump all three together.
TRACE_CTX_VERSION = 1


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """Compact per-frame trace identity carried on the gossip wire.

    ``(run_id, origin, seq)`` names one frame fleet-uniquely: ``origin``
    is the sending agent's token and ``seq`` its per-edge frame counter,
    so the obs plane can flow-link the sender's encode/send events to
    the receiver's recv/decode/mix events for the same frame
    (``obs/spans.py`` flow events -> ``RunAggregator.to_chrome_trace``
    arrows).  ``t_wall`` is the sender's wall-clock send stamp, used by
    the receiver for per-edge wire latency (wall clock on purpose: it is
    the only clock two processes share).  Generation and round already
    travel in the host messages (``AsyncValue.round_id/generation``,
    ``ValueResponse.round_id/iteration``), so they are not duplicated
    here.

    Trailer layout (appended at the END of the host frame's body):
    ``u8 present | u32 run_id | i64 seq | f64 t_wall | str origin``.
    An absent context packs as the single byte 0, and a body with no
    trailer at all unpacks as ``trace=None`` — both directions
    round-trip ``None`` exactly.
    """

    run_id: int = 0
    origin: str = ""
    seq: int = 0
    t_wall: float = 0.0


_TRACE_FIXED = struct.Struct("<Iqd")


def _pack_trace(tc: Optional[TraceContext]) -> bytes:
    if tc is None:
        return b"\x00"
    return (
        b"\x01"
        + _TRACE_FIXED.pack(tc.run_id, tc.seq, tc.t_wall)
        + _pack_str(tc.origin)
    )


def _unpack_trace(buf: bytes, off: int) -> Optional[TraceContext]:
    if off >= len(buf) or buf[off] == 0:
        return None
    run_id, seq, t_wall = _TRACE_FIXED.unpack_from(buf, off + 1)
    origin, _ = _unpack_str(buf, off + 1 + _TRACE_FIXED.size)
    return TraceContext(
        run_id=run_id, origin=origin, seq=seq, t_wall=t_wall
    )


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ValueError("string field exceeds 64KiB")
    return struct.pack("<H", len(b)) + b


def _unpack_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<H", buf, off)
    off += 2
    return buf[off : off + n].decode("utf-8"), off + n


def _pack_tensor(x: np.ndarray, bf16_wire: bool,
                 int8_wire: bool = False) -> bytes:
    t = encode_tensor(x, bf16_wire=bf16_wire, int8_wire=int8_wire)
    return struct.pack("<I", len(t)) + t


def _unpack_tensor(buf: bytes, off: int) -> Tuple[np.ndarray, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return decode_tensor(buf[off : off + n]), off + n


@dataclasses.dataclass
class Message:
    """Base: subclasses set ``TYPE_CODE`` and implement pack/unpack."""

    TYPE_CODE: ClassVar[int] = -1

    def _pack(self) -> bytes:  # pragma: no cover - overridden
        return b""

    @classmethod
    def _unpack(cls, buf: bytes) -> "Message":  # pragma: no cover
        return cls()


@dataclasses.dataclass
class Register(Message):
    """Agent -> master (and agent -> peer) identification handshake
    (parity: ``ProtoRegister``, protocol.py:23-27 — token + listen address
    so the master/peer can route back-connections)."""

    TYPE_CODE: ClassVar[int] = 1
    token: str = ""
    host: str = ""
    port: int = 0

    def _pack(self) -> bytes:
        return _pack_str(self.token) + _pack_str(self.host) + struct.pack("<I", self.port)

    @classmethod
    def _unpack(cls, buf: bytes) -> "Register":
        token, off = _unpack_str(buf, 0)
        host, off = _unpack_str(buf, off)
        (port,) = struct.unpack_from("<I", buf, off)
        return cls(token=token, host=host, port=port)


@dataclasses.dataclass
class Ok(Message):
    """Positive acknowledgement (parity: ``ProtoOk``, protocol.py:30-32)."""

    TYPE_CODE: ClassVar[int] = 2
    info: str = ""

    def _pack(self) -> bytes:
        return _pack_str(self.info)

    @classmethod
    def _unpack(cls, buf: bytes) -> "Ok":
        info, _ = _unpack_str(buf, 0)
        return cls(info=info)


@dataclasses.dataclass
class ErrorException(Message):
    """Error report (parity: ``ProtoErrorException``, protocol.py:15-20)."""

    TYPE_CODE: ClassVar[int] = 3
    message: str = ""

    def _pack(self) -> bytes:
        return _pack_str(self.message)

    @classmethod
    def _unpack(cls, buf: bytes) -> "ErrorException":
        message, _ = _unpack_str(buf, 0)
        return cls(message=message)


@dataclasses.dataclass
class Neighbor:
    token: str
    host: str
    port: int
    weight: float


@dataclasses.dataclass
class NeighborhoodData(Message):
    """Master -> agent: neighbor addresses + per-edge mixing weights +
    self-weight + convergence eps (parity: ``ProtoNeighborhoodData``,
    protocol.py:35-39, with the SDP weights the master solves at
    ``master.py:262-266``).

    ``generation`` (this framework's addition) versions the membership
    epoch: an elastic master that re-forms the topology and re-solves W
    after a death/(re)join broadcasts a fresh NeighborhoodData with the
    counter bumped, and agents realign their weight tables to it
    mid-run (docs/async_runtime.md §Membership generations)."""

    TYPE_CODE: ClassVar[int] = 4
    self_weight: float = 0.0
    convergence_eps: float = 1e-4
    neighbors: List[Neighbor] = dataclasses.field(default_factory=list)
    generation: int = 0

    def _pack(self) -> bytes:
        out = [struct.pack("<ddH", self.self_weight, self.convergence_eps, len(self.neighbors))]
        for nb in self.neighbors:
            out.append(_pack_str(nb.token) + _pack_str(nb.host))
            out.append(struct.pack("<Id", nb.port, nb.weight))
        out.append(struct.pack("<q", self.generation))
        return b"".join(out)

    @classmethod
    def _unpack(cls, buf: bytes) -> "NeighborhoodData":
        self_w, eps, count = struct.unpack_from("<ddH", buf, 0)
        off = 18
        nbs = []
        for _ in range(count):
            token, off = _unpack_str(buf, off)
            host, off = _unpack_str(buf, off)
            port, weight = struct.unpack_from("<Id", buf, off)
            off += 12
            nbs.append(Neighbor(token=token, host=host, port=port, weight=weight))
        (gen,) = struct.unpack_from("<q", buf, off)
        return cls(
            self_weight=self_w, convergence_eps=eps, neighbors=nbs,
            generation=gen,
        )


@dataclasses.dataclass
class NewRoundRequest(Message):
    """Agent -> master: ready for a weighted consensus round with this
    sample weight (parity: ``ProtoNewRoundRequest``, protocol.py:52-55)."""

    TYPE_CODE: ClassVar[int] = 5
    weight: float = 1.0

    def _pack(self) -> bytes:
        return struct.pack("<d", self.weight)

    @classmethod
    def _unpack(cls, buf: bytes) -> "NewRoundRequest":
        (w,) = struct.unpack_from("<d", buf, 0)
        return cls(weight=w)


@dataclasses.dataclass
class NewRoundNotification(Message):
    """Master -> agents: round starts; carries the mean sample weight for
    the weighted-lift trick (parity: ``ProtoNewRoundNotification``,
    protocol.py:56-59, mean weight computed at ``master.py:145-146,165``)."""

    TYPE_CODE: ClassVar[int] = 6
    round_id: int = 0
    mean_weight: float = 1.0
    #: membership epoch this round runs under (must match the agent's).
    generation: int = 0
    #: tokens dropped from this round by a deadline-enforcing master
    #: (their edges get zero weight, mass renormalized onto self).
    dropped: List[str] = dataclasses.field(default_factory=list)

    def _pack(self) -> bytes:
        out = [
            struct.pack(
                "<qdqH",
                self.round_id, self.mean_weight, self.generation,
                len(self.dropped),
            )
        ]
        for tok in self.dropped:
            out.append(_pack_str(tok))
        return b"".join(out)

    @classmethod
    def _unpack(cls, buf: bytes) -> "NewRoundNotification":
        r, w, gen, count = struct.unpack_from("<qdqH", buf, 0)
        off = 26
        dropped = []
        for _ in range(count):
            tok, off = _unpack_str(buf, off)
            dropped.append(tok)
        return cls(
            round_id=r, mean_weight=w, generation=gen, dropped=dropped
        )


@dataclasses.dataclass
class ValueRequest(Message):
    """Agent -> neighbor: your value for (round, iteration), please
    (parity: ``ProtoRunOnceValueRequest``, protocol.py:62-65)."""

    TYPE_CODE: ClassVar[int] = 7
    round_id: int = 0
    iteration: int = 0

    def _pack(self) -> bytes:
        return struct.pack("<qq", self.round_id, self.iteration)

    @classmethod
    def _unpack(cls, buf: bytes) -> "ValueRequest":
        r, i = struct.unpack_from("<qq", buf, 0)
        return cls(round_id=r, iteration=i)


@dataclasses.dataclass
class ValueResponse(Message):
    """Neighbor -> agent: flattened value tensor for (round, iteration)
    (parity: ``ProtoRunOnceValueResponse``, protocol.py:66-69; bf16 wire
    narrowing is this framework's addition)."""

    TYPE_CODE: ClassVar[int] = 8
    round_id: int = 0
    iteration: int = 0
    value: Optional[np.ndarray] = None
    bf16_wire: bool = False
    int8_wire: bool = False
    trace: Optional[TraceContext] = None

    def _pack(self) -> bytes:
        v = self.value if self.value is not None else np.zeros(0, np.float32)
        return (
            struct.pack("<qq", self.round_id, self.iteration)
            + _pack_tensor(np.asarray(v), self.bf16_wire, self.int8_wire)
            + _pack_trace(self.trace)
        )

    @classmethod
    def _unpack(cls, buf: bytes) -> "ValueResponse":
        r, i = struct.unpack_from("<qq", buf, 0)
        value, off = _unpack_tensor(buf, 16)
        return cls(
            round_id=r, iteration=i, value=value,
            trace=_unpack_trace(buf, off),
        )


@dataclasses.dataclass
class Converged(Message):
    """Agent -> master (parity: ``ProtoConverged``, protocol.py:42-45)."""

    TYPE_CODE: ClassVar[int] = 9
    round_id: int = 0
    iteration: int = 0

    def _pack(self) -> bytes:
        return struct.pack("<qq", self.round_id, self.iteration)

    @classmethod
    def _unpack(cls, buf: bytes) -> "Converged":
        r, i = struct.unpack_from("<qq", buf, 0)
        return cls(round_id=r, iteration=i)


@dataclasses.dataclass
class NotConverged(Message):
    """Agent -> master (parity: ``ProtoNotConverged``, protocol.py:46-49)."""

    TYPE_CODE: ClassVar[int] = 10
    round_id: int = 0
    iteration: int = 0

    def _pack(self) -> bytes:
        return struct.pack("<qq", self.round_id, self.iteration)

    @classmethod
    def _unpack(cls, buf: bytes) -> "NotConverged":
        r, i = struct.unpack_from("<qq", buf, 0)
        return cls(round_id=r, iteration=i)


@dataclasses.dataclass
class Done(Message):
    """Master -> agents: round ended (parity: ``ProtoDone``,
    protocol.py:72-74).  ``aborted`` (this framework's addition) marks an
    elastic-mode abort — an agent died mid-round, values are NOT a
    consensus — as opposed to global convergence."""

    TYPE_CODE: ClassVar[int] = 11
    round_id: int = 0
    aborted: bool = False
    #: round was cut by an enforced round deadline — agents return their
    #: current (partially converged) values rather than wait any longer.
    deadline: bool = False

    def _pack(self) -> bytes:
        flags = int(self.aborted) | (int(self.deadline) << 1)
        return struct.pack("<qB", self.round_id, flags)

    @classmethod
    def _unpack(cls, buf: bytes) -> "Done":
        r, flags = struct.unpack_from("<qB", buf, 0)
        return cls(
            round_id=r, aborted=bool(flags & 1), deadline=bool(flags & 2)
        )


@dataclasses.dataclass
class Shutdown(Message):
    """Master -> agents broadcast (parity: ``ProtoShutdown``,
    protocol.py:77-79, broadcast at ``master.py:48-61``)."""

    TYPE_CODE: ClassVar[int] = 12
    reason: str = ""

    def _pack(self) -> bytes:
        return _pack_str(self.reason)

    @classmethod
    def _unpack(cls, buf: bytes) -> "Shutdown":
        reason, _ = _unpack_str(buf, 0)
        return cls(reason=reason)


@dataclasses.dataclass
class Telemetry(Message):
    """Agent -> master metrics payload, dispatched to a
    ``TelemetryProcessor`` (parity: ``ProtoTelemetry``, protocol.py:82-84,
    dispatch at ``master.py:192-199``).  The payload is JSON, not pickle."""

    TYPE_CODE: ClassVar[int] = 13
    token: str = ""
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def _pack(self) -> bytes:
        return _pack_str(self.token) + _pack_str(json.dumps(self.payload))

    @classmethod
    def _unpack(cls, buf: bytes) -> "Telemetry":
        token, off = _unpack_str(buf, 0)
        payload, _ = _unpack_str(buf, off)
        return cls(token=token, payload=json.loads(payload))


@dataclasses.dataclass
class ValueResponseSparse(Message):
    """Neighbor -> agent: a k-sparse value (e.g. a CHOCO compressed-gossip
    correction, ``parallel/compression.py``) shipped as k values + indices
    via :func:`~distributed_learning_tpu_torch.comm.tensor_codec.encode_sparse`
    instead of the dense vector.  This framework's addition — the
    reference's wire is always dense pickled numpy
    (``pickled_socket.py:12``)."""

    TYPE_CODE: ClassVar[int] = 14
    round_id: int = 0
    iteration: int = 0
    value: Optional[np.ndarray] = None
    bf16_wire: bool = False
    int8_wire: bool = False
    trace: Optional[TraceContext] = None

    def _pack(self) -> bytes:
        from distributed_learning_tpu_torch.comm.tensor_codec import encode_sparse

        v = self.value if self.value is not None else np.zeros(0, np.float32)
        t = encode_sparse(np.asarray(v), bf16_wire=self.bf16_wire,
                          int8_wire=self.int8_wire)
        return (
            struct.pack("<qqI", self.round_id, self.iteration, len(t))
            + t
            + _pack_trace(self.trace)
        )

    @classmethod
    def _unpack(cls, buf: bytes) -> "ValueResponseSparse":
        from distributed_learning_tpu_torch.comm.tensor_codec import decode_sparse

        r, i, n = struct.unpack_from("<qqI", buf, 0)
        return cls(
            round_id=r, iteration=i, value=decode_sparse(buf[20 : 20 + n]),
            trace=_unpack_trace(buf, 20 + n),
        )


@dataclasses.dataclass
class ValueResponseFusedSparse(Message):
    """Neighbor -> agent: a whole model-tree correction as ONE fused
    sparse frame — one ``indices|values`` payload per dtype bucket, flat
    positions into the ``pytree_codec.TreeSpec`` ravel
    (:func:`~distributed_learning_tpu_torch.comm.tensor_codec.encode_fused_sparse`).
    Collapses the per-leaf framing/CRC/header overhead of gossiping a
    tree leaf by leaf to one frame per round.  ``buckets`` (the
    ``TreeSpec.dtype_buckets()`` spans) is encode-side only: the frame
    is self-describing on decode.  Receive side, ``value`` is a lazy
    (but fully validated) ``tensor_codec.FusedFrame``: densify with
    ``np.asarray`` / ``densify(out=scratch)``, or skip the dense
    intermediate entirely with ``apply_into(target, scale=...)``."""

    TYPE_CODE: ClassVar[int] = 15
    round_id: int = 0
    iteration: int = 0
    value: Optional[np.ndarray] = None
    buckets: Optional[Tuple] = None
    bf16_wire: bool = False
    int8_wire: bool = False
    trace: Optional[TraceContext] = None

    def _pack(self) -> bytes:
        from distributed_learning_tpu_torch.comm.tensor_codec import (
            encode_fused_sparse,
        )

        v = self.value if self.value is not None else np.zeros(0, np.float32)
        buckets = self.buckets
        if buckets is None:
            # Degenerate single-bucket framing for spec-less callers.
            buckets = (("float32", ((0, int(np.asarray(v).size)),)),)
        t = encode_fused_sparse(
            np.asarray(v), buckets,
            bf16_wire=self.bf16_wire, int8_wire=self.int8_wire,
        )
        return (
            struct.pack("<qqI", self.round_id, self.iteration, len(t))
            + t
            + _pack_trace(self.trace)
        )

    @classmethod
    def _unpack(cls, buf: bytes) -> "ValueResponseFusedSparse":
        from distributed_learning_tpu_torch.comm.tensor_codec import FusedFrame

        r, i, n = struct.unpack_from("<qqI", buf, 0)
        # Lazy receive (zero-copy wire path): the frame is VALIDATED
        # here — CRC, section walk, bounds — so the CodecError drop
        # discipline is unchanged, but densify/scatter is deferred to
        # the consumer, which can decode into its own scratch ravel or
        # apply the sections straight onto a live target
        # (FusedFrame.apply_into).  ``np.asarray(msg.value)`` densifies
        # on demand for spec-less callers.
        return cls(
            round_id=r, iteration=i,
            value=FusedFrame(buf[20 : 20 + n]),
            trace=_unpack_trace(buf, 20 + n),
        )


#: payload encodings of an :class:`AsyncValue` frame.
_ASYNC_DENSE, _ASYNC_SPARSE, _ASYNC_FUSED = 0, 1, 2


@dataclasses.dataclass
class AsyncValue(Message):
    """Agent -> neighbor PUSH of the async gossip runtime
    (``comm/async_runtime.py``): unsolicited "here is my latest state",
    no request/response pairing.  This framework's addition — the
    reference has no asynchronous wire at all (its asyncio backend is
    still lock-step request/response, ``consensus_asyncio.py:209-312``).

    ``round_id`` is the *sender's* async round counter (receivers anchor
    staleness to their own arrival clock, so counters need no cross-agent
    alignment); ``generation`` is the membership epoch the value belongs
    to (frames from another generation are dropped); ``staleness`` stamps
    how many sender rounds old the payload already was when shipped
    (0 for a fresh push; >0 when a poke re-sends the standing published
    buffer).  ``kind`` picks the payload codec: dense
    (``encode_tensor``), k-sparse (``encode_sparse``), or fused sparse
    with per-dtype-bucket sections (``encode_fused_sparse``)."""

    TYPE_CODE: ClassVar[int] = 16
    round_id: int = 0
    generation: int = 0
    staleness: int = 0
    value: Optional[np.ndarray] = None
    kind: int = _ASYNC_DENSE
    buckets: Optional[Tuple] = None  # encode-side, fused kind only
    bf16_wire: bool = False
    int8_wire: bool = False
    trace: Optional[TraceContext] = None

    def _pack(self) -> bytes:
        from distributed_learning_tpu_torch.comm.tensor_codec import (
            encode_fused_sparse,
            encode_sparse,
        )

        v = np.asarray(
            self.value if self.value is not None else np.zeros(0, np.float32)
        )
        if self.kind == _ASYNC_SPARSE:
            t = encode_sparse(
                v, bf16_wire=self.bf16_wire, int8_wire=self.int8_wire
            )
        elif self.kind == _ASYNC_FUSED:
            buckets = self.buckets
            if buckets is None:
                buckets = (("float32", ((0, int(v.size)),)),)
            t = encode_fused_sparse(
                v, buckets,
                bf16_wire=self.bf16_wire, int8_wire=self.int8_wire,
            )
        else:
            t = encode_tensor(
                v, bf16_wire=self.bf16_wire, int8_wire=self.int8_wire
            )
        return struct.pack(
            "<qqqBI",
            self.round_id, self.generation, self.staleness,
            self.kind, len(t),
        ) + t + _pack_trace(self.trace)

    @classmethod
    def _unpack(cls, buf: bytes) -> "AsyncValue":
        from distributed_learning_tpu_torch.comm.tensor_codec import (
            DenseFrame,
            FusedFrame,
            SparseFrame,
        )

        r, gen, stale, kind, n = struct.unpack_from("<qqqBI", buf, 0)
        body = buf[29 : 29 + n]
        # Lazy receive (zero-copy wire path): construction VALIDATES
        # the payload (so unpack_message's CodecError drop discipline
        # is unchanged — a corrupt frame still dies here, on the mux
        # task, before any consumer sees it), but the densify is
        # deferred: the async runner decodes dense/sparse payloads into
        # its per-peer scratch ravel at dispatch, and fused payloads
        # scatter straight onto the CHOCO target (apply_into) with no
        # dense intermediate at all.
        if kind == _ASYNC_SPARSE:
            value = SparseFrame(body)
        elif kind == _ASYNC_FUSED:
            value = FusedFrame(body)
        else:
            value = DenseFrame(body)
        return cls(
            round_id=r, generation=gen, staleness=stale,
            value=value, kind=kind, trace=_unpack_trace(buf, 29 + n),
        )


@dataclasses.dataclass
class AsyncPoke(Message):
    """Agent -> neighbor of the async runtime: "your last value aged past
    my staleness bound — push me a fresh one when you can".  The
    re-request half of drop-and-re-request: the poked agent answers with
    an :class:`AsyncValue` at its next dispatch-loop service point
    (best-effort; a peer wedged in compute answers late by design)."""

    TYPE_CODE: ClassVar[int] = 17
    round_id: int = 0
    generation: int = 0
    trace: Optional[TraceContext] = None

    def _pack(self) -> bytes:
        return (
            struct.pack("<qq", self.round_id, self.generation)
            + _pack_trace(self.trace)
        )

    @classmethod
    def _unpack(cls, buf: bytes) -> "AsyncPoke":
        r, gen = struct.unpack_from("<qq", buf, 0)
        return cls(
            round_id=r, generation=gen, trace=_unpack_trace(buf, 16)
        )


_REGISTRY: Dict[int, Type[Message]] = {
    cls.TYPE_CODE: cls
    for cls in (
        Register, Ok, ErrorException, NeighborhoodData, NewRoundRequest,
        NewRoundNotification, ValueRequest, ValueResponse, Converged,
        NotConverged, Done, Shutdown, Telemetry, ValueResponseSparse,
        ValueResponseFusedSparse, AsyncValue, AsyncPoke,
    )
}


def pack_message(msg: Message) -> Tuple[int, bytes]:
    """-> (type_code, body) for the framing layer."""
    if type(msg).TYPE_CODE not in _REGISTRY:
        raise TypeError(f"unregistered message type {type(msg).__name__}")
    return type(msg).TYPE_CODE, msg._pack()


def unpack_message(type_code: int, body: bytes) -> Message:
    cls = _REGISTRY.get(type_code)
    if cls is None:
        raise ValueError(f"unknown message type code {type_code}")
    try:
        return cls._unpack(body)
    except CodecError:
        raise
    except (struct.error, ValueError, IndexError) as exc:
        # A checksum-clean frame whose body fails structural unpack
        # (e.g. truncated inside a fixed prefix) is the same class of
        # fault as a corrupt tensor section: surface it uniformly as
        # CodecError so receive paths drop-and-count instead of
        # crashing on a struct.error (validate-before-scatter is a
        # whole-body contract, not just the tensor payload's).
        raise CodecError(
            f"malformed {cls.__name__} body: {exc}"
        ) from None
