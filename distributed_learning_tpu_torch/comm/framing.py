"""Length-prefixed binary framing over asyncio streams (port of
``distributed_learning_tpu/comm/framing.py``: the same frames).

Parity: ``utils/consensus_tcp/pickled_socket.py:3-23``
(``PickledSocketWrapper``: 16-byte little-endian length header + pickled
payload).  This replacement keeps the same role — ``send(msg)`` /
``recv()`` over an asyncio stream — with a safe frame:

    u32 body_len | u8 version | u8 msg_type | u16 reserved |
    body | u32 crc32(body)

No pickle anywhere; bodies are the typed messages of ``protocol.py`` and
the crc (native codec when available) rejects torn or corrupt frames.
"""

from __future__ import annotations

import asyncio
import errno
import struct
from typing import Callable, Optional, Tuple

import numpy as np

from distributed_learning_tpu_torch import native
from distributed_learning_tpu_torch.comm.protocol import Message, pack_message, unpack_message
from distributed_learning_tpu_torch.obs import get_registry

__all__ = [
    "FramedStream",
    "FrameError",
    "FrameTimeout",
    "open_framed_connection",
]

#: v2: value-bearing bodies (ValueResponse*/AsyncValue/AsyncPoke) carry
#: the trace-context trailer of ``protocol.TraceContext`` — a layout
#: change, so v1 peers must be rejected at the frame header.
#: Cross-checked against ``native/wire.cpp``'s ``kWireVersion`` and
#: ``dlt_abi.h``'s ``DLT_WIRE_VERSION`` by
#: tests/torch_port/test_torch_wire.py — bump all three together.
WIRE_VERSION = 2
_HEADER = struct.Struct("<IBBH")
MAX_FRAME = 1 << 31  # 2 GiB: a full WRN-28-10 f32 vector is ~146 MB

#: OS errors a send may legitimately retry: the kernel was momentarily
#: out of buffer/queue space or the call was interrupted.  Connection
#: teardown errnos (ECONNRESET, EPIPE, ...) are NOT here on purpose —
#: retrying a dead socket only delays the death notice the caller's
#: heal path needs.
TRANSIENT_ERRNOS = frozenset(
    {errno.EAGAIN, errno.EWOULDBLOCK, errno.EINTR, errno.ENOBUFS}
)


class FrameError(ConnectionError):
    """Corrupt or protocol-violating frame."""


class FrameTimeout(TimeoutError):
    """``recv(timeout=...)`` expired while waiting for the NEXT frame to
    begin.  The stream is still healthy: ``readexactly`` consumes its
    bytes atomically (partial data stays in the reader's buffer), so the
    read simply resumes on the next ``recv`` call.  Deliberately NOT a
    ConnectionError — multiplexers/heal paths must not evict a live
    stream over a quiet period."""


class FramedStream:
    """``send(Message)`` / ``recv() -> Message`` over one TCP connection.

    Per-stream ``bytes_sent``/``bytes_received``/``frames_sent``/
    ``frames_received`` count whole frames (header + body + crc) — the
    "bytes framed" wire-volume metric; the totals also aggregate into
    the default obs registry (``comm.bytes_framed_out/in``,
    ``comm.frames_out/in``).

    When the owner labels the stream with its directed ``edge``
    (``(local_token, peer_token)``, set by ``ConsensusAgent`` at
    neighbor-install time), every frame is additionally attributed to
    that edge: ``comm.edge.bytes_out/<local>-><peer>``,
    ``comm.edge.frames_out/...``, the mirrored ``bytes_in``/
    ``frames_in`` under the reverse direction, and
    ``comm.edge.retries/...`` — the per-edge wire observatory
    (``obs/aggregate.py:edge_profile_from_registry``).  ``obs`` is an
    optional second registry (the owning agent's private one) the same
    counters mirror into so they ride the agent's telemetry deltas."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        *,
        send_retries: int = 0,
        retry_base_s: float = 0.02,
        retry_jitter_frac: float = 0.0,
        retry_seed: int = 0,
        on_retry: Optional[Callable[[], None]] = None,
    ):
        self.reader = reader
        self.writer = writer
        self._send_lock = asyncio.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0
        self.frames_sent = 0
        self.frames_received = 0
        # Bounded exponential-backoff retry of transient socket errors on
        # send (TRANSIENT_ERRNOS): attempt k sleeps retry_base_s * 2**k,
        # stretched by up to retry_jitter_frac (decorrelates retry storms
        # across streams sharing a congested kernel).  The jitter is a
        # pure function of (retry_seed, attempt) — the FaultPlan
        # counter-keyed rng idiom — so a retry schedule replays
        # bit-identically; 0.0 keeps the exact legacy powers-of-two schedule.
        # 0 retries = fail on first error (the pre-async behavior).
        # on_retry is the owner's counter hook (ConsensusAgent wires
        # comm.agent.retries).
        self.send_retries = int(send_retries)
        self.retry_base_s = float(retry_base_s)
        self.retry_jitter_frac = float(retry_jitter_frac)
        self.retry_seed = int(retry_seed)
        self.on_retry = on_retry
        # Directed-edge attribution (set post-construction by the owner
        # once the peer's token is known, e.g. after the Register
        # handshake): (local_token, peer_token), plus an optional extra
        # registry the edge counters mirror into.
        self.edge: Optional[Tuple[str, str]] = None
        self.obs = None

    def _edge_inc(self, name: str, forward: bool, v: float = 1.0) -> None:
        if self.edge is None:
            return
        a, b = self.edge if forward else (self.edge[1], self.edge[0])
        full = f"{name}/{a}->{b}"
        get_registry().inc(full, v)
        if self.obs is not None:
            self.obs.inc(full, v)

    @property
    def peername(self):
        return self.writer.get_extra_info("peername")

    def _retry_delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based).  Deterministic:
        the jitter draw is keyed on (retry_seed, attempt) exactly like
        ``FaultPlan.decide`` keys on (seed, frame index), never on
        shared-rng call order."""
        delay = self.retry_base_s * (2 ** attempt)
        if self.retry_jitter_frac:
            u = np.random.default_rng(
                [self.retry_seed, attempt]
            ).random()
            delay *= 1.0 + self.retry_jitter_frac * u
        return delay

    async def send(self, msg: Message) -> None:
        code, body = pack_message(msg)
        if len(body) > MAX_FRAME:
            raise FrameError(f"frame of {len(body)} bytes exceeds {MAX_FRAME}")
        crc = native.crc32(body)
        header = _HEADER.pack(len(body), WIRE_VERSION, code, 0)
        nbytes = len(header) + len(body) + 4
        async with self._send_lock:
            attempt = 0
            while True:
                try:
                    self.writer.write(header + body + struct.pack("<I", crc))
                    await self.writer.drain()
                    break
                except OSError as e:
                    transient = (
                        e.errno in TRANSIENT_ERRNOS
                        and not isinstance(e, ConnectionError)
                    )
                    if not transient or attempt >= self.send_retries:
                        raise
                    get_registry().inc("comm.frame_retries")
                    self._edge_inc("comm.edge.retries", forward=True)
                    if self.on_retry is not None:
                        self.on_retry()
                    await asyncio.sleep(self._retry_delay_s(attempt))
                    attempt += 1
        self.bytes_sent += nbytes
        self.frames_sent += 1
        reg = get_registry()
        reg.inc("comm.bytes_framed_out", nbytes)
        reg.inc("comm.frames_out")
        self._edge_inc("comm.edge.bytes_out", forward=True, v=nbytes)
        self._edge_inc("comm.edge.frames_out", forward=True)

    async def recv(self, timeout: Optional[float] = None) -> Message:
        if timeout is None:
            header = await self.reader.readexactly(_HEADER.size)
        else:
            # Frame-boundary timeout only: readexactly consumes its bytes
            # atomically (accumulated data stays buffered on cancel), so
            # an expiry here leaves the stream intact and retryable —
            # FrameTimeout, not FrameError.  Once the header is consumed
            # the frame must complete; a peer that wedges MID-frame is
            # indistinguishable from corruption and surfaces below as a
            # ConnectionError from the transport, never a torn decode
            # (the crc rejects those).
            try:
                header = await asyncio.wait_for(
                    self.reader.readexactly(_HEADER.size), timeout
                )
            except asyncio.TimeoutError:
                raise FrameTimeout(
                    f"no frame started within {timeout}s"
                ) from None
        length, version, code, _ = _HEADER.unpack(header)
        if version != WIRE_VERSION:
            raise FrameError(f"wire version {version} != {WIRE_VERSION}")
        if length > MAX_FRAME:
            raise FrameError(f"frame of {length} bytes exceeds {MAX_FRAME}")
        body = await self.reader.readexactly(length)
        (crc,) = struct.unpack("<I", await self.reader.readexactly(4))
        if native.crc32(body) != crc:
            raise FrameError("frame checksum mismatch")
        self.bytes_received += _HEADER.size + length + 4
        self.frames_received += 1
        reg = get_registry()
        reg.inc("comm.bytes_framed_in", _HEADER.size + length + 4)
        reg.inc("comm.frames_in")
        self._edge_inc(
            "comm.edge.bytes_in", forward=False,
            v=_HEADER.size + length + 4,
        )
        self._edge_inc("comm.edge.frames_in", forward=False)
        return unpack_message(code, body)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass

    async def wait_closed(self) -> None:
        try:
            await self.writer.wait_closed()
        except Exception:
            pass


async def open_framed_connection(
    host: str, port: int, *, retries: int = 20, delay: float = 0.1,
    send_retries: int = 0, retry_jitter_frac: float = 0.0,
    retry_seed: int = 0, on_retry: Optional[Callable[[], None]] = None,
) -> FramedStream:
    """Connect with retry (peers race to start their servers)."""
    last: Optional[Exception] = None
    for _ in range(retries):
        try:
            reader, writer = await asyncio.open_connection(host, port)
            return FramedStream(
                reader, writer,
                send_retries=send_retries,
                retry_jitter_frac=retry_jitter_frac,
                retry_seed=retry_seed, on_retry=on_retry,
            )
        except OSError as e:
            last = e
            await asyncio.sleep(delay)
    raise ConnectionError(f"cannot connect to {host}:{port}: {last}")
