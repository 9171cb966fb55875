"""Async select() over many framed sockets (port of
``distributed_learning_tpu/comm/multiplexer.py``).

Parity: ``utils/consensus_tcp/psocket_multiplexer.py:7-36``
(``PSocketMultiplexer``): an async iterator yielding
``(token, message, stream)`` from whichever registered socket produces a
frame first, built on ``asyncio.wait(FIRST_COMPLETED)`` with pending reads
carried between iterations (:19-31).
"""

from __future__ import annotations

import asyncio
from typing import AsyncIterator, Dict, Hashable, Optional, Tuple

from distributed_learning_tpu_torch.comm.framing import FramedStream
from distributed_learning_tpu_torch.comm.protocol import Message
from distributed_learning_tpu_torch.comm.tensor_codec import CodecError
from distributed_learning_tpu_torch.obs import get_registry

__all__ = ["StreamMultiplexer"]


class StreamMultiplexer:
    """``async for token, msg, stream in mux:`` over a dynamic socket set."""

    def __init__(self, streams: Optional[Dict[Hashable, FramedStream]] = None):
        self._streams: Dict[Hashable, FramedStream] = dict(streams or {})
        # token -> (read task, the stream that task reads).  Tracking the
        # stream alongside the task keeps replacement safe: an error from a
        # read on a since-replaced stream must not evict the replacement.
        self._pending: Dict[Hashable, tuple] = {}
        self._closed = False
        # Set by add(): wakes a parked __anext__ so a stream registered
        # mid-wait (e.g. an elastic rejoin) gets its read armed immediately
        # instead of after the next unrelated frame.
        self._wake: asyncio.Event = asyncio.Event()

    def add(self, token: Hashable, stream: FramedStream) -> None:
        self._streams[token] = stream
        self._wake.set()

    def remove(self, token: Hashable) -> None:
        self._streams.pop(token, None)
        entry = self._pending.pop(token, None)
        if entry is not None:
            entry[0].cancel()

    def tokens(self):
        return tuple(self._streams)

    def close(self) -> None:
        self._closed = True
        for task, _ in self._pending.values():
            task.cancel()
        self._pending.clear()
        self._wake.set()  # unpark a waiter blocked on an empty stream set

    def __aiter__(self) -> AsyncIterator[Tuple[Hashable, Optional[Message], Optional[FramedStream]]]:
        return self

    async def __anext__(self):
        """Yields ``(token, msg, stream)``; a dead peer yields
        ``(token, None, dead_stream)`` exactly once so the caller can decide
        how to handle the loss (silently shrinking the set would leave
        callers waiting on a response count that can never be reached; the
        dead stream's identity lets the caller tell a stale death notice
        from the current stream's — e.g. after an elastic rejoin replaced
        it)."""
        while True:
            if self._closed:
                raise StopAsyncIteration
            for token, stream in self._streams.items():
                if (
                    token not in self._pending
                    or self._pending[token][1] is not stream
                ):
                    stale = self._pending.pop(token, None)
                    if stale is not None:
                        stale[0].cancel()
                    task = asyncio.ensure_future(stream.recv())
                    # Retrieve exceptions even if this task outlives every
                    # __anext__ call (e.g. connection dies after close()).
                    task.add_done_callback(
                        lambda t: t.exception() if not t.cancelled() else None
                    )
                    self._pending[token] = (task, stream)
            self._wake.clear()
            wake = asyncio.ensure_future(self._wake.wait())
            try:
                # Waiting on wake alongside the reads means an empty set
                # parks (streams may be added later — e.g. before agents
                # register, or awaiting an elastic rejoin) instead of
                # stopping, and a mid-wait add() re-arms immediately.
                done, _ = await asyncio.wait(
                    [t for t, _ in self._pending.values()] + [wake],
                    return_when=asyncio.FIRST_COMPLETED,
                )
            finally:
                wake.cancel()
            for token in list(self._pending):
                task, src = self._pending[token]
                if task in done:
                    del self._pending[token]
                    try:
                        msg = task.result()
                    except CodecError:
                        # Checksum-clean frame whose body failed the
                        # codec's validate-before-scatter checks: the
                        # framing consumed the whole frame before decode,
                        # so the stream is still aligned — drop the frame
                        # with a counter and keep the peer (its next push
                        # is independently validated).  Torn/corrupt
                        # frames (crc, version) raise FrameError instead,
                        # a ConnectionError: eviction below.
                        get_registry().inc("comm.frames_rejected")
                        continue
                    except (asyncio.IncompleteReadError, ConnectionError, OSError):
                        # Evict only if the erroring stream is still the
                        # registered one (not an already-replaced corpse).
                        if self._streams.get(token) is src:
                            self._streams.pop(token, None)
                        return token, None, src
                    return token, msg, self._streams.get(token, src)
