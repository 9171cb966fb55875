"""Host -> device input pipeline: background prefetch + epoch streaming
(port of ``distributed_learning_tpu/data/prefetch.py``).

The trainer keeps every shard resident on the device and gathers batches
there; this module is the path for datasets that do not fit.  A daemon
thread stages the next ``size`` batches: it copies each array into
pinned host memory and starts a ``non_blocking`` copy to the card on a
side CUDA stream, so the transfer runs under the current step instead of
before it.  The consumer's stream waits on the copy's event before the
batch is handed out.  The JAX version uses ``jax.device_put`` for the
same purpose.  The consumer counts the reference's ``data.prefetch.*``
metrics on the default registry: the ``depth`` gauge (batches staged
when it asks for the next), the ``consumer_wait_s`` counter (seconds it
waited for one) and the ``batches`` counter.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.obs.registry import get_registry

__all__ = ["prefetch_to_device", "epoch_batches"]

_SENTINEL = object()


def _map(fn, item):
    """Apply ``fn`` to every array leaf of a tuple / list / dict tree."""
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, v) for v in item)
    return fn(item)


def prefetch_to_device(
    iterator: Iterable[Any],
    *,
    size: int = 2,
    device=None,
) -> Iterator[Any]:
    """Yield items from ``iterator`` as tensors on ``device`` (the card
    unless ``"cpu"`` is asked for), with ``size`` batches staged ahead.

    Items are arrays or tensors, or tuples / lists / dicts of them.
    Exceptions raised by the source iterator reach the consumer at the
    matching position; the thread stops once the consumer stops.
    """
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    dev = resolve_device(device)
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    q: "queue.Queue[Any]" = queue.Queue(maxsize=size)
    stop = threading.Event()

    def _put(item) -> bool:
        # Bounded-wait put so an abandoned consumer (early `break`)
        # releases the thread instead of pinning staged batches.
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def stage(arr):
        t = torch.as_tensor(np.asarray(arr)) if not isinstance(arr, torch.Tensor) else arr
        if stream is None:
            return t.to(dev)
        with torch.cuda.stream(stream):
            return t.pin_memory().to(dev, non_blocking=True)

    def producer():
        try:
            for item in iterator:
                staged = _map(stage, item)
                ready = None
                if stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(stream)
                if not _put((staged, ready)):
                    return
        except BaseException as e:  # propagate into the consumer
            _put((_SENTINEL, e))
            return
        _put((_SENTINEL, None))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    reg = get_registry()
    try:
        while True:
            reg.gauge("data.prefetch.depth", q.qsize())
            t_wait = time.perf_counter()
            item, ready = q.get()
            reg.inc("data.prefetch.consumer_wait_s", time.perf_counter() - t_wait)
            if item is _SENTINEL:
                if ready is not None:
                    raise ready
                return
            reg.inc("data.prefetch.batches")
            if ready is not None:
                current = torch.cuda.current_stream(dev)
                current.wait_event(ready)

                def hand_over(x):
                    # The copy was allocated on the side stream; tell the
                    # allocator the consumer's stream uses it now.
                    x.record_stream(current)
                    return x

                item = _map(hand_over, item)
            yield item
    finally:
        stop.set()


def epoch_batches(
    X: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    seed: Optional[int] = None,
    drop_remainder: bool = True,
) -> Iterator[tuple]:
    """Shuffled ``(x_batch, y_batch)`` host batches for one epoch.

    Always shuffles: ``seed`` makes the permutation reproducible (pass
    the epoch number for a distinct deterministic order per epoch);
    ``seed=None`` draws a fresh one.  Compose with
    :func:`prefetch_to_device`::

        for xb, yb in prefetch_to_device(epoch_batches(X, y, 256, seed=epoch)):
            ...
    """
    n = X.shape[0]
    if y.shape[0] != n:
        raise ValueError(f"X has {n} rows but y has {y.shape[0]}")
    idx = np.arange(n)
    np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        take = idx[start:start + batch_size]
        yield X[take], y[take]
