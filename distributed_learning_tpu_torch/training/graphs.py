"""CUDA-graph capture and replay for the trainer's epoch superstep.

The reference compiles K epochs of local SGD and gossip into ONE XLA
dispatch (``distributed_learning_tpu/training/trainer.py``
``train_epochs``).  The port's counterpart is a CUDA graph: the trainer
captures one epoch's training steps once, and each gossip program once
per round count, and a superstep replays them with no host
synchronisation in between (``GossipTrainer.train_epochs``).

:class:`GraphSet` holds one trainer's graphs:

* one private memory pool and one side stream for all of them (they never
  run concurrently, and every value that outlives a replay lives in a
  buffer allocated outside the pool, so any replay order is safe);
* a warm-up of each body on the side stream before its capture (library
  handles, workspaces, the optimizer's lazily created state), in a launch
  record that is thrown away: the caller undoes the warm-up's effect on
  the training state (:class:`StateSnapshot`);
* the trainer's random generators registered with each graph, so a
  replay advances their Philox offsets as the eager calls would;
* a record of the flash-attention launches each capture made, counted
  once per replay on the kernels' counters
  (``ops/flash_attention.record_launches``), and a count of replays per
  graph;
* the same for the obs hooks (the engines' round, byte and layout
  counters): a warm-up counts into a registry that is thrown away, a
  capture into its own record (``obs/instrument.muted``), and each
  replay adds that record to the default registry
  (``obs/instrument.replay_counts``), so a replayed gossip program
  counts what its eager run would have.

A failed capture raises; nothing here falls back to the eager loop.
"""

from __future__ import annotations

import collections
import contextlib
import time
import warnings
from typing import Callable, Dict, Hashable, Iterator, List, Sequence

import torch

from distributed_learning_tpu_torch.obs.instrument import muted, replay_counts
from distributed_learning_tpu_torch.ops import flash_attention as fa

__all__ = ["GraphSet", "StateSnapshot", "count_host_syncs"]


class StateSnapshot:
    """Copies of the tensors ``state()`` returns and of the generators'
    states, to undo a warm-up.  :meth:`restore` copies each tensor back by
    identity; a tensor that ``state()`` returns now but did not at the
    snapshot (optimizer state the warm-up created lazily) is zeroed, the
    value such state starts from (torch's Adam; the port's SGD creates its
    zero momentum with the optimizer)."""

    def __init__(self, state: Callable[[], Sequence[torch.Tensor]],
                 generators: Sequence[torch.Generator]):
        self._state = state
        self._saved = {id(t): (t, t.detach().clone()) for t in state()}
        self._gens = [(g, g.get_state()) for g in generators]

    def restore(self) -> None:
        with torch.no_grad():
            for t in self._state():
                hit = self._saved.get(id(t))  # holds t, so the id is not reused
                if hit is not None:
                    t.copy_(hit[1])
                else:
                    t.zero_()
        for g, s in self._gens:
            g.set_state(s)


@contextlib.contextmanager
def count_host_syncs(device: torch.device) -> Iterator[List[int]]:
    """Count the synchronising CUDA calls made inside the block (reads of
    device values such as ``float(t)`` and ``t.cpu()``), as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them; the count is
    in ``out[0]`` after the block.  On the CPU there is nothing to count
    and ``out[0]`` stays ``None``."""
    out: List = [None]
    if device.type != "cuda":
        yield out
        return
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    syncs = ["called a synchronizing CUDA operation" in str(w.message) for w in caught]
    out[0] = sum(syncs)
    for w, sync in zip(caught, syncs):  # pass on every other warning
        if not sync:
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)


class GraphSet:
    """One trainer's captured CUDA graphs, keyed by the caller."""

    def __init__(self, device: torch.device, generators: Sequence[torch.Generator] = ()):
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
        self.device = device
        self.generators = [g for g in generators if g.device.type == "cuda"]
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Hashable, tuple] = {}
        self.replays: collections.Counter = collections.Counter()
        self.capture_seconds = 0.0

    def __contains__(self, key: Hashable) -> bool:
        return key in self._graphs

    def _on_side_stream(self, fn: Callable[[], None]) -> None:
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            fn()
        main.wait_stream(self.stream)

    def capture(self, key: Hashable, fn: Callable[[], None]) -> None:
        """Warm ``fn`` up once on the side stream, then capture it as the
        graph ``key``.  The warm-up RUNS ``fn``: the caller snapshots and
        restores the state it touches."""
        t0 = time.perf_counter()
        with fa.record_launches(), muted():  # the warm-up's work is undone
            self._on_side_stream(fn)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with fa.record_launches() as record, muted() as counted:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                fn()
        torch.cuda.synchronize(self.device)
        self._graphs[key] = (graph, record, counted)
        self.capture_seconds += time.perf_counter() - t0

    def replay(self, key: Hashable) -> None:
        """Replay graph ``key`` on the current stream; its captured kernel
        launches and obs counts count once more."""
        graph, record, counted = self._graphs[key]
        graph.replay()
        fa.count_replays(record)
        replay_counts(counted)
        self.replays[key] += 1
