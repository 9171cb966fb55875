"""Fault flight recorder: a bounded per-agent ring of recent events,
dumped to a JSONL artifact the moment something goes wrong.

The port's own copy of ``distributed_learning_tpu/obs/flight.py``, which
imports no JAX either; only import paths and the names of the JAX
package's files differ.

The failure modes this repo has actually hit — an agent dying mid-round
(``comm.master.rounds_aborted``), the device link wedging for
hours, a master tearing the deployment down with a reason —
all used to leave behind a counter increment and nothing else.  The
recorder keeps the last ``capacity`` events *per agent* (telemetry
deltas, gossip round spans, series points, free-form notes) in memory,
and :meth:`trigger` writes them all to one ``flight-NNN-<reason>.jsonl``
file: every abort ships its own black box.

Everything is host-side and jax-free.  The rings are deques, recording
is a lock + append, and the only IO is the dump itself — which runs on
the failure path, where a few milliseconds of file writing is free.

Wired by the run-wide plane (``obs/aggregate.py`` feeds every merged
per-agent event in; the JAX package's ``comm/master.py`` notes control-plane transitions
and fires the triggers: round abort, agent death, round-deadline
expiry, shutdown-with-reason).  Usable standalone too: ``record`` /
``note`` / ``trigger`` have no comm dependencies.
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import Any, Dict, List, Mapping, Optional

__all__ = ["FlightRecorder"]

_SLUG_RE = re.compile(r"[^A-Za-z0-9_.-]+")


class FlightRecorder:
    """Bounded ring of the last ``capacity`` events per agent, dumped to
    JSONL on demand.

    Parameters
    ----------
    directory:
        Where dump artifacts land (created if missing).
    capacity:
        Events retained per agent (ring: oldest evicted first).
    global_capacity:
        Optional cap on TOTAL retained events across all agents — the
        fleet-scale memory bound.  Past it, every agent's effective
        ring length shrinks proportionally
        (``max(8, global_capacity // n_agents)``, never above
        ``capacity``), so 500 churning agents cannot multiply the
        recorder's footprint 500x; the shed tail counts into the same
        per-agent eviction ledger the dumps disclose.  ``None`` (the
        default) keeps the pre-fleet behavior: per-agent rings only.
    clock:
        Wall-clock source for dump/note timestamps — wall clock on
        purpose: artifacts from different processes must line up on one
        timeline, which process-local monotonic clocks cannot give.
    """

    def __init__(self, directory: str, *, capacity: int = 256,
                 global_capacity: Optional[int] = None,
                 clock=time.time):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.capacity = int(capacity)
        self.global_capacity = (
            None if global_capacity is None else int(global_capacity)
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {}
        self._dropped: Dict[str, int] = {}
        self._dumps = 0
        #: Paths of every artifact written so far (newest last).
        self.dumped: List[str] = []

    def _per_agent_capacity(self, n_agents: int) -> int:
        """Effective ring length at ``n_agents`` under the global cap."""
        if self.global_capacity is None or n_agents <= 0:
            return self.capacity
        share = max(8, self.global_capacity // n_agents)
        return min(self.capacity, share)

    def _resize_rings_locked(self, cap: int) -> None:
        """Shrink/regrow every ring to ``cap`` (deques are recreated —
        maxlen is immutable); the tail shed by a shrink counts as
        evictions, same ledger as ring overwrites."""
        for agent, ring in list(self._rings.items()):
            if ring.maxlen == cap:
                continue
            shed = max(0, len(ring) - cap)
            if shed:
                self._dropped[agent] = (
                    self._dropped.get(agent, 0) + shed
                )
            self._rings[agent] = collections.deque(ring, maxlen=cap)

    # ------------------------------------------------------------------ #
    def record(self, agent: str, event: Mapping[str, Any]) -> None:
        """Append one event dict to ``agent``'s ring."""
        agent = str(agent)
        with self._lock:
            ring = self._rings.get(agent)
            if ring is None:
                cap = self._per_agent_capacity(len(self._rings) + 1)
                # A new agent may tighten everyone's share (no-op
                # whenever the cap did not actually change).
                self._resize_rings_locked(cap)
                ring = self._rings[agent] = collections.deque(
                    maxlen=cap
                )
            cap = ring.maxlen if ring.maxlen is not None else self.capacity
            if len(ring) >= cap:
                self._dropped[agent] = self._dropped.get(agent, 0) + 1
            ring.append(dict(event))

    def note(self, agent: str, name: str, **fields: Any) -> None:
        """Free-form timestamped event (the master's control-plane
        transitions use this under the ``<master>`` pseudo-agent)."""
        ev = {"ts": self._clock(), "kind": "event", "name": name}
        ev.update(fields)
        self.record(agent, ev)

    # ------------------------------------------------------------------ #
    def trigger(self, reason: str, **context: Any) -> str:
        """Dump every agent's ring to one JSONL artifact; returns its
        path.

        Line 1 is a header ``{"kind": "flight", "reason": ..., ...}``
        with the trigger context; each following line is one retained
        event tagged with its ``"agent"``.  The rings are snapshotted
        under the lock and KEPT (not cleared): a second fault shortly
        after the first still has its full window, and overlapping
        dumps are cheap."""
        with self._lock:
            self._dumps += 1
            seq = self._dumps
            snapshot = {
                agent: list(ring) for agent, ring in self._rings.items()
            }
            dropped = dict(self._dropped)
        slug = _SLUG_RE.sub("-", reason).strip("-") or "fault"
        path = os.path.join(
            self.directory, f"flight-{seq:03d}-{slug}.jsonl"
        )
        header = {
            "kind": "flight",
            "reason": reason,
            "ts": self._clock(),
            "agents": sorted(snapshot),
            "events": sum(len(v) for v in snapshot.values()),
            "capacity": self.capacity,
        }
        if self.global_capacity is not None:
            header["global_capacity"] = self.global_capacity
        if dropped:
            header["ring_evictions"] = dropped
        header.update(context)
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(header, sort_keys=True, default=str) + "\n")
            for agent in sorted(snapshot):
                for ev in snapshot[agent]:
                    line = {"agent": agent}
                    line.update(ev)
                    fh.write(json.dumps(line, sort_keys=True, default=str)
                             + "\n")
        with self._lock:
            self.dumped.append(path)
        return path

    # ------------------------------------------------------------------ #
    def snapshot(self) -> dict:
        """The recorder's current footprint: agents tracked, configured
        caps, the effective per-agent ring length, total retained
        events (``occupancy``), and the per-agent eviction ledger —
        the visibility half of the global-cap contract."""
        with self._lock:
            n = len(self._rings)
            return {
                "agents": n,
                "capacity": self.capacity,
                "global_capacity": self.global_capacity,
                "per_agent_capacity": self._per_agent_capacity(n),
                "occupancy": sum(
                    len(r) for r in self._rings.values()
                ),
                "evictions": dict(self._dropped),
            }

    def agents(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def ring(self, agent: str) -> List[dict]:
        """A copy of ``agent``'s current ring (oldest first)."""
        with self._lock:
            return list(self._rings.get(str(agent), ()))

    @staticmethod
    def read_dump(path: str) -> tuple:
        """(header, events) from a dump artifact written by
        :meth:`trigger`."""
        with open(path, "r", encoding="utf-8") as fh:
            lines = [json.loads(l) for l in fh if l.strip()]
        if not lines or lines[0].get("kind") != "flight":
            raise ValueError(f"{path} is not a flight-recorder dump")
        return lines[0], lines[1:]
