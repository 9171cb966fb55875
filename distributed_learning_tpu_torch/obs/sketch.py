"""Mergeable metric sketches: log-bucketed quantile sketches and
bounded-cardinality label rollups — the fleet-scale obs primitives.

The port's own copy of ``distributed_learning_tpu/obs/sketch.py``, which
imports no JAX either; only import paths and the names of the JAX
package's files differ.

The run-wide plane (PR 6/14) kept raw per-agent point lists and took
nearest-rank percentiles over them, so aggregator memory, delta bytes,
and report cost all grew with agents × samples, and ring eviction
silently biased long-run percentiles.  At the scale the sharded-master
ROADMAP item targets (1000+ agents; the efficiency constraints of
arxiv.org/pdf/2002.01119), per-sample anything is a non-starter.  This
module provides the two constant-size, exactly-mergeable summaries the
hierarchical plane (``obs/aggregate.py`` payload v2) ships instead:

* :class:`QuantileSketch` — a DDSketch-style log-bucketed quantile
  sketch: values land in geometric buckets ``(γ^(k-1), γ^k]`` with
  ``γ = (1+α)/(1-α)``, so any quantile reconstructs within **relative
  error α** (default 1%).  Merging is bucket-wise count addition —
  *exact*, associative, and commutative: merging 500 agents' sketches
  in any order or grouping yields byte-identical state, which is what
  makes aggregate-of-aggregates (agent → sub-aggregator → root) safe.
  Size is O(buckets touched) — bounded by the data's dynamic range and
  the hard ``key_bound`` clamp, never by the sample count.
* :class:`LabelRollup` — a bounded-cardinality ``label -> total``
  counter map: past ``max_labels`` distinct labels the smallest entries
  fold deterministically into an explicit ``other`` bucket (fold order:
  ascending ``(total, label)``).  Total mass is preserved *exactly*;
  only the per-label attribution of the folded tail is coarsened, and
  the fold is disclosed (``other_labels``).  This is how a
  sub-aggregator forwards per-agent counter dimensions without the
  upstream delta growing with its pod size.

Both encode to compact JSON-able dicts (sorted, delta-encoded integer
bucket keys — varint-friendly and byte-identical for equal state) and
round-trip through :meth:`to_dict` / :meth:`from_dict`.

Everything here is host-side, jax-free, and deterministic: no wall
clocks, no RNG, no platform-hashed iteration order.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = ["DEFAULT_ALPHA", "QuantileSketch", "LabelRollup"]

#: Default relative-error bound α: reconstructed quantiles are within
#: ±1% of the exact nearest-rank value (for values inside the clamp
#: range).  1% is far below the ≥2x effects the straggler/edge
#: profiles exist to surface.
DEFAULT_ALPHA = 0.01

#: Default hard bucket-key clamp: keys are confined to
#: ``[-key_bound, key_bound]``, so a hostile or degenerate stream
#: (denormals, 1e300 outliers) cannot grow the bucket map without
#: bound.  With α=1% this still spans ~±e^82 ≈ 1e35 in magnitude;
#: values beyond the clamp land in the edge bucket (α no longer holds
#: for them, but ``min``/``max`` stay exact and merge stays exact).
DEFAULT_KEY_BOUND = 4096


class QuantileSketch:
    """Log-bucketed quantile sketch with exact merge.

    Positive values bucket by ``k = ceil(log_γ(v))``; negative values
    bucket their magnitude into a separate map; exact zeros count in a
    dedicated bucket.  ``n``/``sum``/``min``/``max`` ride along exactly,
    so ``mean`` is exact and ``quantile(0)``/``quantile(1)`` return the
    true extremes.
    """

    __slots__ = ("alpha", "gamma", "key_bound", "_lg",
                 "n", "sum", "min", "max", "zeros", "buckets", "neg")

    def __init__(self, alpha: float = DEFAULT_ALPHA, *,
                 key_bound: int = DEFAULT_KEY_BOUND):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0, 1), got {alpha}")
        self.alpha = float(alpha)
        self.gamma = (1.0 + self.alpha) / (1.0 - self.alpha)
        self.key_bound = int(key_bound)
        self._lg = math.log(self.gamma)
        self.n = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.zeros = 0
        self.buckets: Dict[int, int] = {}
        self.neg: Dict[int, int] = {}

    # ------------------------------------------------------------------ #
    def _key(self, mag: float) -> int:
        """Bucket key of a positive magnitude: the k with
        ``γ^(k-1) < mag <= γ^k``, clamped to ``±key_bound``.  The libm
        ``log`` is followed by a boundary correction so the assignment
        is exactly consistent with the ``γ**k`` bounds used by
        :meth:`quantile` — a value can never straddle its bucket edge
        because of rounding."""
        k = math.ceil(math.log(mag) / self._lg)
        if abs(k) <= self.key_bound:
            while k > -self.key_bound and self.gamma ** (k - 1) >= mag:
                k -= 1
            while k < self.key_bound and self.gamma ** k < mag:
                k += 1
        return max(-self.key_bound, min(self.key_bound, k))

    def add(self, value: float, count: int = 1) -> None:
        """Fold ``count`` occurrences of ``value`` into the sketch."""
        value = float(value)
        count = int(count)
        if count <= 0 or math.isnan(value):
            return
        self.n += count
        self.sum += value * count
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if value == 0.0:
            self.zeros += count
        elif value > 0.0:
            k = self._key(value)
            self.buckets[k] = self.buckets.get(k, 0) + count
        else:
            k = self._key(-value)
            self.neg[k] = self.neg.get(k, 0) + count

    def extend(self, values: Iterable[float]) -> None:
        for v in values:
            self.add(v)

    # ------------------------------------------------------------------ #
    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """In-place exact merge (bucket-wise addition); returns self.

        Raises ``ValueError`` on an α/clamp mismatch — two sketches
        with different bucket geometry have no exact merge, and an
        approximate one would silently void the error bound."""
        if (other.alpha != self.alpha
                or other.key_bound != self.key_bound):
            raise ValueError(
                "sketch geometry mismatch: "
                f"alpha {self.alpha} vs {other.alpha}, "
                f"key_bound {self.key_bound} vs {other.key_bound}"
            )
        self.n += other.n
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        self.zeros += other.zeros
        for k, c in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + c
        for k, c in other.neg.items():
            self.neg[k] = self.neg.get(k, 0) + c
        return self

    def copy(self) -> "QuantileSketch":
        out = QuantileSketch(self.alpha, key_bound=self.key_bound)
        out.merge(self)
        return out

    # ------------------------------------------------------------------ #
    def _estimate(self, key: int, negative: bool) -> float:
        """Representative value of a bucket: ``2γ^k / (1+γ)``, the
        point whose relative distance to every value in the bucket is
        <= α; clamped into ``[min, max]`` (exact extremes can only
        tighten the bound)."""
        est = 2.0 * (self.gamma ** key) / (1.0 + self.gamma)
        if negative:
            est = -est
        return max(self.min, min(self.max, est))

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile estimate, within relative error α of
        the exact nearest-rank value (for in-clamp values)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        if self.n == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = max(1, math.ceil(q * self.n))
        seen = 0
        # Ascending value order: most-negative first (descending
        # magnitude keys), then zeros, then positives (ascending keys).
        for k in sorted(self.neg, reverse=True):
            seen += self.neg[k]
            if seen >= rank:
                return self._estimate(k, negative=True)
        if self.zeros:
            seen += self.zeros
            if seen >= rank:
                return 0.0
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if seen >= rank:
                return self._estimate(k, negative=False)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def count_le(self, x: float) -> int:
        """Approximate count of values <= ``x`` (a bucket straddling
        ``x`` counts fully iff its representative is <= ``x``) — the
        histogram reconstruction the profile renderers use."""
        x = float(x)
        total = 0
        for k, c in self.neg.items():
            if self._estimate(k, negative=True) <= x:
                total += c
        if x >= 0.0:
            total += self.zeros
        for k, c in self.buckets.items():
            if self._estimate(k, negative=False) <= x:
                total += c
        return total

    def histogram(self, bounds: Iterable[float]) -> List[List[float]]:
        """``[upper_bound, count]`` rows over ascending ``bounds``
        (last may be +inf); empty rows are omitted — the same shape as
        the exact-path ``_hist`` in ``obs/aggregate.py``."""
        rows: List[List[float]] = []
        prev = 0
        for ub in bounds:
            cum = self.n if math.isinf(ub) else self.count_le(ub)
            if cum - prev:
                rows.append([ub, cum - prev])
            prev = cum
        return rows

    # ------------------------------------------------------------------ #
    @staticmethod
    def _pack_buckets(buckets: Mapping[int, int]) -> Tuple[list, list]:
        """Sorted keys delta-encoded (first absolute, then gaps — small
        non-negative ints, varint-friendly) + parallel counts."""
        keys = sorted(buckets)
        dk = [
            k if i == 0 else k - keys[i - 1]
            for i, k in enumerate(keys)
        ]
        return dk, [buckets[k] for k in keys]

    @staticmethod
    def _unpack_buckets(dk: list, counts: list) -> Dict[int, int]:
        out: Dict[int, int] = {}
        key = 0
        for i, (d, c) in enumerate(zip(dk, counts)):
            key = d if i == 0 else key + d
            out[key] = int(c)
        return out

    def to_dict(self) -> dict:
        """Compact deterministic encoding: equal state encodes to an
        equal dict (``json.dumps(..., sort_keys=True)`` is then
        byte-identical)."""
        d: Dict[str, Any] = {
            "a": self.alpha, "kb": self.key_bound, "n": self.n,
        }
        if self.n:
            d["sum"] = self.sum
            d["min"] = self.min
            d["max"] = self.max
        if self.zeros:
            d["z"] = self.zeros
        if self.buckets:
            d["k"], d["c"] = self._pack_buckets(self.buckets)
        if self.neg:
            d["nk"], d["nc"] = self._pack_buckets(self.neg)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "QuantileSketch":
        out = cls(
            float(d.get("a", DEFAULT_ALPHA)),
            key_bound=int(d.get("kb", DEFAULT_KEY_BOUND)),
        )
        out.n = int(d.get("n", 0))
        if out.n:
            out.sum = float(d.get("sum", 0.0))
            out.min = float(d.get("min", math.inf))
            out.max = float(d.get("max", -math.inf))
        out.zeros = int(d.get("z", 0))
        out.buckets = cls._unpack_buckets(
            d.get("k") or [], d.get("c") or []
        )
        out.neg = cls._unpack_buckets(
            d.get("nk") or [], d.get("nc") or []
        )
        return out

    # ------------------------------------------------------------------ #
    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, QuantileSketch):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __len__(self) -> int:
        return len(self.buckets) + len(self.neg) + (1 if self.zeros else 0)

    def __repr__(self) -> str:
        return (
            f"QuantileSketch(alpha={self.alpha}, n={self.n}, "
            f"buckets={len(self)})"
        )


# ---------------------------------------------------------------------- #
class LabelRollup:
    """Bounded-cardinality ``label -> total`` counter map.

    ``add``/``merge`` accumulate exactly; past ``max_labels`` distinct
    labels the smallest entries (ascending ``(total, label)`` — fully
    deterministic) fold into the ``other`` bucket.  ``total()`` is
    exact regardless; the fold only coarsens per-label attribution of
    the tail, and ``other_labels`` says how many labels it absorbed —
    the bound is disclosed, never silent.
    """

    __slots__ = ("max_labels", "counts", "other", "other_labels")

    def __init__(self, max_labels: int = 64):
        if max_labels < 1:
            raise ValueError("max_labels must be >= 1")
        self.max_labels = int(max_labels)
        self.counts: Dict[str, float] = {}
        self.other = 0.0
        self.other_labels = 0

    def add(self, label: str, value: float = 1.0) -> None:
        self.counts[str(label)] = (
            self.counts.get(str(label), 0.0) + float(value)
        )
        self._bound()

    def merge(self, other: "LabelRollup") -> "LabelRollup":
        """In-place merge; total mass adds exactly.  ``max_labels``
        tightens to the smaller of the two bounds."""
        self.max_labels = min(self.max_labels, other.max_labels)
        for label, value in other.counts.items():
            self.counts[label] = self.counts.get(label, 0.0) + value
        self.other += other.other
        self.other_labels += other.other_labels
        self._bound()
        return self

    def _bound(self) -> None:
        while len(self.counts) > self.max_labels:
            label = min(self.counts, key=lambda l: (self.counts[l], l))
            self.other += self.counts.pop(label)
            self.other_labels += 1

    # ------------------------------------------------------------------ #
    def total(self) -> float:
        return sum(self.counts.values()) + self.other

    def top(self, k: Optional[int] = None) -> List[Tuple[str, float]]:
        """Labels by descending total (ties broken by label)."""
        rows = sorted(
            self.counts.items(), key=lambda kv: (-kv[1], kv[0])
        )
        return rows if k is None else rows[:k]

    def copy(self) -> "LabelRollup":
        out = LabelRollup(self.max_labels)
        out.counts = dict(self.counts)
        out.other = self.other
        out.other_labels = self.other_labels
        return out

    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        d: Dict[str, Any] = {
            "m": self.max_labels,
            "l": {k: self.counts[k] for k in sorted(self.counts)},
        }
        if self.other:
            d["o"] = self.other
        if self.other_labels:
            d["on"] = self.other_labels
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "LabelRollup":
        out = cls(int(d.get("m", 64)))
        for label, value in (d.get("l") or {}).items():
            out.counts[str(label)] = float(value)
        out.other = float(d.get("o", 0.0))
        out.other_labels = int(d.get("on", 0))
        out._bound()
        return out

    def __eq__(self, other: Any) -> bool:
        if not isinstance(other, LabelRollup):
            return NotImplemented
        return self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return (
            f"LabelRollup(labels={len(self.counts)}, "
            f"other={self.other}, max={self.max_labels})"
        )
