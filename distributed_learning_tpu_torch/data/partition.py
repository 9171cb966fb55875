"""Non-IID partitioners: seeded label-skew and size-skew shards (port of
``distributed_learning_tpu/data/partition.py``, numpy only; the port keeps
its own copy).

The reference deals IID shards only (``torch.utils.data.random_split``
with near-equal sizes, ``Man_Colab.ipynb`` cell 16 — re-implemented as
:func:`~distributed_learning_tpu_torch.data.cifar.shard_dataset`); every
non-IID claim in the decentralized-learning literature starts from a
*skewed* deal instead.  This module provides the two standard skews as
pure-numpy, seed-deterministic partitioners with the same return
contract as ``shard_dataset`` (token -> ``(X, y)``, disjoint, covering):

* :func:`label_skew_shards` — per-agent class proportions drawn from a
  symmetric Dirichlet(alpha): alpha -> inf recovers IID, alpha -> 0
  gives near single-class agents (the FedAvg/SCAFFOLD benchmark
  convention).
* :func:`size_skew_shards` — geometric shard sizes (each agent ``ratio``
  times the previous), modelling heterogeneous data ownership; ratio=1
  recovers the near-equal deal.

Determinism: all randomness flows through one
``np.random.default_rng(seed)``, so the same ``(inputs, knobs, seed)``
reproduce the identical partition (pinned by ``tests/torch_port/test_torch_data.py``) —
the property the byzantine breakdown experiments need to be replayable.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

__all__ = ["label_skew_shards", "size_skew_shards"]


def _tokens(agents) -> List[Hashable]:
    toks = list(range(agents)) if isinstance(agents, int) else list(agents)
    if not toks:
        raise ValueError("need at least one agent")
    return toks


def _truncate(out, batch_size):
    if batch_size is not None:
        for tok, (xs, ys) in out.items():
            ln = (len(xs) // batch_size) * batch_size
            out[tok] = (xs[:ln], ys[:ln])
    return out


def label_skew_shards(
    X: np.ndarray,
    y: np.ndarray,
    agents: int | Sequence[Hashable],
    *,
    alpha: float = 0.5,
    min_per_agent: int = 1,
    seed: int = 0,
    batch_size: int | None = None,
) -> Dict[Hashable, Tuple[np.ndarray, np.ndarray]]:
    """Dirichlet label-skewed disjoint shards.

    For each class, its (shuffled) examples are split across agents by
    proportions drawn from Dirichlet(alpha, ..., alpha) — the standard
    non-IID federated benchmark deal.  Small ``alpha`` concentrates each
    class on few agents; large ``alpha`` approaches the IID deal.

    Raises ValueError when the draw leaves an agent with fewer than
    ``min_per_agent`` examples (retry with another seed or larger
    alpha) — an explicit failure beats a silently-empty shard feeding a
    degenerate gossip experiment.
    """
    if alpha <= 0.0:
        raise ValueError(f"alpha must be > 0, got {alpha}")
    toks = _tokens(agents)
    n = len(toks)
    y_arr = np.asarray(y)
    rng = np.random.default_rng(seed)
    per_agent: List[List[np.ndarray]] = [[] for _ in range(n)]
    for cls in np.unique(y_arr):
        idx = np.flatnonzero(y_arr == cls)
        rng.shuffle(idx)
        p = rng.dirichlet(np.full(n, float(alpha)))
        # Cumulative-proportion cut points; endpoints pinned so the
        # class's examples are dealt exactly once (disjoint, covering).
        cuts = np.round(np.cumsum(p) * len(idx)).astype(int)
        cuts[-1] = len(idx)
        for a, part in enumerate(np.split(idx, cuts[:-1])):
            per_agent[a].append(part)
    out: Dict[Hashable, Tuple[np.ndarray, np.ndarray]] = {}
    for a, tok in enumerate(toks):
        idx = np.concatenate(per_agent[a]) if per_agent[a] else np.array([], int)
        rng.shuffle(idx)  # mix classes within the shard
        if len(idx) < min_per_agent:
            raise ValueError(
                f"label_skew_shards(alpha={alpha}, seed={seed}) left agent "
                f"{tok!r} with {len(idx)} < {min_per_agent} examples; "
                "retry with a different seed or a larger alpha"
            )
        out[tok] = (np.asarray(X)[idx], y_arr[idx])
    return _truncate(out, batch_size)


def size_skew_shards(
    X: np.ndarray,
    y: np.ndarray,
    agents: int | Sequence[Hashable],
    *,
    ratio: float = 2.0,
    seed: int = 0,
    batch_size: int | None = None,
) -> Dict[Hashable, Tuple[np.ndarray, np.ndarray]]:
    """Geometric size-skewed disjoint shards (IID in label distribution).

    Agent ``i`` owns a shard proportional to ``ratio**i`` of the
    (seed-shuffled) data — later tokens are data-rich, earlier ones
    data-poor; ``ratio=1`` recovers the near-equal deal.  Sizes use
    largest-remainder rounding with a floor of one example per agent.
    """
    if ratio <= 0.0:
        raise ValueError(f"ratio must be > 0, got {ratio}")
    toks = _tokens(agents)
    n = len(toks)
    if len(X) < n:
        raise ValueError(f"{len(X)} examples cannot cover {n} agents")
    weights = np.power(float(ratio), np.arange(n))
    target = weights / weights.sum() * len(X)
    sizes = np.maximum(np.floor(target).astype(int), 1)
    # Largest-remainder: hand leftover rows to the largest fractional
    # parts (deterministic: np.argsort is stable on the tie-broken key).
    leftover = len(X) - int(sizes.sum())
    if leftover > 0:
        order = np.argsort(-(target - np.floor(target)), kind="stable")
        for j in order[:leftover]:
            sizes[j] += 1
    elif leftover < 0:
        order = np.argsort(sizes, kind="stable")[::-1]
        for j in order[: -leftover]:
            sizes[j] -= 1
    perm = np.random.default_rng(seed).permutation(len(X))
    out: Dict[Hashable, Tuple[np.ndarray, np.ndarray]] = {}
    start = 0
    for tok, ln in zip(toks, sizes):
        sl = perm[start : start + int(ln)]
        out[tok] = (np.asarray(X)[sl], np.asarray(y)[sl])
        start += int(ln)
    return _truncate(out, batch_size)
