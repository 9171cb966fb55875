"""Titanic tabular pipeline (port of ``distributed_learning_tpu/data/
titanic.py``, numpy only; the port keeps its own copy).

Parity: the data-prep cells of
``notebooks/Titanic Consensus GD test.ipynb``.

The reference ships the Kaggle Titanic CSVs (``data/titanic/train.csv``,
891 rows) and prepares features inside the notebook (cell 2:
``prepare_dataset``) — drop Name/Ticket/Cabin/Embarked, Sex -> {-1,+1},
fill Age NaNs with the mean, scale Age and Fare by 1/100, append a bias
column, labels -> {-1,+1}; cell 4 selects
``[Pclass, Sex, Age, SibSp, Parch, Fare, _bias]`` and holds out the first
10% as the common test set; cell 12 (``split_data``) deals contiguous
near-equal shards to agents.

This module reproduces that pipeline over a CSV directory when one is
available (``DLT_TITANIC_DIR`` env var or a configured path), and otherwise
generates a synthetic dataset with the same schema and a comparable
learnable signal so tests and benchmarks run hermetically.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

__all__ = [
    "FEATURES",
    "load_titanic",
    "prepare_rows",
    "split_data",
    "synthetic_titanic",
]

FEATURES = ["Pclass", "Sex", "Age", "SibSp", "Parch", "Fare", "_bias"]

_DEFAULT_DIRS = (
    os.environ.get("DLT_TITANIC_DIR", ""),
    "data/titanic",
)


def prepare_rows(rows: List[Dict[str, str]]) -> Tuple[np.ndarray, np.ndarray]:
    """Feature prep on parsed CSV rows (parity: notebook cell 2).

    Returns ``(X, y)`` with columns in :data:`FEATURES` order and labels in
    {-1, +1}.
    """
    ages = [float(r["Age"]) for r in rows if r.get("Age")]
    age_mean = float(np.mean(ages)) if ages else 0.0
    labeled = any(r.get("Survived", "") != "" for r in rows)
    X, y = [], []
    for r in rows:
        if labeled and r.get("Survived", "") == "":
            # Keep X and y aligned: in a labeled file, a row with a blank
            # label is dropped rather than silently shifting every
            # subsequent (feature, label) pair.
            continue
        sex = 1.0 if r.get("Sex") == "male" else -1.0
        age = float(r["Age"]) if r.get("Age") else age_mean
        X.append(
            [
                float(r.get("Pclass") or 0.0),
                sex,
                age / 100.0,
                float(r.get("SibSp") or 0.0),
                float(r.get("Parch") or 0.0),
                float(r.get("Fare") or 0.0) / 100.0,
                1.0,
            ]
        )
        if labeled:
            y.append(int(r["Survived"]) * 2 - 1)
    return (
        np.asarray(X, dtype=np.float32),
        np.asarray(y, dtype=np.int32) if y else np.zeros(0, np.int32),
    )


def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def synthetic_titanic(
    n: int = 891, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Hermetic stand-in with the reference schema and a learnable signal.

    Feature marginals roughly match the real dataset; labels come from a
    fixed logistic ground truth (sex/class dominated, like the real data) so
    logreg reaches ~0.8 accuracy — keeping the recorded notebook baselines
    meaningful even without the CSVs.
    """
    rng = np.random.default_rng(seed)
    pclass = rng.choice([1.0, 2.0, 3.0], size=n, p=[0.24, 0.21, 0.55])
    sex = rng.choice([1.0, -1.0], size=n, p=[0.65, 0.35])
    age = np.clip(rng.normal(29.7, 14.5, size=n), 0.4, 80.0) / 100.0
    sibsp = rng.poisson(0.5, size=n).astype(np.float32)
    parch = rng.poisson(0.4, size=n).astype(np.float32)
    fare = np.clip(rng.lognormal(2.9, 1.0, size=n), 0.0, 512.0) / 100.0
    X = np.stack(
        [pclass, sex, age, sibsp, parch, fare, np.ones(n)], axis=1
    ).astype(np.float32)
    logits = -1.3 * sex - 0.9 * (pclass - 2.0) - 1.5 * age + 1.2 * fare - 0.3
    prob = 1.0 / (1.0 + np.exp(-logits))
    y = (rng.random(n) < prob).astype(np.int32) * 2 - 1
    return X, y


def titanic_source(data_dir: str | None = None) -> str:
    """Which dataset :func:`load_titanic` would use: ``"real:<dir>"`` or
    ``"synthetic"``.  Benchmarks record this so synthetic-fallback results
    can never masquerade as real-data evidence."""
    dirs = [data_dir] if data_dir else [d for d in _DEFAULT_DIRS if d]
    for d in dirs:
        if os.path.exists(os.path.join(d, "train.csv")):
            return f"real:{d}"
    return "synthetic"


def load_titanic(
    data_dir: str | None = None, *, test_fraction: float = 0.1
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(X_train, y_train, X_test, y_test)`` with the notebook's split:
    the first ``test_fraction`` of rows is the common test set (cell 4).

    Reads ``train.csv`` from ``data_dir`` or the first existing default
    directory; falls back to :func:`synthetic_titanic`.
    """
    source = titanic_source(data_dir)
    if source.startswith("real:"):
        X, y = prepare_rows(_read_csv(os.path.join(source[5:], "train.csv")))
    else:
        X, y = synthetic_titanic()
    n_test = int(len(X) * test_fraction)
    return X[n_test:], y[n_test:], X[:n_test], y[:n_test]


def split_data(
    X: np.ndarray,
    y: np.ndarray,
    agents: int | Sequence[Hashable],
) -> Dict[Hashable, Tuple[np.ndarray, np.ndarray]]:
    """Deal contiguous near-equal shards to agents (parity: notebook cell
    12 ``split_data`` — remainder rows land on the *later* shards, e.g.
    802 rows over 5 agents -> [160, 160, 160, 161, 161])."""
    tokens = list(range(agents)) if isinstance(agents, int) else list(agents)
    num = len(tokens)
    result: Dict[Hashable, Tuple[np.ndarray, np.ndarray]] = {}
    start = 0
    remaining = len(X)
    for i, tok in enumerate(tokens):
        ln = remaining // (num - i)
        result[tok] = (X[start : start + ln], y[start : start + ln])
        start += ln
        remaining -= ln
    return result
