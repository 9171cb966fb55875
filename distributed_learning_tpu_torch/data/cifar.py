"""CIFAR-10/100 pipeline with per-agent sharding and device-side
augmentation (port of ``distributed_learning_tpu/data/cifar.py``).

Parity: the reference loads CIFAR via torchvision with per-dataset
normalization constants and RandomCrop(32, padding=4) + RandomHorizontalFlip
augmentation (``Man_Colab.ipynb`` cell 16, ``CIFAR_10_Baseline.ipynb``), and
splits the train set evenly across agents.

Loading, the synthetic stand-in and sharding are numpy, as in the JAX
package.  :func:`normalize` and :func:`augment_batch` work on tensors on
the device.  The JAX package draws crops and flips inside
``augment_batch`` from a PRNG key; here the draw is separate
(:func:`draw_augment`, from an explicit ``torch.Generator``), so the
augmentation itself is a pure function of its offsets and flip bits and
can be held bit for bit against the JAX package's by feeding it the
offsets and flips that a JAX key gives.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Hashable, Sequence, Tuple, Union

import numpy as np
import torch

from distributed_learning_tpu_torch.data.titanic import split_data

__all__ = [
    "CIFAR_MEAN",
    "CIFAR_STD",
    "load_cifar",
    "real_cifar_present",
    "synthetic_cifar",
    "normalize",
    "normalized_pad_value",
    "augment_batch",
    "draw_augment",
    "shard_dataset",
]

# meliketoy config.py constants (used by Man_Colab cell 16 transforms).
CIFAR_MEAN = {
    "cifar10": np.array([0.4914, 0.4822, 0.4465], np.float32),
    "cifar100": np.array([0.5071, 0.4865, 0.4409], np.float32),
}
CIFAR_STD = {
    "cifar10": np.array([0.2470, 0.2435, 0.2616], np.float32),
    "cifar100": np.array([0.2673, 0.2564, 0.2762], np.float32),
}

_DEFAULT_DIRS = (
    os.environ.get("DLT_CIFAR_DIR", ""),
    "data/cifar10",
    "data/cifar-10-batches-py",
)
PAD = 4  # RandomCrop(32, padding=4)


def _batch_files(d: str, dataset: str):
    if dataset == "cifar10":
        return (
            [os.path.join(d, f"data_batch_{i}") for i in range(1, 6)],
            [os.path.join(d, "test_batch")],
            b"labels",
        )
    return [os.path.join(d, "train")], [os.path.join(d, "test")], b"fine_labels"


def real_cifar_present(dataset: str = "cifar10", data_dir: str | None = None) -> bool:
    """True when real CIFAR pickle batches exist (file check only — no
    loading), in ``data_dir`` or any default location."""
    dirs = [data_dir] if data_dir else [d for d in _DEFAULT_DIRS if d]
    for d in dirs:
        train_files, test_files, _ = _batch_files(d, dataset)
        if all(os.path.exists(p) for p in train_files + test_files):
            return True
    return False


def _load_pickle_batches(d: str, dataset: str):
    """Read the standard CIFAR python pickle format if present."""
    train_files, test_files, label_key = _batch_files(d, dataset)
    if not all(os.path.exists(p) for p in train_files + test_files):
        return None

    def read(files):
        xs, ys = [], []
        for p in files:
            with open(p, "rb") as f:
                batch = pickle.load(f, encoding="bytes")
            xs.append(batch[b"data"])
            ys.extend(batch[label_key])
        X = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return X.astype(np.uint8), np.asarray(ys, np.int32)

    return read(train_files), read(test_files)


def synthetic_cifar(
    dataset: str = "cifar10",
    *,
    n_train: int = 4096,
    n_test: int = 1024,
    seed: int = 0,
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """Deterministic CIFAR-shaped stand-in: each class is a distinct smooth
    color/texture prototype plus noise, so models can actually learn."""
    num_classes = 10 if dataset == "cifar10" else 100
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    protos = []
    for c in range(num_classes):
        phase = 2 * np.pi * c / num_classes
        base = np.stack(
            [
                0.5 + 0.4 * np.sin(2 * np.pi * (xx * (1 + c % 4)) + phase),
                0.5 + 0.4 * np.cos(2 * np.pi * (yy * (1 + c % 3)) + phase),
                0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) * (1 + c % 5) + phase),
            ],
            axis=-1,
        )
        protos.append(base)
    protos = np.stack(protos)  # (C, 32, 32, 3)

    def make(n, seed_off):
        r = np.random.default_rng(seed + seed_off)
        y = r.integers(0, num_classes, size=n).astype(np.int32)
        x = protos[y] + r.normal(0, 0.18, size=(n, 32, 32, 3))
        return (np.clip(x, 0, 1) * 255).astype(np.uint8), y

    return make(n_train, 1), make(n_test, 2)


def load_cifar(
    dataset: str = "cifar10", data_dir: str | None = None
) -> Tuple[Tuple[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]:
    """``((X_train, y_train), (X_test, y_test))`` as uint8 NHWC + int32."""
    dirs = [data_dir] if data_dir else [d for d in _DEFAULT_DIRS if d]
    for d in dirs:
        out = _load_pickle_batches(d, dataset)
        if out is not None:
            return out
    return synthetic_cifar(dataset)


def normalize(x: Union[torch.Tensor, np.ndarray], dataset: str = "cifar10") -> torch.Tensor:
    """uint8 NHWC -> normalized float32 (meliketoy mean/std), on the
    device of ``x`` (a numpy array becomes a CPU tensor)."""
    x = torch.as_tensor(x)
    mean = torch.as_tensor(CIFAR_MEAN[dataset], device=x.device)
    std = torch.as_tensor(CIFAR_STD[dataset], device=x.device)
    return (x.to(torch.float32) / 255.0 - mean) / std


def normalized_pad_value(dataset: str = "cifar10") -> np.ndarray:
    """Per-channel value of a black pixel after :func:`normalize` — the
    crop-border content matching a crop-before-normalize pipeline."""
    return (0.0 - CIFAR_MEAN[dataset]) / CIFAR_STD[dataset]


def draw_augment(
    generator: torch.Generator, batch: int, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Crop offsets ``(batch, 2)`` in ``[0, 2 * PAD]`` (row, column) and
    horizontal-flip bits ``(batch,)`` drawn from ``generator``, which must
    live on ``device`` (the generator's own device by default)."""
    device = generator.device if device is None else torch.device(device)
    offsets = torch.randint(0, 2 * PAD + 1, (batch, 2), generator=generator, device=device)
    flips = torch.randint(0, 2, (batch,), generator=generator, device=device).bool()
    return offsets, flips


def augment_batch(
    x: torch.Tensor,
    offsets: torch.Tensor,
    flips: torch.Tensor,
    pad_value: Union[torch.Tensor, np.ndarray, float] = 0.0,
) -> torch.Tensor:
    """RandomCrop(32, padding=4) + RandomHorizontalFlip on (B, 32, 32, 3)
    images of any float dtype, with the crops and flips given.

    The batch is padded to 40 x 40 with ``pad_value`` (scalar or
    per-channel (3,); pass :func:`normalized_pad_value` for images that
    are already normalized, since the reference crops before it
    normalizes), then ONE gather reads each output pixel from
    ``(offset_row + i, offset_col + j)`` of the padded batch, with ``j``
    mirrored where the flip bit is set: no loop over images.
    """
    B, H, W, C = x.shape
    pv = torch.as_tensor(pad_value, device=x.device).to(x.dtype).expand(C)
    padded = pv.expand(B, H + 2 * PAD, W + 2 * PAD, C).clone()
    padded[:, PAD: PAD + H, PAD: PAD + W] = x
    offsets = offsets.to(device=x.device, dtype=torch.long)
    flips = flips.to(device=x.device, dtype=torch.bool)
    i = torch.arange(H, device=x.device)
    j = torch.arange(W, device=x.device)
    rows = offsets[:, 0, None] + i                                     # (B, H)
    cols = offsets[:, 1, None] + torch.where(flips[:, None], W - 1 - j, j)  # (B, W)
    b = torch.arange(B, device=x.device)[:, None, None]
    return padded[b, rows[:, :, None], cols[:, None, :]]


def shard_dataset(
    X: np.ndarray,
    y: np.ndarray,
    agents: int | Sequence[Hashable],
    *,
    batch_size: int | None = None,
    seed: int = 0,
) -> Dict[Hashable, Tuple[np.ndarray, np.ndarray]]:
    """Random near-equal disjoint shards per agent (parity: the
    ``random_split`` sizes of ``Man_Colab.ipynb`` cell 16).

    If ``batch_size`` is given, each shard is truncated to a multiple of it.
    """
    perm = np.random.default_rng(seed).permutation(len(X))
    out = split_data(X[perm], y[perm], agents)
    if batch_size is not None:
        for tok, (xs, ys) in out.items():
            ln = (len(xs) // batch_size) * batch_size
            out[tok] = (xs[:ln], ys[:ln])
    return out
