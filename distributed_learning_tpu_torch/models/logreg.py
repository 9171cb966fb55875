"""Binary logistic regression with L2 regularization (port of
``distributed_learning_tpu/models/logreg.py``).

Parity: ``networks/logreg_model_titanic.py:4-29`` (``LogRegTitanic``) —
labels in {-1, +1}, ridge term ``tau``, one GD step per ``fit`` call
returning the train loss, and a 0.5-thresholded accuracy.  The gradient is
written out (the reference's manual gradient; the JAX package takes
``jax.grad`` of the same loss).  Every function broadcasts over leading
agent axes: ``w`` (..., d) with ``X`` (..., m, d) and ``y`` (..., m) runs
one agent per leading index, as ``vmap`` does in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from distributed_learning_tpu_torch.device import resolve_device

__all__ = ["LogisticRegression", "loss_fn", "grad_step", "predict", "accuracy"]


def _margins(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return y * (X @ w[..., None])[..., 0]


def loss_fn(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, tau: float) -> torch.Tensor:
    """``tau/2 ||w||^2 - mean(log sigmoid(y * Xw))`` (labels in {-1, +1});
    identical to the reference's train loss."""
    return tau / 2.0 * (w ** 2).sum(-1) + F.softplus(-_margins(w, X, y)).mean(-1)


def grad_step(
    w: torch.Tensor, X: torch.Tensor, y: torch.Tensor, *, lr, tau: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gradient-descent step; returns ``(new_w, loss_before_step)``.
    ``lr`` is a float or a tensor that broadcasts against ``w``."""
    margins = _margins(w, X, y)
    loss = tau / 2.0 * (w ** 2).sum(-1) + F.softplus(-margins).mean(-1)
    # d/dw mean(softplus(-y Xw)) = -mean(y sigmoid(-y Xw) X)
    coef = -y * torch.sigmoid(-margins) / margins.shape[-1]
    g = tau * w + (coef[..., None, :] @ X)[..., 0, :]
    return w - lr * g, loss


def predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """{-1, +1} predictions via the 0.5 sigmoid threshold."""
    p = torch.sigmoid((X @ w[..., None])[..., 0])
    return torch.where(p >= 0.5, 1, -1)


def accuracy(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (predict(w, X) == y).to(torch.float32).mean(-1)


@dataclasses.dataclass
class LogisticRegression:
    """Object-style wrapper mirroring the reference class surface; runs on
    the card unless ``device="cpu"``."""

    dim: int
    lr: float = 5e-4
    tau: float = 1e-4
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.W = torch.zeros(self.dim, dtype=torch.float32, device=self.device)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def parameters(self) -> torch.Tensor:
        return self.W

    def fit(self, x_train, y_train) -> float:
        self.W, loss = grad_step(self.W, self._t(x_train), self._t(y_train),
                                 lr=self.lr, tau=self.tau)
        return float(loss)

    def calc_accuracy(self, x_test, y_test) -> float:
        return float(accuracy(self.W, self._t(x_test), self._t(y_test)))
