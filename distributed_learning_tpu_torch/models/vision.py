"""Agent-stacked CIFAR-scale vision zoo: LeNet, VGG, ResNet, Wide-ResNet
(port of ``distributed_learning_tpu/models/vision.py``).

Every parameter carries the leading agent axis and lives in the model's
flat ``(N, P)`` buffer (``models/_stacked.py``); BatchNorm running
statistics are ``(N, C)`` buffers beside it, per agent and never
gossiped (the reference's nodes each keep their own, ``mixer.py:68-76``).

Per-agent convolutions: the activations flow as a list of N per-agent
``(B, C, H, W)`` tensors, and each layer makes one cuDNN call per agent
on weights that are views of the flat buffer (``unbind`` once per layer,
so the backward writes all agents' gradients in one ``stack``).  The
other candidate, one grouped convolution with ``groups=N`` over
``(B, N*C, H, W)``, was timed against it once at WRN-28-10, B 256, bf16
(``chip_smoke.py`` conv_layout phase, ``PERF.md``).

Layout: inputs are NHWC as in the JAX package (``(N, B, H, W, C)``);
``permute(0, 3, 1, 2)`` turns each agent's batch into an NCHW view with
``channels_last`` strides at no cost, the layout that Hopper's bf16
convolutions want, and every layer keeps it.  Kernels are OIHW here and
HWIO in flax; ``convert.py`` transposes, nowhere else does.

Parity with flax: module and parameter names follow flax's automatic
names (``Conv_0``, ``_WideBasic_3/BatchNorm_1/scale``) by construction
(:func:`~distributed_learning_tpu_torch.models._stacked.add_child`);
BatchNorm uses epsilon 1e-5, float32 statistics under any compute dtype,
the *biased* batch variance for the running update (which
``F.batch_norm`` would make unbiased, so the update is written out) and
flax's momentum 0.9 (torch's 0.1); eval mode normalizes with the running
statistics.  Dropout draws its masks from one explicit
``torch.Generator`` per agent (its bits cannot follow ``jax.random``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models._stacked import (
    Dense,
    Dropout,
    StackedModel,
    add_child,
    recomputing,
)

__all__ = ["LeNet", "VGG", "ResNet", "WideResNet", "BatchNorm", "Dropout", "Conv"]

Acts = List[torch.Tensor]  # one (B, C, H, W) channels_last tensor per agent

BN_EPS = 1e-5       # flax BatchNorm's epsilon
BN_MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch


def _relu(xs: Acts) -> Acts:
    return [F.relu(x) for x in xs]


def _add(xs: Acts, ys: Acts) -> Acts:
    return [x + y for x, y in zip(xs, ys)]


def _max_pool(xs: Acts) -> Acts:
    return [F.max_pool2d(x, 2, 2) for x in xs]


class Conv(nn.Module):
    """flax ``nn.Conv`` per agent: kernel (N, out, in, kh, kw), bias
    (N, out) or none; ``padding`` in pixels on each side."""

    def __init__(self, n, c_in, c_out, k, stride=1, padding=0, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.kernel = nn.Parameter(torch.zeros(n, c_out, c_in, k, k))
        self.bias = nn.Parameter(torch.zeros(n, c_out)) if bias else None

    def forward(self, xs: Acts) -> Acts:
        dt = xs[0].dtype
        ws = self.kernel.unbind(0)
        bs = self.bias.unbind(0) if self.bias is not None else [None] * len(xs)
        return [
            F.conv2d(x, w.to(dt), None if b is None else b.to(dt), self.stride, self.padding)
            for x, w, b in zip(xs, ws, bs)
        ]


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` per agent: scale and bias
    (N, C) parameters, running ``mean`` and ``var`` (N, C) buffers."""

    def __init__(self, n: int, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(n, c))
        self.bias = nn.Parameter(torch.zeros(n, c))
        self.register_buffer("mean", torch.zeros(n, c))
        self.register_buffer("var", torch.ones(n, c))

    def forward(self, xs: Acts) -> Acts:
        scales, biases = self.scale.unbind(0), self.bias.unbind(0)
        out = []
        for a, x in enumerate(xs):
            if not self.training:
                out.append(torch.native_batch_norm(
                    x, scales[a], biases[a], self.mean[a], self.var[a], False, 0.0, BN_EPS)[0])
                continue
            # Batch statistics are reduced in float32 whatever x's dtype;
            # the kernel returns the mean and 1/sqrt(biased var + eps).
            y, mean, invstd = torch.native_batch_norm(
                x, scales[a], biases[a], None, None, True, 0.0, BN_EPS)
            out.append(y)
            if recomputing():  # the checkpointed forward updated them already
                continue
            with torch.no_grad():
                var = (invstd.double().pow(-2) - BN_EPS).to(torch.float32)
                self.mean[a].mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.var[a].mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        return out


class _VisionModel(StackedModel):
    """Shared surface of the vision zoo: ``forward`` takes (N, B, H, W, C)
    images and returns (N, B, num_classes) float32 logits; agent ``a``'s
    logits depend only on agent ``a``'s parameters and statistics."""

    def _setup(self, n_agents, dtype, device, seed):
        nn.Module.__init__(self)
        self.n_agents, self.dtype = int(n_agents), dtype
        self.device = resolve_device(device)
        self._make_generators(self.device, seed)

    def _finish(self, seed):
        self.reset_parameters(seed)
        self._bind_flat(self.device)

    def _agents_in(self, x: torch.Tensor) -> Acts:
        N = x.shape[0]
        if N != self.n_agents or x.dim() != 5 or x.shape[-1] != 3:
            raise ValueError(
                f"expected (N={self.n_agents}, B, H, W, 3) images, got {tuple(x.shape)}")
        # NHWC -> an NCHW view with channels_last strides, no copy.
        return [x[a].to(self.dtype).permute(0, 3, 1, 2) for a in range(N)]

    def _head(self, xs: Acts) -> torch.Tensor:
        """Spatial mean, then the Dense_0 readout per agent (one bmm)."""
        feats = torch.stack([x.mean(dim=(2, 3)) for x in xs])
        return self.Dense_0(feats).to(torch.float32)


class LeNet(_VisionModel):
    """Classic LeNet-5 (the submodule's ``lenet`` option)."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.float32, *,
                 input_shape: Sequence[int] = (32, 32, 3), n_agents: int = 1,
                 device=None, seed: int = 0):
        self._setup(n_agents, dtype, device, seed)
        n = self.n_agents
        H, W = input_shape[0], input_shape[1]
        # flax's default 'SAME' padding of a 5x5 conv: 2 pixels a side.
        add_child(self, "Conv", Conv(n, 3, 6, 5, padding=2))
        add_child(self, "Conv", Conv(n, 6, 16, 5, padding=2))
        add_child(self, "Dense", Dense(n, (H // 4) * (W // 4) * 16, 120))
        add_child(self, "Dense", Dense(n, 120, 84))
        add_child(self, "Dense", Dense(n, 84, num_classes))
        self._finish(seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = _max_pool(_relu(self.Conv_0(self._agents_in(x))))
        xs = _max_pool(_relu(self.Conv_1(xs)))
        # Flatten in (H, W, C) order, flax's NHWC order, so Dense_0's
        # kernel rows mean what they mean in flax; on channels_last
        # activations this permute is a view.
        h = torch.stack([t.permute(0, 2, 3, 1).reshape(t.shape[0], -1) for t in xs])
        h = F.relu(self.Dense_0(h))
        h = F.relu(self.Dense_1(h))
        return self.Dense_2(h).to(torch.float32)


_VGG_CFG = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
         512, "M", 512, 512, 512, 512, "M"),
}


class VGG(_VisionModel):
    """VGG-{11,13,16,19} with BatchNorm (the submodule's ``vggnet``)."""

    def __init__(self, depth: int = 16, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, n_agents: int = 1,
                 device=None, seed: int = 0):
        if depth not in _VGG_CFG:
            raise ValueError(f"VGG depth must be one of {sorted(_VGG_CFG)}")
        self._setup(n_agents, dtype, device, seed)
        n, c, self.plan = self.n_agents, 3, []
        for v in _VGG_CFG[depth]:
            if v == "M":
                self.plan.append(None)
                continue
            conv = add_child(self, "Conv", Conv(n, c, v, 3, padding=1, bias=False))
            self.plan.append((conv, add_child(self, "BatchNorm", BatchNorm(n, v))))
            c = v
        add_child(self, "Dense", Dense(n, c, num_classes))
        self._finish(seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self._agents_in(x)
        for step in self.plan:
            xs = _max_pool(xs) if step is None else _relu(step[1](step[0](xs)))
        return self._head(xs)


class _BasicBlock(nn.Module):
    """Post-activation basic block; flax creates its shortcut conv last,
    so a projecting block's names are Conv_0/1 (3x3) and Conv_2 (1x1)."""

    def __init__(self, n, c_in, filters, stride):
        super().__init__()
        add_child(self, "Conv", Conv(n, c_in, filters, 3, stride, 1, bias=False))
        add_child(self, "BatchNorm", BatchNorm(n, filters))
        add_child(self, "Conv", Conv(n, filters, filters, 3, 1, 1, bias=False))
        add_child(self, "BatchNorm", BatchNorm(n, filters))
        self.project = c_in != filters or stride != 1
        if self.project:
            # 1x1 'SAME' at stride 2 on an even size pads nothing.
            add_child(self, "Conv", Conv(n, c_in, filters, 1, stride, 0, bias=False))
            add_child(self, "BatchNorm", BatchNorm(n, filters))

    def forward(self, xs: Acts) -> Acts:
        y = _relu(self.BatchNorm_0(self.Conv_0(xs)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(xs)) if self.project else xs
        return _relu(_add(y, residual))


class ResNet(_VisionModel):
    """CIFAR-style ResNet (the submodule's ``resnet`` option): 3 stages of
    BasicBlocks, depth = 6n + 2 (20/32/44/56/110) or 18/34 block counts."""

    def __init__(self, depth: int = 18, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, *, n_agents: int = 1,
                 device=None, seed: int = 0):
        if (depth - 2) % 6 == 0:
            blocks = ((depth - 2) // 6,) * 3
        elif depth == 18:
            blocks = (2, 2, 2)
        elif depth == 34:
            blocks = (3, 4, 6)
        else:
            raise ValueError(f"unsupported ResNet depth {depth}")
        self._setup(n_agents, dtype, device, seed)
        n = self.n_agents
        add_child(self, "Conv", Conv(n, 3, 16, 3, 1, 1, bias=False))
        add_child(self, "BatchNorm", BatchNorm(n, 16))
        self.blocks, c = [], 16
        for stage, num in enumerate(blocks):
            for b in range(num):
                stride = 2 if (stage > 0 and b == 0) else 1
                width = 16 * 2 ** stage
                self.blocks.append(add_child(self, "_BasicBlock", _BasicBlock(n, c, width, stride)))
                c = width
        add_child(self, "Dense", Dense(n, c, num_classes))
        self._finish(seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = _relu(self.BatchNorm_0(self.Conv_0(self._agents_in(x))))
        for blk in self.blocks:
            xs = blk(xs)
        return self._head(xs)


class _WideBasic(nn.Module):
    """Pre-activation wide basic block: BN-ReLU, then the shortcut (a 1x1
    conv of the *activated* input where the block projects), 3x3 conv,
    dropout, BN-ReLU, 3x3 conv with the block's stride on this SECOND
    conv; every conv has a bias.  flax creates the shortcut before the
    3x3 convs, so a projecting block's names are Conv_0 (1x1), Conv_1 and
    Conv_2, a non-projecting block's Conv_0 and Conv_1."""

    def __init__(self, n, c_in, filters, stride, dropout_rate, generators):
        super().__init__()
        add_child(self, "BatchNorm", BatchNorm(n, c_in))
        self.project = c_in != filters or stride != 1
        if self.project:
            # 1x1 'SAME' at stride 2 on an even size pads nothing.
            add_child(self, "Conv", Conv(n, c_in, filters, 1, stride, 0))
        conv1 = add_child(self, "Conv", Conv(n, c_in, filters, 3, 1, 1))
        self.drop = Dropout(dropout_rate, generators) if dropout_rate > 0 else None
        add_child(self, "BatchNorm", BatchNorm(n, filters))
        conv2 = add_child(self, "Conv", Conv(n, filters, filters, 3, stride, 1))
        self.convs = (conv1, conv2)  # a tuple: registered once, by name

    def forward(self, xs: Acts) -> Acts:
        y = _relu(self.BatchNorm_0(xs))
        shortcut = self.Conv_0(y) if self.project else xs
        y = self.convs[0](y)
        if self.drop is not None:
            y = self.drop(y)
        y = self.convs[1](_relu(self.BatchNorm_1(y)))
        return _add(y, shortcut)


class WideResNet(_VisionModel):
    """WRN-d-k (default 28-10): the reference's flagship model."""

    def __init__(self, depth: int = 28, widen_factor: int = 10, dropout_rate: float = 0.3,
                 num_classes: int = 10, dtype: torch.dtype = torch.float32, *,
                 n_agents: int = 1, device=None, seed: int = 0):
        if (depth - 4) % 6 != 0:
            raise ValueError("WideResNet depth must be 6n + 4")
        self._setup(n_agents, dtype, device, seed)
        n, k = self.n_agents, widen_factor
        add_child(self, "Conv", Conv(n, 3, 16, 3, 1, 1))
        self.blocks, c = [], 16
        for stage, width in enumerate((16 * k, 32 * k, 64 * k)):
            for b in range((depth - 4) // 6):
                stride = 2 if (stage > 0 and b == 0) else 1
                self.blocks.append(add_child(self, "_WideBasic", _WideBasic(
                    n, c, width, stride, dropout_rate, self.generators)))
                c = width
        add_child(self, "BatchNorm", BatchNorm(n, c))
        add_child(self, "Dense", Dense(n, c, num_classes))
        self._finish(seed)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.Conv_0(self._agents_in(x))
        for blk in self.blocks:
            xs = blk(xs)
        return self._head(_relu(self.BatchNorm_0(xs)))
