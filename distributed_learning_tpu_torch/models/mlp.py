"""Agent-stacked 4-layer MLP (port of ``distributed_learning_tpu/models/
mlp.py``; parity: ``networks/ann_model.py:4-45`` ``ANNModel``).

Linear->ReLU->Linear->Tanh->Linear->ELU->Linear, every dense layer one
``bmm`` over the agent axis as in the transformer.  flax infers the
input width at ``init``; here it comes from ``input_shape`` (the
trainer passes its data's per-sample shape; the default is the
reference's 784-pixel MNIST input).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from distributed_learning_tpu_torch.device import resolve_device
from distributed_learning_tpu_torch.models._stacked import Dense, StackedModel

__all__ = ["ANNModel"]


class ANNModel(StackedModel):
    """Linear/ReLU, Linear/Tanh, Linear/ELU, Linear readout; ``forward``
    takes (N, B, ...) inputs and returns (N, B, output_dim) float32."""

    def __init__(
        self,
        hidden_dim: int = 150,
        output_dim: int = 10,
        dtype: torch.dtype = torch.float32,
        *,
        input_shape: Sequence[int] = (784,),
        n_agents: int = 1,
        device=None,
        seed: int = 0,
    ):
        super().__init__()
        self.hidden_dim, self.output_dim = hidden_dim, output_dim
        self.dtype, self.n_agents = dtype, int(n_agents)
        dims = [math.prod(input_shape), hidden_dim, hidden_dim, hidden_dim, output_dim]
        for i in range(4):
            self.add_module(f"Dense_{i}", Dense(self.n_agents, dims[i], dims[i + 1]))
        self.reset_parameters(seed)
        self._bind_flat(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, B = x.shape[:2]
        x = x.reshape(N, B, -1).to(self.dtype)
        x = F.relu(self.Dense_0(x))
        x = torch.tanh(self.Dense_1(x))
        x = F.elu(self.Dense_2(x))
        return self.Dense_3(x).to(torch.float32)
