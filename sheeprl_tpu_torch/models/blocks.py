"""Reusable NN blocks (counterpart of ``sheeprl_tpu/models/blocks.py``): the
activation table, the channel-last LayerNorm of the DV3 conv encoder and the
LayerNorm-GRU cell of the RSSM."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru


def get_activation(name: str | Callable | None) -> Callable:
    """Map activation names (e.g. ``torch.nn.SiLU``, ``silu``) to functions."""
    if name is None:
        return lambda x: x
    if callable(name):
        return name
    key = name.rsplit(".", 1)[-1].lower()
    table = {
        "relu": F.relu,
        "silu": F.silu,
        "swish": F.silu,
        "tanh": torch.tanh,
        "elu": F.elu,
        "gelu": F.gelu,
        "leakyrelu": F.leaky_relu,
        "sigmoid": torch.sigmoid,
        "identity": lambda x: x,
    }
    if key not in table:
        raise ValueError(f"Unknown activation '{name}'")
    return table[key]


class LayerNormChannelLast(nn.LayerNorm):
    """LayerNorm over the channels of each pixel of an NCHW map, as the JAX
    package's NHWC ``nn.LayerNorm`` normalizes the last (channel) axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class LayerNormGRUCell(nn.Module):
    """GRU cell with LayerNorm on the joint projection and a -1 update-gate
    bias.  Call as ``new_h = cell(h, x)``.

    With LayerNorm on and 2-D input the cell runs
    :func:`~sheeprl_tpu_torch.ops.ln_gru.fused_layernorm_gru`, which launches
    the hand-written kernel on a CUDA tensor and carries gradients to every
    input, the initial state's broadcast included.  The JAX package chose between
    its Pallas kernel and XLA's own fusion with ``algo.rssm_pallas`` /
    ``recurrent_model.fused_kernel``; the port has no second fused path, so it
    reads neither flag (ROADMAP.md, Queue 2).
    """

    def __init__(
        self, input_size: int, hidden_size: int, use_bias: bool = True, layer_norm: bool = True, norm_eps: float = 1e-3
    ):
        super().__init__()
        self.hidden_size = hidden_size
        self.linear = nn.Linear(hidden_size + input_size, 3 * hidden_size, bias=use_bias)
        self.norm = nn.LayerNorm(3 * hidden_size, eps=norm_eps) if layer_norm else None

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        joint = torch.cat([h, x], dim=-1)
        if self.norm is not None and joint.dim() == 2:
            # the kernel takes contiguous rows; an initial state broadcast
            # over the batch is a stride-0 view
            return fused_layernorm_gru(
                joint, self.linear.weight, self.linear.bias, self.norm.weight, self.norm.bias, h.contiguous(),
                self.norm.eps,
            )
        z = self.linear(joint)
        if self.norm is not None:
            z = self.norm(z)
        reset, cand, update = torch.chunk(z, 3, dim=-1)
        reset = torch.sigmoid(reset)
        cand = torch.tanh(reset * cand)
        update = torch.sigmoid(update - 1)
        return update * cand + (1 - update) * h
