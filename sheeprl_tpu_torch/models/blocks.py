"""Reusable NN blocks (counterpart of ``sheeprl_tpu/models/blocks.py``): the
activation table, the dense stack (``MLP``), the Nature DQN conv backbone,
the channel-last LayerNorm of the DV3 conv encoder and the LayerNorm-GRU
cell of the RSSM."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.ops.ln_gru import fused_layernorm_gru


@torch.no_grad()
def lecun_normal_(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """flax's default init on every dense and conv layer of ``module``: a
    truncated normal of variance ``1 / fan_in`` (``lecun_normal``), zero
    bias; drawn from ``generator`` (the global generator without one)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)


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


class MLP(nn.Module):
    """Dense layers, each followed by an optional LayerNorm (eps 1e-3) and
    the activation, then an optional output layer without either (the JAX
    package's ``MLP``)."""

    def __init__(self, input_dim: int, hidden_sizes: Sequence[int], output_dim: Optional[int] = None,
                 activation: str | Callable = "tanh", layer_norm: bool = False, norm_eps: float = 1e-3):
        super().__init__()
        sizes = [int(input_dim)] + [int(h) for h in hidden_sizes]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.norms = nn.ModuleList(nn.LayerNorm(b, eps=norm_eps) for b in sizes[1:]) if layer_norm else None
        self.out = nn.Linear(sizes[-1], int(output_dim)) if output_dim is not None else None
        self.act = get_activation(activation)
        self.output_dim = int(output_dim) if output_dim is not None else sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        return self.out(x) if self.out is not None else x


class NatureCNN(nn.Module):
    """The Nature DQN backbone: three VALID convolutions with ReLU, then a
    dense layer with ReLU, on ``[N, C, H, W]``.  The JAX package flattens
    the last feature map in (H, W, C) order, torch in (C, H, W): the dense
    layer's ``flatten_hwc`` tells the weight converter how to permute its
    input rows."""

    LAYERS = ((32, 8, 4), (64, 4, 2), (64, 3, 1))

    def __init__(self, in_channels: int, screen_hw: Tuple[int, int], features_dim: int = 512):
        super().__init__()
        convs, c, (h, w) = [], int(in_channels), (int(screen_hw[0]), int(screen_hw[1]))
        for ch, k, s in self.LAYERS:
            convs.append(nn.Conv2d(c, ch, k, stride=s))
            c, h, w = ch, (h - k) // s + 1, (w - k) // s + 1
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(c * h * w, int(features_dim))
        self.dense.flatten_hwc = (h, w, c)
        self.features_dim = int(features_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = F.relu(conv(x))
        return F.relu(self.dense(x.flatten(1)))


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
    ``recurrent_model.fused_kernel``, and how far XLA unrolls the RSSM scan
    with ``algo.scan_unroll``; the port has no second fused path and no scan
    lowering to unroll, so it reads none of the three (ROADMAP.md, Queue 2).
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
