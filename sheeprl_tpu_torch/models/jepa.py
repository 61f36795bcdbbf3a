"""JEPA self-supervised blocks (counterpart of ``sheeprl_tpu/models/jepa.py``).

Two masked views of a batch: pixels keep a centred ``1 - erase_frac``
rectangle (the same deterministic mask in both views), vectors get
``vec_dropout`` times standard-normal noise, drawn anew for each view.  The
online encoder and projector, then the predictor, embed one view; the
target encoder and projector (copies that follow the online ones by an
exponential moving average, never trained) embed the other; the loss is
``2 - 2 <pq, zk>`` of the two L2-normalised embeddings.  The projector
uses LayerNorm where the reference uses BatchNorm, as the JAX package does.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sheeprl_tpu_torch.parallel.dp import draw


def _erase_rectangles(x: torch.Tensor, erase_frac: float) -> torch.Tensor:
    """``x`` (``[T, B, C, H, W]``) with all but a centred rectangle of
    ``(1 - erase_frac)`` of each side set to zero."""
    H, W = x.shape[-2:]
    h = max(1, min(H, int(H * (1 - erase_frac))))
    w = max(1, min(W, int(W * (1 - erase_frac))))
    top, left = (H - h) // 2, (W - w) // 2
    mask = torch.zeros((H, W), dtype=x.dtype, device=x.device)
    mask[top:top + h, left:left + w] = 1.0
    return x * mask


def make_two_views(obs: Mapping[str, torch.Tensor], erase_frac: float = 0.6, vec_dropout: float = 0.2,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[Mapping[str, Tuple[torch.Tensor, torch.Tensor]]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Two views of ``obs``: a 5-dim (pixel) key masked by
    :func:`_erase_rectangles` in both, any other key plus ``vec_dropout``
    times standard-normal noise, one draw per view.  ``noise[key]`` holds
    the two draws (the JAX package takes them from ``fold_in(key, i)`` over
    the sorted keys, then ``split``); a key without one draws from
    ``generator``, in the order of the sorted keys."""
    obs_q: Dict[str, torch.Tensor] = {}
    obs_k: Dict[str, torch.Tensor] = {}
    for k in sorted(obs):
        v = obs[k]
        if v.dim() == 5:
            obs_q[k] = obs_k[k] = _erase_rectangles(v, erase_frac)
            continue
        if noise is not None and k in noise:
            nq, nk = (n.to(v.dtype) for n in noise[k])
        else:
            nq, nk = (draw(torch.randn, v.shape, generator, device=v.device, batch_dims=2).to(v.dtype)
                      for _ in range(2))
        obs_q[k] = v + nq * vec_dropout
        obs_k[k] = v + nk * vec_dropout
    return obs_q, obs_k


class JEPAProjector(nn.Module):
    """Linear -> LayerNorm (flax's eps 1e-6) -> ReLU -> Linear; a 3-dim
    input ``[T, B, E]`` is mean-pooled over T first."""

    def __init__(self, in_features: int, proj_dim: int = 1024, hidden: int = 1024):
        super().__init__()
        self.dense_0 = nn.Linear(in_features, hidden)
        self.norm = nn.LayerNorm(hidden, eps=1e-6)
        self.dense_1 = nn.Linear(hidden, proj_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if z.dim() == 3:
            z = z.mean(dim=0)
        return self.dense_1(F.relu(self.norm(self.dense_0(z))))


class JEPAPredictor(nn.Module):
    """Linear -> ReLU -> Linear."""

    def __init__(self, proj_dim: int = 1024, hidden: int = 1024):
        super().__init__()
        self.dense_0 = nn.Linear(proj_dim, hidden)
        self.dense_1 = nn.Linear(hidden, proj_dim)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        return self.dense_1(F.relu(self.dense_0(p)))


def l2_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def jepa_loss(encode_q: Callable[[Dict[str, torch.Tensor]], torch.Tensor],
              encode_k: Callable[[Dict[str, torch.Tensor]], torch.Tensor], projector: JEPAProjector,
              predictor: JEPAPredictor, target_projector: JEPAProjector, obs_q: Dict[str, torch.Tensor],
              obs_k: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``2 - 2 mean(<pq, zk>)``: ``pq`` the predictor of the online
    projection of ``encode_q(obs_q)``, ``zk`` the target projection of
    ``encode_k(obs_k)``, computed without a graph."""
    pq = l2_normalize(predictor(projector(encode_q(obs_q))))
    with torch.no_grad():
        zk = l2_normalize(target_projector(encode_k(obs_k)))
    return 2.0 - 2.0 * torch.mean(torch.sum(pq * zk, dim=-1))
