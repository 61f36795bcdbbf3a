"""Weights across the two packages: the JAX package's flax param trees
(numpy, as its checkpoints store them) to the port's DV3 modules and back.

Rules: Dense ``kernel[in, out]`` <-> Linear ``weight[out, in]``; Conv
``kernel`` HWIO <-> ``weight`` OIHW; LayerNorm ``scale``/``bias`` <->
``weight``/``bias``; ``rssm/initial_recurrent_state`` as is.  Both
directions walk one spec of the port's modules, laid out in the flax tree's
own names, so they cannot disagree.  The walk is strict: a key missing on
either side or a shape that differs raises.  The only keys skipped are the
subtrees the serving slice does not build yet, named in
``SKIPPED_WORLD_MODEL`` and ``SKIPPED_TOP``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    RSSM,
    Actor,
    CNNEncoderDV3,
    DenseStack,
    MLPEncoderDV3,
    RecurrentModel,
    WorldModel,
    _StochHead,
)
from sheeprl_tpu_torch.models.blocks import LayerNormGRUCell

#: world-model subtrees the training slice will build
SKIPPED_WORLD_MODEL = ("cnn_decoder", "mlp_decoder", "reward_model", "continue_model")
#: top-level checkpoint trees the training slice will build
SKIPPED_TOP = ("critic", "target_critic")



def _linear(m: nn.Linear) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"kernel": (m.weight, "dense")}
    if m.bias is not None:
        spec["bias"] = (m.bias, "same")
    return spec


def _norm(m: nn.LayerNorm) -> Dict[str, Any]:
    return {"scale": (m.weight, "same"), "bias": (m.bias, "same")}


def _conv(m: nn.Conv2d) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"kernel": (m.weight, "conv")}
    if m.bias is not None:
        spec["bias"] = (m.bias, "same")
    return spec


def _stack(m: DenseStack) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    for i, dense in enumerate(m.dense):
        spec[f"Dense_{i}"] = _linear(dense)
        if m.norms is not None:
            spec[f"LayerNorm_{i}"] = _norm(m.norms[i])
    return spec


def _gru(m: LayerNormGRUCell) -> Dict[str, Any]:
    spec = {"Dense_0": _linear(m.linear)}
    if m.norm is not None:
        spec["LayerNorm_0"] = _norm(m.norm)
    return spec


def _cnn(m: CNNEncoderDV3) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    for i, conv in enumerate(m.convs):
        spec[f"Conv_{i}"] = _conv(conv)
        if m.norms is not None:
            spec[f"LayerNorm_{i}"] = _norm(m.norms[i])
    return spec


def _head(m: _StochHead) -> Dict[str, Any]:
    return {"DenseStack_0": _stack(m.stack), "Dense_0": _linear(m.head)}


def _rssm(m: RSSM) -> Dict[str, Any]:
    recurrent: RecurrentModel = m.recurrent_model
    spec: Dict[str, Any] = {
        "recurrent_model": {"DenseStack_0": _stack(recurrent.stack), "LayerNormGRUCell_0": _gru(recurrent.cell)},
        "representation_model": _head(m.representation_model),
        "transition_model": _head(m.transition_model),
    }
    if isinstance(m.initial_recurrent_state, nn.Parameter):
        spec["initial_recurrent_state"] = (m.initial_recurrent_state, "same")
    return spec


def param_spec(world_model: WorldModel, actor: Actor) -> Dict[str, Any]:
    """The port's parameters in the layout of the flax trees; each leaf is
    ``(tensor, kind)``, the kind naming how the flax array maps onto it."""
    wm: Dict[str, Any] = {"rssm": _rssm(world_model.rssm)}
    if world_model.cnn_encoder is not None:
        wm["cnn_encoder"] = _cnn(world_model.cnn_encoder)
    if world_model.mlp_encoder is not None:
        mlp: MLPEncoderDV3 = world_model.mlp_encoder
        wm["mlp_encoder"] = {"DenseStack_0": _stack(mlp.stack)}
    act: Dict[str, Any] = {"model": _stack(actor.model)}
    for i, head in enumerate(actor.heads):
        act[f"heads_{i}"] = _linear(head)
    return {"world_model": {"params": wm}, "actor": {"params": act}}


def _to_torch(array: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return array.T
    if kind == "conv":
        return array.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return array


def _to_flax(array: np.ndarray, kind: str) -> np.ndarray:
    if kind == "dense":
        return array.T
    if kind == "conv":
        return array.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return array


def _skipped(path: str) -> Tuple[str, ...]:
    if path == "/world_model/params":
        return SKIPPED_WORLD_MODEL
    if path == "":
        return SKIPPED_TOP
    return ()


@torch.no_grad()
def _load(spec: Mapping[str, Any], tree: Any, path: str) -> None:
    if not isinstance(tree, Mapping):
        raise TypeError(f"flax params at '{path or '/'}' must be a mapping, got {type(tree).__name__}")
    unknown = set(tree) - set(spec) - set(_skipped(path))
    missing = set(spec) - set(tree)
    if unknown or missing:
        raise KeyError(f"flax params at '{path or '/'}': unknown keys {sorted(unknown)}, missing keys {sorted(missing)}")
    for key, sub in spec.items():
        where = f"{path}/{key}"
        if isinstance(sub, dict):
            _load(sub, tree[key], where)
            continue
        tensor, kind = sub
        value = _to_torch(np.asarray(tree[key]), kind)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"flax param '{where}' maps to shape {tuple(value.shape)}, the port has {tuple(tensor.shape)}")
        tensor.copy_(torch.tensor(value))  # a copy: checkpoint arrays may be read-only


def from_flax(tree: Mapping[str, Any], world_model: WorldModel, actor: Actor) -> None:
    """Copy ``{"world_model": {"params": ...}, "actor": {"params": ...}}``
    (plus, skipped, the critics) into the port's modules, strictly."""
    _load(param_spec(world_model, actor), tree, "")


def _dump(spec: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, sub in spec.items():
        if isinstance(sub, dict):
            out[key] = _dump(sub)
        else:
            tensor, kind = sub
            out[key] = np.ascontiguousarray(_to_flax(tensor.detach().cpu().numpy(), kind))
    return out


def to_flax(world_model: WorldModel, actor: Actor) -> Dict[str, Any]:
    """The port's weights as the JAX package's param trees (numpy)."""
    return _dump(param_spec(world_model, actor))
