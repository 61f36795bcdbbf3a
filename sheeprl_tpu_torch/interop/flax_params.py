"""Weights across the two packages: the JAX package's flax param trees
(numpy, as its checkpoints store them) to the port's DV3 (and its JEPA
heads, and Plan2Explore's exploration actors, critics and stacked
ensembles on DreamerV3, V2 and V1; DreamerV2's and DreamerV1's), PPO and
A2C, recurrent PPO, SAC, DroQ and SAC-AE modules and back.

Rules: Dense ``kernel[in, out]`` <-> Linear ``weight[out, in]``; Conv
``kernel`` HWIO <-> ``weight`` OIHW; ConvTranspose ``kernel``
``[kh, kw, in, out]`` <-> ``ConvTranspose2d.weight`` ``[in, out, kh, kw]``
flipped in both spatial axes (flax's ``lax.conv_transpose`` correlates with
the kernel as stored, torch's transposed convolution is the gradient of a
convolution and so applies it flipped); LayerNorm ``scale``/``bias`` <->
``weight``/``bias``; ``rssm/initial_recurrent_state`` as is.  The dense
layer after a flattened conv map (NatureCNN's) also permutes its input rows:
flax flattens the NHWC map in (H, W, C) order, torch the NCHW map in
(C, H, W) order (kind ``dense_nhwc``, which carries ``(H, W, C)``); a
dense layer whose output flax reshapes to an NHWC map (SAC-AE's decoder)
permutes its output rows and bias the same way (``dense_to_hwc``,
``bias_hwc``).  Stacked ensembles (flax's ``nn.vmap``) keep their layout.  Both
directions walk one spec of the port's modules, laid out in the flax tree's
own names, so they cannot disagree.  The walk is strict: a key missing on
either side or a shape that differs raises.  Training reads and writes all
four trees; serving reads only what a policy acts with
(:func:`from_flax_policy`), and the subtrees it does not act with
(:data:`NOT_ACTED_WITH`) may be in the checkpoint or not.

Optimizer state crosses both ways in optax's layout: optax's
``chain(clip_by_global_norm, adam)`` state holds ``ScaleByAdamState(count,
mu, nu)``, whose ``mu`` and ``nu`` are trees laid out like the params; they
become ``torch.optim.Adam``'s ``exp_avg`` and ``exp_avg_sq`` by the same
layout rules, and ``count`` its ``step`` (:func:`optimizer_state_dict`), and
back (:func:`optax_state`), so each package resumes the other's checkpoints.
PPO's chain has ``clip_by_global_norm`` only with ``algo.max_grad_norm > 0``
and a ``ScaleByScheduleState(count)`` after Adam's with ``algo.anneal_lr``.
optax's ``rmsprop`` (A2C) holds ``(ScaleByRmsState(nu), EmptyState(),
TraceState(trace))``, the last an ``EmptyState()`` without momentum; ``nu``
and ``trace`` are the port's :class:`~sheeprl_tpu_torch.utils.optim.RMSprop`
state of the same names (:func:`optax_state` lists its other variants,
``sgd``'s and ``adamw``'s).  An optimizer over several trees (DreamerV3-JEPA's
world model and its heads) has a list as its spec, and optax a tuple of
trees, in the same order (SAC-AE's critic optimizer over ``(encoder,
critic)``), and a bare array (SAC's ``log_alpha``) a leaf.  Plan2Explore-DV3's
per-critic optimizers nest under ``opt_states["critics_exploration"][name]``,
as the JAX package's do; P2E-DV2's and P2E-DV1's six sit flat.  bf16
weights are written as float32, which holds them exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from sheeprl_tpu_torch.algos.dreamer_v3.agent import (
    RSSM,
    Actor,
    CNNDecoderDV3,
    CNNEncoderDV3,
    Critic,
    DenseStack,
    MLPDecoderDV3,
    MLPEncoderDV3,
    PredictionHead,
    RecurrentModel,
    WorldModel,
    _StochHead,
)
from sheeprl_tpu_torch.models.blocks import MLP, LayerNormGRUCell


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


def _conv_transpose(m: nn.ConvTranspose2d) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"kernel": (m.weight, "conv_transpose")}
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


def _head(m: _StochHead | PredictionHead) -> Dict[str, Any]:
    return {"DenseStack_0": _stack(m.stack), "Dense_0": _linear(m.head)}


def _cnn_decoder(m: CNNDecoderDV3) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"Dense_0": _linear(m.dense)}
    for i, deconv in enumerate(m.deconvs):
        spec[f"ConvTranspose_{i}"] = _conv_transpose(deconv)
        if m.norms is not None:
            spec[f"LayerNorm_{i}"] = _norm(m.norms[i])
    spec[f"ConvTranspose_{len(m.deconvs)}"] = _conv_transpose(m.out)
    return spec


def _mlp_decoder(m: MLPDecoderDV3) -> Dict[str, Any]:
    spec: Dict[str, Any] = {"DenseStack_0": _stack(m.stack)}
    for i, head in enumerate(m.heads):
        spec[f"Dense_{i}"] = _linear(head)
    return spec


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


#: by path in the trees, the subtrees a policy does not act with: serving
#: reads a checkpoint whether it holds them or not, as the JAX package's
#: ``build_policy`` does
NOT_ACTED_WITH: Dict[str, Set[str]] = {
    "": {"critic", "target_critic"},
    "/world_model/params": {"cnn_decoder", "mlp_decoder", "reward_model", "continue_model"},
}


def _encoders(m: WorldModel | Any) -> Dict[str, Any]:
    """The ``cnn_encoder`` / ``mlp_encoder`` subtrees of a world model (or
    of DreamerV3-JEPA's copy of its encoders)."""
    spec: Dict[str, Any] = {}
    if m.cnn_encoder is not None:
        spec["cnn_encoder"] = _cnn(m.cnn_encoder)
    if m.mlp_encoder is not None:
        mlp: MLPEncoderDV3 = m.mlp_encoder
        spec["mlp_encoder"] = {"DenseStack_0": _stack(mlp.stack)}
    return spec


def policy_spec(world_model: WorldModel, actor: Actor) -> Dict[str, Any]:
    """What a policy acts with, in the layout of the flax trees: the world
    model's encoders and RSSM, and the actor.  Each leaf is ``(tensor,
    kind)``, the kind naming how the flax array maps onto it."""
    wm: Dict[str, Any] = {"rssm": _rssm(world_model.rssm), **_encoders(world_model)}
    return {"world_model": {"params": wm}, "actor": actor_spec(actor)}


def actor_spec(actor: Actor) -> Dict[str, Any]:
    """An actor's flax tree: ``{"params": {"model": ..., "heads_<i>": ...}}``."""
    act: Dict[str, Any] = {"model": _stack(actor.model)}
    for i, head in enumerate(actor.heads):
        act[f"heads_{i}"] = _linear(head)
    return {"params": act}


def param_spec(world_model: WorldModel, actor: Actor, critic: Critic,
               target_critic: Optional[Critic] = None) -> Dict[str, Any]:
    """The port's parameters, all four trees (three for DreamerV1, which
    has no target critic), in the layout of the flax trees (see
    :func:`policy_spec`).  DreamerV1's Gaussian RSSM has DreamerV3's
    layout: the plain GRU's biased ``Dense_0`` without ``LayerNorm_0``, the
    heads emitting ``(mean, raw std)``; DreamerV2's GRU Dense has no bias."""
    spec = policy_spec(world_model, actor)
    wm = spec["world_model"]["params"]
    wm["reward_model"] = _head(world_model.reward_model)
    wm["continue_model"] = _head(world_model.continue_model)
    if world_model.cnn_decoder is not None:
        wm["cnn_decoder"] = _cnn_decoder(world_model.cnn_decoder)
    if world_model.mlp_decoder is not None:
        wm["mlp_decoder"] = _mlp_decoder(world_model.mlp_decoder)
    spec["critic"] = {"params": _head(critic)}
    if target_critic is not None:
        spec["target_critic"] = {"params": _head(target_critic)}
    return spec


def jepa_spec(heads) -> Dict[str, Any]:
    """DreamerV3-JEPA's heads in the layout of the JAX package's ``jepa``
    tree: ``projector`` and ``target_projector`` (``Dense_0``,
    ``LayerNorm_0``, ``Dense_1``), ``predictor`` (``Dense_0``, ``Dense_1``),
    each under ``params``, and ``target_encoder`` as the world model's
    encoder subtrees."""

    def projector(m) -> Dict[str, Any]:
        return {"params": {"Dense_0": _linear(m.dense_0), "LayerNorm_0": _norm(m.norm), "Dense_1": _linear(m.dense_1)}}

    return {
        "projector": projector(heads.projector),
        "predictor": {"params": {"Dense_0": _linear(heads.predictor.dense_0),
                                 "Dense_1": _linear(heads.predictor.dense_1)}},
        "target_encoder": {"params": _encoders(heads.target_encoder)},
        "target_projector": projector(heads.target_projector),
    }


def jepa_from_flax(tree: Mapping[str, Any], heads) -> None:
    """Copy a checkpoint's ``jepa`` tree into the heads, strictly."""
    _load(jepa_spec(heads), tree, "", {})


def jepa_to_flax(heads) -> Dict[str, Any]:
    """The heads as the JAX package's ``jepa`` tree (numpy)."""
    return _dump(jepa_spec(heads))


def critic_spec(critic: Critic) -> Dict[str, Any]:
    """A critic's flax tree: ``{"params": {"DenseStack_0", "Dense_0"}}``."""
    return {"params": _head(critic)}


def ensemble_spec(ensemble) -> Dict[str, Any]:
    """Plan2Explore's ensemble, the flax tree of N members stacked on a
    leading axis (``jax.vmap`` of one member's init): ``DenseStack_0`` of
    ``Dense_<i>`` kernels ``[N, in, out]`` and ``LayerNorm_<i>`` ``[N,
    units]`` (without the LayerNorm each ``Dense_<i>`` has its bias ``[N,
    units]`` instead), then the head ``Dense_0`` ``[N, units, out]`` with its
    bias; the port keeps them in that layout."""
    stack: Dict[str, Any] = {}
    for i, kernel in enumerate(ensemble.kernels):
        if ensemble.layer_norm:
            stack[f"Dense_{i}"] = {"kernel": (kernel, "same")}
            stack[f"LayerNorm_{i}"] = {"scale": (ensemble.scales[i], "same"), "bias": (ensemble.biases[i], "same")}
        else:
            stack[f"Dense_{i}"] = {"kernel": (kernel, "same"), "bias": (ensemble.dense_biases[i], "same")}
    return {"params": {"DenseStack_0": stack,
                       "Dense_0": {"kernel": (ensemble.out_kernel, "same"), "bias": (ensemble.out_bias, "same")}}}


def p2e_spec(agent) -> Dict[str, Any]:
    """Plan2Explore-DV3's seven trees in the JAX package's layout:
    DreamerV3's four as ``world_model``, ``actor_task``, ``critic_task``,
    ``target_critic_task``; ``actor_exploration``; ``critics_exploration``
    (``{name: {module, target_module}}``); ``ensembles``."""
    dv3 = param_spec(agent.world_model, agent.actor_task, agent.critic_task, agent.target_critic_task)
    return {
        "world_model": dv3["world_model"], "actor_task": dv3["actor"], "critic_task": dv3["critic"],
        "target_critic_task": dv3["target_critic"], "actor_exploration": actor_spec(agent.actor_exploration),
        "critics_exploration": {name: {"module": critic_spec(c.module), "target_module": critic_spec(c.target_module)}
                                for name, c in agent.critics_exploration.items()},
        "ensembles": ensemble_spec(agent.ensembles),
    }


def p2e_dreamer_spec(agent) -> Dict[str, Any]:
    """Plan2Explore-DV2's eight trees (or P2E-DV1's six) in the JAX
    package's layout: DreamerV2's (DreamerV1's) four (three) as
    ``world_model``, ``actor_task``, ``critic_task`` and
    ``target_critic_task`` (none for DV1); ``actor_exploration``; one
    ``critic_exploration`` with ``target_critic_exploration`` (none for
    DV1), each a critic's flax tree as DreamerV2's critic is, not P2E-DV3's
    ``{name: {module, target_module}}``; ``ensembles``."""
    dv = param_spec(agent.world_model, agent.actor_task, agent.critic_task, getattr(agent, "target_critic_task", None))
    spec = {"world_model": dv["world_model"], "actor_task": dv["actor"], "critic_task": dv["critic"]}
    if "target_critic" in dv:
        spec["target_critic_task"] = dv["target_critic"]
    spec["actor_exploration"] = actor_spec(agent.actor_exploration)
    spec["critic_exploration"] = critic_spec(agent.critic_exploration)
    if hasattr(agent, "target_critic_exploration"):
        spec["target_critic_exploration"] = critic_spec(agent.target_critic_exploration)
    spec["ensembles"] = ensemble_spec(agent.ensembles)
    return spec


def load_trees(spec: Mapping[str, Any], tree: Mapping[str, Any]) -> None:
    """Copy the trees of ``spec`` (its top-level keys, each a tree) out of a
    checkpoint's ``tree``, strictly; its other keys are not read."""
    _load(spec, {k: tree[k] for k in spec if k in tree}, "", {})


def dump_trees(spec: Mapping[str, Any]) -> Dict[str, Any]:
    """The trees of ``spec`` in the JAX package's layout (numpy)."""
    return _dump(spec)


def _mlp(m: MLP) -> Dict[str, Any]:
    """The JAX ``MLP``: ``Dense_i`` / ``LayerNorm_i`` per hidden layer, then
    the output layer as the next ``Dense``."""
    spec: Dict[str, Any] = {}
    for i, dense in enumerate(m.dense):
        spec[f"Dense_{i}"] = _linear(dense)
        if m.norms is not None:
            spec[f"LayerNorm_{i}"] = _norm(m.norms[i])
    if m.out is not None:
        spec[f"Dense_{len(m.dense)}"] = _linear(m.out)
    return spec


def ppo_spec(agent) -> Dict[str, Any]:
    """The PPO agent's parameters in the layout of the JAX ``PPOAgent``'s
    flax tree (``{"params": {...}}``)."""
    params: Dict[str, Any] = {}
    if agent.cnn_encoder is not None:
        cnn = agent.cnn_encoder
        nature = {f"Conv_{i}": _conv(conv) for i, conv in enumerate(cnn.convs)}
        nature["Dense_0"] = {"kernel": (cnn.dense.weight, "dense_nhwc", cnn.dense.flatten_hwc),
                             "bias": (cnn.dense.bias, "same")}
        params["_cnn_enc"] = {"NatureCNN_0": nature}
    if agent.mlp_encoder is not None:
        params["_mlp_enc"] = {"MLP_0": _mlp(agent.mlp_encoder)}
    backbone = _mlp(agent.actor_backbone)
    if backbone:
        params["actor_backbone"] = backbone
    for i, head in enumerate(agent.actor_heads):
        params[f"actor_heads_{i}"] = _linear(head)
    params["critic"] = _mlp(agent.critic)
    return {"params": params}


def ppo_from_flax(tree: Mapping[str, Any], agent) -> None:
    """Copy a flax ``PPOAgent`` tree into the port's agent, strictly."""
    _load(ppo_spec(agent), tree, "", {})


def ppo_to_flax(agent) -> Dict[str, Any]:
    """The port's PPO agent as the JAX package's flax tree (numpy)."""
    return _dump(ppo_spec(agent))


def ppo_recurrent_spec(agent) -> Dict[str, Any]:
    """The recurrent PPO agent's parameters in the layout of the JAX
    ``RecurrentPPOAgent``'s flax tree: PPO's encoders, ``_pre_mlp`` and
    ``_post_mlp`` when applied, the LSTM as ``_cell/OptimizedLSTMCell_0``
    (the input kernels ``ii/if/ig/io`` without a bias, the hidden kernels
    ``hi/hf/hg/ho`` with one), the actor's backbone and heads, the critic."""
    params: Dict[str, Any] = {}
    if agent.cnn_encoder is not None:
        cnn = agent.cnn_encoder
        nature = {f"Conv_{i}": _conv(conv) for i, conv in enumerate(cnn.convs)}
        nature["Dense_0"] = {"kernel": (cnn.dense.weight, "dense_nhwc", cnn.dense.flatten_hwc),
                             "bias": (cnn.dense.bias, "same")}
        params["_cnn_enc"] = {"NatureCNN_0": nature}
    if agent.mlp_encoder is not None:
        params["_mlp_enc"] = {"MLP_0": _mlp(agent.mlp_encoder)}
    if agent.pre_mlp is not None:
        params["_pre_mlp"] = _mlp(agent.pre_mlp)
    params["_cell"] = {"OptimizedLSTMCell_0": {k: _linear(m) for k, m in agent.lstm.gates.items()}}
    if agent.post_mlp is not None:
        params["_post_mlp"] = _mlp(agent.post_mlp)
    backbone = _mlp(agent.actor_backbone)
    if backbone:
        params["actor_backbone"] = backbone
    for i, head in enumerate(agent.actor_heads):
        params[f"actor_heads_{i}"] = _linear(head)
    params["critic"] = _mlp(agent.critic)
    return {"params": params}


def ppo_recurrent_from_flax(tree: Mapping[str, Any], agent) -> None:
    """Copy a flax ``RecurrentPPOAgent`` tree into the port's agent, strictly."""
    _load(ppo_recurrent_spec(agent), tree, "", {})


def ppo_recurrent_to_flax(agent) -> Dict[str, Any]:
    """The port's recurrent PPO agent as the JAX package's flax tree (numpy)."""
    return _dump(ppo_recurrent_spec(agent))


def sac_actor_spec(actor) -> Dict[str, Any]:
    """A SAC (or SAC-AE) actor's flax tree: the ``MLP_0`` stack, then the
    mean (``Dense_0``) and log-std (``Dense_1``) heads."""
    return {"params": {"MLP_0": {f"Dense_{i}": _linear(d) for i, d in enumerate(actor.dense)},
                       "Dense_0": _linear(actor.fc_mean), "Dense_1": _linear(actor.fc_logstd)}}


def stacked_critic_spec(critic) -> Dict[str, Any]:
    """A critic ensemble as flax's ``nn.vmap`` stores it, kernels ``[N, in,
    out]`` and biases ``[N, out]`` in the port's layout too: SAC's and
    SAC-AE's ``Vmap_QNetwork_0/MLP_0/Dense_<i>``, DroQ's
    ``Vmap_DroQQNetwork_0/{Dense_<i>, LayerNorm_<i>}``."""
    layers: Dict[str, Any] = {f"Dense_{i}": {"kernel": (k, "same"), "bias": (b, "same")}
                              for i, (k, b) in enumerate(zip(critic.kernels, critic.biases))}
    if not hasattr(critic, "norm_scales"):
        return {"params": {"Vmap_QNetwork_0": {"MLP_0": layers}}}
    for i, (scale, bias) in enumerate(zip(critic.norm_scales, critic.norm_biases)):
        layers[f"LayerNorm_{i}"] = {"scale": (scale, "same"), "bias": (bias, "same")}
    return {"params": {"Vmap_DroQQNetwork_0": layers}}


def sac_spec(agent) -> Dict[str, Any]:
    """SAC's and DroQ's four trees in the JAX package's layout: ``actor``,
    ``critic``, ``target_critic`` and the bare ``log_alpha`` array."""
    return {"actor": sac_actor_spec(agent.actor), "critic": stacked_critic_spec(agent.critic),
            "target_critic": stacked_critic_spec(agent.target_critic), "log_alpha": (agent.log_alpha, "same")}


def sac_ae_encoder_spec(encoder) -> Dict[str, Any]:
    """SAC-AE's encoder: the four ``Conv_<i>``, the pixel branch's dense
    layer (over the map flattened in (H, W, C) order) and LayerNorm, then
    the vector branch's ``MLP_0``, dense layer and LayerNorm, numbered on
    from the pixel branch's."""
    spec: Dict[str, Any] = {}
    n = 0
    if encoder.convs is not None:
        spec.update({f"Conv_{i}": _conv(c) for i, c in enumerate(encoder.convs)})
        spec["Dense_0"] = {"kernel": (encoder.cnn_fc.weight, "dense_nhwc", encoder.cnn_fc.flatten_hwc),
                           "bias": (encoder.cnn_fc.bias, "same")}
        spec["LayerNorm_0"] = _norm(encoder.cnn_norm)
        n = 1
    if encoder.mlp is not None:
        spec["MLP_0"] = _mlp(encoder.mlp)
        spec[f"Dense_{n}"] = _linear(encoder.mlp_fc)
        spec[f"LayerNorm_{n}"] = _norm(encoder.mlp_norm)
    return {"params": spec}


def sac_ae_decoder_spec(decoder) -> Dict[str, Any]:
    """SAC-AE's decoder: the dense layer to the (H, W, C) map, the four
    ``ConvTranspose_<i>``, then the vector branch's ``MLP_0`` and its output
    ``Dense``."""
    spec: Dict[str, Any] = {}
    n = 0
    if decoder.deconvs is not None:
        hwc = decoder.fc.map_hwc
        spec["Dense_0"] = {"kernel": (decoder.fc.weight, "dense_to_hwc", hwc), "bias": (decoder.fc.bias, "bias_hwc", hwc)}
        spec.update({f"ConvTranspose_{i}": _conv_transpose(c) for i, c in enumerate(decoder.deconvs)})
        n = 1
    if decoder.mlp is not None:
        spec["MLP_0"] = _mlp(decoder.mlp)
        spec[f"Dense_{n}"] = _linear(decoder.mlp_out)
    return {"params": spec}


def sac_ae_spec(agent) -> Dict[str, Any]:
    """SAC-AE's seven trees in the JAX package's layout: ``encoder``,
    ``decoder``, ``actor``, ``critic``, ``target_encoder``,
    ``target_critic`` and ``log_alpha``."""
    return {"encoder": sac_ae_encoder_spec(agent.encoder), "decoder": sac_ae_decoder_spec(agent.decoder),
            "actor": sac_actor_spec(agent.actor), "critic": stacked_critic_spec(agent.critic),
            "target_encoder": sac_ae_encoder_spec(agent.target_encoder),
            "target_critic": stacked_critic_spec(agent.target_critic), "log_alpha": (agent.log_alpha, "same")}


def _to_torch(array: torch.Tensor, kind: str, hwc: Tuple[int, int, int] = ()) -> torch.Tensor:
    """A flax leaf, as a tensor, as a view in the port's layout."""
    if kind == "dense":
        return array.T
    if kind == "dense_nhwc":
        h, w, c = hwc
        return array.reshape(h, w, c, -1).permute(2, 0, 1, 3).reshape(c * h * w, -1).T
    if kind == "dense_to_hwc":
        h, w, c = hwc
        return array.reshape(-1, h, w, c).permute(0, 3, 1, 2).reshape(-1, c * h * w).T
    if kind == "bias_hwc":
        h, w, c = hwc
        return array.reshape(h, w, c).permute(2, 0, 1).reshape(-1)
    if kind == "conv":
        return array.permute(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "conv_transpose":
        return array.permute(2, 3, 0, 1).flip((2, 3))  # [kh, kw, in, out] -> [in, out, kh, kw], flipped
    return array


def _to_flax(array: torch.Tensor, kind: str, hwc: Tuple[int, int, int] = ()) -> torch.Tensor:
    """A port tensor as a view in the flax layout."""
    if kind == "dense":
        return array.T
    if kind == "dense_nhwc":
        h, w, c = hwc
        return array.T.reshape(c, h, w, -1).permute(1, 2, 0, 3).reshape(h * w * c, -1)
    if kind == "dense_to_hwc":
        h, w, c = hwc
        return array.T.reshape(-1, c, h, w).permute(0, 2, 3, 1).reshape(-1, h * w * c)
    if kind == "bias_hwc":
        h, w, c = hwc
        return array.reshape(c, h, w).permute(1, 2, 0).reshape(-1)
    if kind == "conv":
        return array.permute(2, 3, 1, 0)  # OIHW -> HWIO
    if kind == "conv_transpose":
        return array.flip((2, 3)).permute(2, 3, 0, 1)
    return array


def _flax_array(tensor: torch.Tensor, kind: str, *meta: Any) -> np.ndarray:
    """A port tensor as a flax leaf: a C-ordered float32 numpy array of its
    own.  The layout is changed where the tensor lives (on the card, or by
    torch's threaded copy on the CPU), then copied to the host once; a copy
    even on the CPU, where the live weights and optimizer state change in
    place at the next step."""
    value = _to_flax(tensor.detach().float(), kind, *meta).clone(memory_format=torch.contiguous_format)
    return value.cpu().numpy()


def _from_flax_array(tree: Any, kind: str, *meta: Any) -> np.ndarray:
    """A checkpoint's flax leaf in the port's layout: a C-ordered numpy array
    of its own, made by torch's threaded copy (optax's bfloat16 moments as
    float32, which holds them exactly)."""
    array = np.asarray(tree)
    if array.dtype.name == "bfloat16":
        array = array.astype(np.float32)
    if not array.flags.writeable:
        array = array.copy()
    return _to_torch(torch.from_numpy(array), kind, *meta).clone(memory_format=torch.contiguous_format).numpy()


def _walk(spec: Mapping[str, Any] | list, tree: Any, path: str,
          unread: Mapping[str, Set[str]]) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """``(tensor, value)`` for every leaf of ``spec``, ``value`` the flax
    array of ``tree`` at the same path in the port's layout; strict.  A list
    in ``spec`` walks a tuple of trees, a leaf (a bare array such as SAC's
    ``log_alpha``) one array."""
    if isinstance(spec, tuple):
        tensor, kind, *meta = spec
        value = _from_flax_array(tree, kind, *meta)
        if tuple(value.shape) != tuple(tensor.shape):
            raise ValueError(f"flax param '{path or '/'}' maps to shape {tuple(value.shape)}, the port has "
                             f"{tuple(tensor.shape)}")
        yield tensor, value
        return
    if isinstance(spec, list):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(spec):
            raise TypeError(f"flax params at '{path or '/'}' must be a sequence of {len(spec)} trees, "
                            f"got {tree!r:.100}")
        for i, (sub, sub_tree) in enumerate(zip(spec, tree)):
            yield from _walk(sub, sub_tree, f"{path}/{i}", unread)
        return
    if not isinstance(tree, Mapping):
        raise TypeError(f"flax params at '{path or '/'}' must be a mapping, got {type(tree).__name__}")
    unknown = set(tree) - set(spec) - unread.get(path, set())
    missing = set(spec) - set(tree)
    if unknown or missing:
        raise KeyError(f"flax params at '{path or '/'}': unknown keys {sorted(unknown)}, missing keys {sorted(missing)}")
    for key, sub in spec.items():
        where = f"{path}/{key}"
        yield from _walk(sub, tree[key], where, unread)


@torch.no_grad()
def _load(spec: Mapping[str, Any], tree: Any, path: str, unread: Mapping[str, Set[str]]) -> None:
    for tensor, value in _walk(spec, tree, path, unread):
        tensor.copy_(torch.from_numpy(value))


def from_flax(tree: Mapping[str, Any], world_model: WorldModel, actor: Actor, critic: Critic,
              target_critic: Optional[Critic] = None) -> None:
    """Copy ``{"world_model": {"params": ...}, "actor": ..., "critic": ...,
    "target_critic": ...}`` into the port's modules, strictly."""
    _load(param_spec(world_model, actor, critic, target_critic), tree, "", {})


def from_flax_policy(tree: Mapping[str, Any], world_model: WorldModel, actor: Actor) -> None:
    """Copy what a policy acts with out of a checkpoint's trees, strictly;
    the subtrees of :data:`NOT_ACTED_WITH` are not read and may be absent."""
    _load(policy_spec(world_model, actor), tree, "", NOT_ACTED_WITH)


def _dump(spec: Mapping[str, Any]) -> Dict[str, Any]:
    return _map_spec(spec, _flax_array)


def to_flax(world_model: WorldModel, actor: Actor, critic: Critic,
            target_critic: Optional[Critic] = None) -> Dict[str, Any]:
    """The port's weights as the JAX package's four param trees (numpy)."""
    return _dump(param_spec(world_model, actor, critic, target_critic))


def _optax_node(node: Any, name: str) -> Any:
    """The optax state class ``name`` anywhere in a chain's nested state
    (the port reads optax classes as ``ForeignObject`` tuples of their
    fields, named as the class)."""
    if type(node).__name__ == name:
        return node
    if isinstance(node, (tuple, list)):
        for sub in node:
            found = _optax_node(sub, name)
            if found is not None:
                return found
    return None


def _map_spec(spec: Mapping[str, Any] | list | tuple, fn) -> Any:
    if isinstance(spec, tuple):
        return fn(*spec)
    if isinstance(spec, list):
        return tuple(_map_spec(sub, fn) for sub in spec)
    return {key: _map_spec(sub, fn) for key, sub in spec.items()}


def optax_state(optimizer: torch.optim.Optimizer, spec: Mapping[str, Any] | list, clip: bool = True,
                schedule: bool = False) -> Any:
    """``optimizer``'s state as the tree the JAX package pickles for optax's
    ``chain(clip_by_global_norm(c), <optimizer>)``: ``(EmptyState(),
    <the optimizer's chain>)``, or ``(<the optimizer's chain>,)`` without
    ``clip``.  Its moments are laid out as ``spec`` (the module's subtree
    of :func:`param_spec`, or :func:`ppo_spec`), its count is the step as
    int32, and the rate's state is ``EmptyState()``, or
    ``ScaleByScheduleState(count)`` with ``schedule`` (the rate a
    schedule).  The optimizers' chains:

    - Adam (``torch.optim.Adam``, or :class:`OptaxAdam` without a decay):
      ``(ScaleByAdamState(count, mu, nu), <rate>)``;
    - AdamW (``torch.optim.AdamW``, or :class:`OptaxAdam` with one):
      ``add_decayed_weights``' ``EmptyState()`` between the two, a
      ``MaskedState(EmptyState())`` with a ``mask``;
    - :class:`RMSprop`: ``(<rms>, <rate>, TraceState(trace))``, an
      ``EmptyState()`` for the trace without momentum; ``<rms>`` is
      ``ScaleByRmsState(nu)``, ``ScaleByRStdDevState(mu, nu)`` when
      ``centered``, each ``...WithCountState(count, ...)`` with
      ``bias_correction``;
    - :class:`SGD`: ``(TraceState(trace), <rate>)``, an ``EmptyState()``
      for the trace without momentum.

    A parameter Adam has not stepped yet holds zeros, as optax's ``init``
    does."""
    from sheeprl_tpu_torch.utils.checkpoint import OptaxState
    from sheeprl_tpu_torch.utils.optim import SGD, OptaxAdam, RMSprop

    empty = OptaxState.make("optax._src.base", "EmptyState")
    trace_state = OptaxState.make("optax.transforms._accumulation", "TraceState")

    def slot(name: str):
        def leaf(tensor: torch.Tensor, kind: str, *meta: Any) -> np.ndarray:
            entry = optimizer.state.get(tensor)
            return _flax_array(entry[name] if entry else torch.zeros_like(tensor), kind, *meta)
        return leaf

    steps = {float(s["step"]) for s in optimizer.state.values() if "step" in s}
    if len(steps) > 1:
        raise ValueError(f"the optimizer's parameters disagree on the step count: {sorted(steps)}")
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    rate = OptaxState.make("optax._src.transform", "ScaleByScheduleState")(count.copy()) if schedule else empty()
    group = optimizer.param_groups[0]
    if isinstance(optimizer, RMSprop):
        fields = (_map_spec(spec, slot("mu")),) if group["centered"] else ()
        fields += (_map_spec(spec, slot("nu")),)
        name = "ScaleByRStdDev" if group["centered"] else "ScaleByRms"
        if group["bias_correction"]:
            name, fields = name + "WithCountState", (count.copy(), *fields)
        else:
            name += "State"
        trace = empty() if group["momentum"] is None else trace_state(_map_spec(spec, slot("trace")))
        base = (OptaxState.make("optax._src.transform", name)(*fields), rate, trace)
    elif isinstance(optimizer, SGD):
        trace = empty() if group["momentum"] is None else trace_state(_map_spec(spec, slot("trace")))
        base = (trace, rate)
    else:
        adam = OptaxState.make("optax._src.transform", "ScaleByAdamState")
        # optax's adamw chains add_decayed_weights between the two
        decay: tuple = ()
        if isinstance(optimizer, torch.optim.AdamW):
            decay = (empty(),)
        elif isinstance(optimizer, OptaxAdam) and group["weight_decay"] is not None:
            decay = (empty() if optimizer.mask is None
                     else OptaxState.make("optax.transforms._masking", "MaskedState")(empty()),)
        base = (adam(count, _map_spec(spec, slot("exp_avg")), _map_spec(spec, slot("exp_avg_sq"))), *decay, rate)
    return (empty(), base) if clip else (base,)


def _state_tensor(value: np.ndarray) -> torch.Tensor:
    """A saved state leaf from :func:`_walk` (an array of its own; optax's
    bfloat16 moments, an ``mu_dtype``, come as float32, which holds them
    exactly: the optimizer takes them to its own dtype) as a tensor."""
    return torch.from_numpy(value)


def optimizer_state_dict(saved: Any, optimizer: torch.optim.Optimizer,
                         spec: Mapping[str, Any] | list) -> Dict[str, Any]:
    """``optimizer``'s ``state_dict`` restored from a checkpoint's
    ``opt_states[name]``, for ``optimizer.load_state_dict``: the port's own
    (a torch ``state_dict`` stored as numpy) or the JAX package's optax
    chain state (the layouts of :func:`optax_state`), whose moments map
    through ``spec``, the module's subtree of :func:`param_spec`.  The step
    is the chain's count: Adam's, the RMS state's with ``bias_correction``,
    else, for SGD, a schedule's or 0.  The hyperparameters stay those of
    ``optimizer``, as a JAX resume rebuilds its optax chain from the
    config."""
    from sheeprl_tpu_torch.utils.optim import SGD, RMSprop

    groups = optimizer.state_dict()["param_groups"]
    if isinstance(saved, Mapping) and "state" in saved:
        state = {int(i): {k: torch.as_tensor(np.asarray(v)) for k, v in entry.items()}
                 for i, entry in saved["state"].items()}
        return {"state": state, "param_groups": groups}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    index = {id(p): i for i, p in enumerate(params)}
    state: Dict[int, Dict[str, torch.Tensor]] = {}

    def put(tree: Any, name: str) -> None:
        for tensor, value in _walk(spec, tree, "", {}):
            state.setdefault(index[id(tensor)], {})[name] = _state_tensor(value)

    def mismatch(what: str) -> ValueError:
        return ValueError(f"the saved optimizer state is not optax's {what}: {saved!r:.200}")

    group = optimizer.param_groups[0]
    schedule = _optax_node(saved, "ScaleByScheduleState")
    count = schedule[0] if schedule is not None else 0
    if isinstance(optimizer, (RMSprop, SGD)):
        trace = _optax_node(saved, "TraceState")
        if (trace is None) != (group["momentum"] is None):
            raise mismatch(f"{type(optimizer).__name__} with momentum={group['momentum']}")
        if isinstance(optimizer, RMSprop):
            name = ("ScaleByRStdDev" if group["centered"] else "ScaleByRms") + (
                "WithCountState" if group["bias_correction"] else "State")
            rms = _optax_node(saved, name)
            if rms is None:
                raise mismatch(f"rmsprop with centered={group['centered']}, "
                               f"bias_correction={group['bias_correction']}")
            fields = list(rms)
            if group["bias_correction"]:
                count = fields.pop(0)
            if group["centered"]:
                put(fields.pop(0), "mu")
            put(fields[0], "nu")
        if trace is not None:
            put(trace[0], "trace")
        if isinstance(optimizer, SGD) or group["bias_correction"]:
            step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
            for i in range(len(params)):
                state.setdefault(i, {})["step"] = step.clone()
    else:
        adam = _optax_node(saved, "ScaleByAdamState")
        if adam is None:
            raise ValueError(f"no torch state_dict and no optax ScaleByAdamState in the saved optimizer state: "
                             f"{saved!r:.200}")
        count, mu, nu = adam[:3]
        step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
        for (tensor, exp_avg), (_, exp_avg_sq) in zip(_walk(spec, mu, "", {}), _walk(spec, nu, "", {})):
            state[index[id(tensor)]] = {"step": step.clone(), "exp_avg": _state_tensor(exp_avg),
                                        "exp_avg_sq": _state_tensor(exp_avg_sq)}
    if len(state) != len(index):
        raise KeyError(f"the optax state covers {len(state)} of the optimizer's {len(index)} parameters")
    return {"state": state, "param_groups": groups}
