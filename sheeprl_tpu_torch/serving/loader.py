"""Checkpoint discovery and the per-algorithm policy adapters of the serving
tier (counterpart of ``sheeprl_tpu/serving/loader.py``).

A :class:`PolicyHandle` is everything the server needs to turn a checkpoint
into a servable policy: how a request's observation row is validated, how a
group of rows is assembled into one padded batch, the policy step, and how a
*new* checkpoint's agent state becomes a new set of modules for a hot swap
(``load_params``).  The port serves ``dreamer_v3``, a stateful family: its
handle exposes ``make_state_step(greedy)``, a ``(params, state, obs, is_first, generator,
noise=None) -> (actions, new_state)`` step whose ``is_first`` reset is the
same masked blend as ``PlayerDV3``; and ``ppo`` and ``a2c``, served
statelessly, and ``sac``: their handle exposes ``make_step(greedy)``, a
``(params, obs, generator, noise=None) -> actions`` step; and
``ppo_recurrent``, stateful again, its per-session state the LSTM's.  As in
the JAX package, ``dreamer_v3_jepa``, the P2E pair, ``droq``, ``sac_ae``,
``dreamer_v1`` and ``dreamer_v2`` have no adapter.

The health gate (:func:`checkpoint_health`) reads the training run's journal
next to a candidate checkpoint (the ``version_N`` dir it lives under) and
refuses promotion while a learning-health ``anomaly`` has no matching
``anomaly_end`` (:func:`~sheeprl_tpu_torch.diagnostics.report.active_anomalies`).
Standalone checkpoints without a journal are governed by
``serving.reload.allow_unjournaled``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from math import prod
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.envs import spaces

#: algo name -> handle builder (signature: (cfg, obs_space, action_space,
#: agent_state, device))
SERVABLE_BUILDERS: Dict[str, Callable] = {}

_CKPT_RE = re.compile(r"ckpt_(\d+)_\d+\.ckpt$")


def checkpoint_step(path: str) -> Optional[int]:
    """Policy step encoded in a checkpoint filename (``ckpt_{step}_{rank}``),
    or None for foreign spellings (those sort by mtime instead)."""
    match = _CKPT_RE.search(os.path.basename(str(path)))
    return int(match.group(1)) if match else None


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest checkpoint in a directory: highest encoded step, falling back
    to mtime for filenames the step pattern does not match."""
    try:
        names = [n for n in os.listdir(str(ckpt_dir)) if n.endswith(".ckpt")]
    except OSError:
        return None
    if not names:
        return None

    def sort_key(name: str) -> Tuple[int, float]:
        step = checkpoint_step(name)
        try:
            mtime = os.path.getmtime(os.path.join(str(ckpt_dir), name))
        except OSError:
            mtime = 0.0
        return (step if step is not None else -1, mtime)

    return os.path.join(str(ckpt_dir), max(names, key=sort_key))


def journal_for_checkpoint(ckpt_path: str) -> Optional[str]:
    """The training run's journal that governs this checkpoint: checkpoints
    land in ``<version_N>/checkpoint/``, the journal in ``<version_N>/``."""
    version_dir = os.path.dirname(os.path.dirname(os.path.abspath(str(ckpt_path))))
    path = os.path.join(version_dir, "journal.jsonl")
    return path if os.path.isfile(path) else None


def checkpoint_health(
    ckpt_path: str,
    health_gate: bool = True,
    allow_unjournaled: bool = True,
) -> Tuple[bool, str, List[Dict[str, Any]]]:
    """Is this checkpoint promotable?  ``(ok, reason, open_anomalies)``: the
    training run's journal next to the checkpoint must hold no ``anomaly``
    without its ``anomaly_end``."""
    if not health_gate:
        return True, "health gate disabled", []
    journal_path = journal_for_checkpoint(ckpt_path)
    if journal_path is None:
        if allow_unjournaled:
            return True, "no training journal (allow_unjournaled)", []
        return False, "no training journal next to the checkpoint", []
    from sheeprl_tpu_torch.diagnostics.report import active_anomalies
    from sheeprl_tpu_torch.diagnostics.journal import read_journal

    open_anomalies = active_anomalies(read_journal(journal_path))
    if open_anomalies:
        kinds = sorted({f"{e.get('kind')}:{e.get('subject')}" for e in open_anomalies})
        return False, f"open learning-health anomalies: {', '.join(kinds)}", open_anomalies
    return True, "journal clean", []


def leaf_dtype_mismatch(tree: Any, path: str = "") -> Optional[str]:
    """The first floating leaf of a checkpoint's agent state that is not
    float32, as ``"<path> dtype <dtype> -> float32"``, else None.  The
    converter would cast such a leaf silently; a served policy's weights are
    float32, so a bf16-stored or wider tree is refused instead."""
    if isinstance(tree, Mapping):
        for key in sorted(tree, key=str):
            found = leaf_dtype_mismatch(tree[key], f"{path}/{key}")
            if found:
                return found
        return None
    if isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            found = leaf_dtype_mismatch(sub, f"{path}/{i}")
            if found:
                return found
        return None
    dtype = getattr(tree, "dtype", None)
    if dtype is not None and not isinstance(dtype, torch.dtype):
        dtype = np.dtype(dtype)
        if (dtype.kind == "f" or "bfloat16" in dtype.name) and dtype != np.float32:
            return f"{path or '/'} dtype {dtype.name} -> float32"
    return None


def _params_loader(build: Callable[[Mapping[str, Any]], Any], device) -> Callable[[Mapping[str, Any]], Any]:
    """``load_params``: a checkpoint's agent state -> NEW modules on the
    handle's device, built through the converter (strict: a missing key or
    another shape raises), the live modules untouched.  On the card it waits
    for the copies, so the first dispatch on the new modules never reads a
    weight still in flight."""
    device = torch.device(device)

    def load_params(agent_state: Mapping[str, Any]) -> Any:
        mismatch = leaf_dtype_mismatch(agent_state)
        if mismatch:
            raise ValueError(mismatch)
        params = build(agent_state)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return params

    return load_params


@dataclass
class PolicyHandle:
    """One servable policy: the algorithm-specific closures the service
    drives.  ``params`` holds the policy's modules on their device;
    ``assemble(rows, width)`` pads a request group to the bucket width with
    zero rows that are sliced off before any response sees them."""

    algo: str
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]]
    action_shape: Tuple[int, ...]
    params: Any
    assemble: Callable[[List[Dict[str, np.ndarray]], int], Any]
    validate: Callable[[Any], Dict[str, np.ndarray]]
    device: torch.device
    ckpt_path: str = ""
    ckpt_step: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)
    stateful: bool = False
    state_spec: Dict[str, Tuple[Tuple[int, ...], str]] = field(default_factory=dict)
    make_state_step: Optional[Callable[[bool], Callable]] = None
    make_step: Optional[Callable[[bool], Callable]] = None
    load_params: Optional[Callable[[Mapping[str, Any]], Any]] = None
    log_row: Optional[Callable[[Dict[str, np.ndarray]], Dict[str, np.ndarray]]] = None

    def zero_obs(self, width: int) -> Any:
        return self.assemble([], width)


def _row_validator(
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]],
) -> Callable[[Any], Dict[str, np.ndarray]]:
    def validate(obs: Any) -> Dict[str, np.ndarray]:
        if not isinstance(obs, dict):
            raise ValueError(f"obs must be a dict of observation keys, got {type(obs).__name__}")
        row: Dict[str, np.ndarray] = {}
        for key, (shape, dtype) in obs_spec.items():
            if key not in obs:
                raise ValueError(f"obs is missing key {key!r} (expected {sorted(obs_spec)})")
            arr = np.asarray(obs[key], dtype=dtype)
            if int(arr.size) != int(prod(shape) if shape else 1):
                raise ValueError(f"obs[{key!r}] has {arr.size} elements, expected shape {tuple(shape)}")
            row[key] = arr.reshape(shape)
        return row

    return validate


def _dict_assembler(
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]],
) -> Callable[[List[Dict[str, np.ndarray]], int], Dict[str, np.ndarray]]:
    def assemble(rows: List[Dict[str, np.ndarray]], width: int) -> Dict[str, np.ndarray]:
        slab: Dict[str, np.ndarray] = {}
        for key, (shape, dtype) in obs_spec.items():
            buf = np.zeros((int(width),) + tuple(shape), dtype=dtype)
            for i, row in enumerate(rows):
                buf[i] = row[key]
            slab[key] = buf
        return slab

    return assemble


def _actions_dim(action_space) -> Tuple[Tuple[int, ...], bool, bool]:
    is_continuous = isinstance(action_space, spaces.Box)
    is_multidiscrete = isinstance(action_space, spaces.MultiDiscrete)
    actions_dim = tuple(
        action_space.shape
        if is_continuous
        else (action_space.nvec.tolist() if is_multidiscrete else [action_space.n])
    )
    return tuple(int(a) for a in actions_dim), is_continuous, is_multidiscrete


def _dreamer_v3_handle(cfg, obs_space, action_space, agent_state, device) -> PolicyHandle:
    """dreamer_v3: the world-model policy served statefully.  Per-session
    state is the RSSM triplet ``{recurrent, stochastic, actions}``; resets
    blend the initial state in by the ``is_first`` mask (``PlayerDV3``'s
    masked reset) and the step follows ``PlayerDV3``'s op order: encode ->
    recurrent_step -> representation -> actor.act.  Image keys travel as raw
    uint8 and are scaled on the device."""
    from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_policy_modules

    actions_dim, is_continuous, _ = _actions_dim(action_space)
    def load_modules(state) -> Dict[str, torch.nn.Module]:
        world_model, actor = build_policy_modules(actions_dim, is_continuous, cfg, obs_space, state, device)
        return {"world_model": world_model.eval(), "actor": actor.eval()}

    params = load_modules(agent_state)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for k in cnn_keys:
        obs_spec[k] = (tuple(obs_space[k].shape), "uint8")
    for k in mlp_keys:
        obs_spec[k] = ((int(prod(obs_space[k].shape)),), "float32")
    wm_cfg = cfg.algo.world_model
    act_sum = int(sum(actions_dim))
    state_spec = {
        "recurrent": ((int(wm_cfg.recurrent_model.recurrent_state_size),), "float32"),
        "stochastic": ((int(wm_cfg.stochastic_size) * int(wm_cfg.discrete_size),), "float32"),
        "actions": ((act_sum,), "float32"),
    }

    def make_state_step(greedy: bool) -> Callable:
        @torch.no_grad()
        def step(p, state, obs, is_first, generator, noise=None):
            """``noise`` may hold ``"representation"`` (Gumbel, ``[B, stoch,
            discrete]``) and ``"actor"`` (one tensor per head)."""
            wm, policy = p["world_model"], p["actor"]
            noise = noise or {}
            n = is_first.shape[0]
            h0, z0 = wm.initial_states((n,))
            init = {"recurrent": h0, "stochastic": z0, "actions": torch.zeros((n, act_sum), device=h0.device)}
            st = {k: is_first * init[k] + (1.0 - is_first) * state[k] for k in init}
            prepared = {k: obs[k].float() / 255.0 - 0.5 for k in cnn_keys}
            prepared.update({k: obs[k] for k in mlp_keys})
            embedded = wm.encode(prepared)
            recurrent = wm.recurrent_step(st["stochastic"], st["actions"], st["recurrent"])
            _, stochastic = wm.representation(
                None if wm.decoupled_rssm else recurrent, embedded, generator, noise.get("representation")
            )
            latent = torch.cat([stochastic, recurrent], dim=-1)
            actions = policy.act(latent, generator, greedy, noise.get("actor"))
            return actions, {"recurrent": recurrent, "stochastic": stochastic, "actions": actions}

        return step

    # dreamer actions are the actor's raw output: the one-hot concat for
    # discrete heads (clients argmax per head), the squashed vector otherwise
    return PolicyHandle(
        algo="dreamer_v3",
        obs_spec=obs_spec,
        action_shape=(act_sum,),
        params=params,
        assemble=_dict_assembler(obs_spec),
        validate=_row_validator(obs_spec),
        device=torch.device(device),
        meta={"is_continuous": is_continuous, "actions_dim": list(actions_dim)},
        stateful=True,
        state_spec=state_spec,
        make_state_step=make_state_step,
        load_params=_params_loader(load_modules, device),
    )


SERVABLE_BUILDERS["dreamer_v3"] = _dreamer_v3_handle


def _ppo_handle(cfg, obs_space, action_space, agent_state, device) -> PolicyHandle:
    """ppo / a2c: the feed-forward agent (the algorithm's own builder)
    served statelessly; one forward returns
    ``(actions, log_prob, entropy, value)`` and serving keeps the actions
    (the argmax of each head when greedy).  Rows carry the observation as
    the env gives it (float32, pixels 0-255, a frame stack's frames
    unfolded); the step folds the frames into the channels, as the
    training player does."""
    import importlib

    agent_module = importlib.import_module(f"sheeprl_tpu_torch.algos.{cfg.algo.name}.agent")
    actions_dim, is_continuous, _ = _actions_dim(action_space)

    def load_agent(state) -> torch.nn.Module:
        return agent_module.build_agent(actions_dim, is_continuous, cfg, obs_space, state, device).eval()

    agent = load_agent(agent_state)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for k in cnn_keys:
        obs_spec[k] = (tuple(obs_space[k].shape), "float32")
    for k in mlp_keys:
        obs_spec[k] = ((int(prod(obs_space[k].shape)),), "float32")

    def make_step(greedy: bool) -> Callable:
        @torch.no_grad()
        def step(p, obs, generator, noise=None):
            """``noise``: the standard-normal draw of a continuous head, or
            a list of Gumbel noise per categorical head."""
            prepared = {k: v.reshape(v.shape[0], -1, *v.shape[-2:]) if k in cnn_keys else v for k, v in obs.items()}
            actions, _, _, _ = p(prepared, greedy=greedy, noise=noise, generator=generator)
            return actions

        return step

    return PolicyHandle(
        algo=str(cfg.algo.name),
        obs_spec=obs_spec,
        action_shape=(sum(actions_dim),) if is_continuous else (len(actions_dim),),
        params=agent,
        assemble=_dict_assembler(obs_spec),
        validate=_row_validator(obs_spec),
        device=torch.device(device),
        meta={"is_continuous": is_continuous, "actions_dim": list(actions_dim)},
        make_step=make_step,
        load_params=_params_loader(load_agent, device),
    )


SERVABLE_BUILDERS["ppo"] = SERVABLE_BUILDERS["a2c"] = _ppo_handle


def _sac_handle(cfg, obs_space, action_space, agent_state, device) -> PolicyHandle:
    """sac: the tanh-Gaussian actor served statelessly.  Greedy is the
    squashed mean, stochastic ``sample_and_log_prob`` on a standard-normal
    draw; the request rows' vector keys concatenate into the flat
    observation the actor reads (``algos/sac/utils.py::prepare_obs``)."""
    from sheeprl_tpu_torch.algos.sac.agent import build_agent

    def load_actor(state) -> torch.nn.Module:
        return build_agent(cfg, obs_space, action_space, state, device)[0].actor.eval()

    actor = load_actor(agent_state)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    obs_spec = {k: ((int(prod(obs_space[k].shape)),), "float32") for k in mlp_keys}
    act_dim = int(prod(action_space.shape))

    def make_step(greedy: bool) -> Callable:
        @torch.no_grad()
        def step(p, obs, generator, noise=None):
            """``noise``: the ``[B, A]`` standard-normal draw of a
            stochastic step (drawn from ``generator`` when None)."""
            flat = torch.cat([obs[k] for k in mlp_keys], dim=-1)
            if greedy:
                return p.greedy_action(flat)
            if noise is None:
                noise = torch.randn((flat.shape[0], act_dim), generator=generator, device=flat.device)
            return p.sample_and_log_prob(flat, noise)[0]

        return step

    def log_row(row: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        # the flat concat the actor read: the 'observations' key offline
        # sac/droq training reads
        return {"observations": np.concatenate([row[k] for k in mlp_keys], axis=-1)}

    return PolicyHandle(
        algo="sac",
        obs_spec=obs_spec,
        action_shape=tuple(int(d) for d in action_space.shape),
        params=actor,
        assemble=_dict_assembler(obs_spec),
        validate=_row_validator(obs_spec),
        device=torch.device(device),
        meta={"is_continuous": True},
        make_step=make_step,
        load_params=_params_loader(load_actor, device),
        log_row=log_row,
    )


SERVABLE_BUILDERS["sac"] = _sac_handle


def _ppo_recurrent_handle(cfg, obs_space, action_space, agent_state, device) -> PolicyHandle:
    """ppo_recurrent: the LSTM agent served statefully.  Per-session state
    is ``{hx, cx, prev_actions}``; the step masks all three by ``1 -
    is_first`` before the forward, as the training rollout resets them on
    done, advances one sequence step and rebuilds ``prev_actions`` (one-hot
    per categorical head, the raw actions when continuous) for the next
    request.  Rows carry the observation as the env gives it (float32,
    pixels 0-255)."""
    from sheeprl_tpu_torch.algos.ppo_recurrent.agent import build_agent, prev_actions_of
    from sheeprl_tpu_torch.parallel.precision import call_cast

    actions_dim, is_continuous, _ = _actions_dim(action_space)

    def load_agent(state) -> torch.nn.Module:
        return build_agent(actions_dim, is_continuous, cfg, obs_space, state, device).eval()

    agent = load_agent(agent_state)
    mlp_keys = list(cfg.algo.mlp_keys.encoder)
    cnn_keys = list(cfg.algo.cnn_keys.encoder)
    obs_spec: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for k in cnn_keys:
        obs_spec[k] = (tuple(obs_space[k].shape), "float32")
    for k in mlp_keys:
        obs_spec[k] = ((int(prod(obs_space[k].shape)),), "float32")
    hidden = int(cfg.algo.rnn.lstm.hidden_size)
    state_spec = {
        "hx": ((hidden,), "float32"),
        "cx": ((hidden,), "float32"),
        "prev_actions": ((int(sum(actions_dim)),), "float32"),
    }

    def make_state_step(greedy: bool) -> Callable:
        @torch.no_grad()
        def step(p, state, obs, is_first, generator, noise=None):
            """``noise``: the standard-normal ``[1, B, A]`` draw of a
            continuous head, or a list of Gumbel ``[1, B, d_i]`` per
            categorical head."""
            keep = 1.0 - is_first  # [B, 1]: a fresh episode zeroes the carry
            seq_obs = {k: v.reshape(v.shape[0], -1, *v.shape[-2:])[None] if k in cnn_keys else v[None]
                       for k, v in obs.items()}
            actions, _, _, _, (hx, cx) = call_cast((p,), torch.float32, lambda: p(
                seq_obs, (state["prev_actions"] * keep)[None], state["hx"] * keep, state["cx"] * keep,
                greedy=greedy, noise=noise, generator=generator))
            row = actions[0]
            return row, {"hx": hx, "cx": cx, "prev_actions": prev_actions_of(row, actions_dim, is_continuous)}

        return step

    return PolicyHandle(
        algo="ppo_recurrent",
        obs_spec=obs_spec,
        action_shape=(sum(actions_dim),) if is_continuous else (len(actions_dim),),
        params=agent,
        assemble=_dict_assembler(obs_spec),
        validate=_row_validator(obs_spec),
        device=torch.device(device),
        meta={"is_continuous": is_continuous, "actions_dim": list(actions_dim)},
        stateful=True,
        state_spec=state_spec,
        make_state_step=make_state_step,
        load_params=_params_loader(load_agent, device),
    )


SERVABLE_BUILDERS["ppo_recurrent"] = _ppo_recurrent_handle

#: checkpoint keys that make up a Dreamer-family agent state
DREAMER_STATE_KEYS = ("world_model", "actor", "critic", "target_critic")


def agent_state_from_checkpoint(state: Mapping[str, Any]) -> Dict[str, Any]:
    """The servable agent state inside a loaded checkpoint: ``state["agent"]``
    for the single-tree families, the per-module dict for the Dreamer family."""
    if "agent" in state:
        return state["agent"]
    if "world_model" in state:
        return {k: state[k] for k in DREAMER_STATE_KEYS if k in state}
    raise ValueError(
        f"checkpoint has no servable agent state (keys: {sorted(state)}); expected "
        f"'agent' or the Dreamer module keys {list(DREAMER_STATE_KEYS)}"
    )


def build_policy(
    cfg, obs_space, action_space, agent_state: Optional[Dict[str, Any]] = None, device: torch.device | str = "cpu"
) -> PolicyHandle:
    """Adapter dispatch: ``cfg.algo.name`` -> :class:`PolicyHandle` (weights
    from the seed when ``agent_state`` is None)."""
    algo = str(cfg.algo.name)
    builder = SERVABLE_BUILDERS.get(algo)
    if builder is None:
        raise ValueError(f"Algorithm {algo!r} has no servable adapter; registered builders: {sorted(SERVABLE_BUILDERS)}")
    return builder(cfg, obs_space, action_space, agent_state, device)


def load_policy(cfg, ckpt_path: str, device: torch.device | str = "cpu") -> PolicyHandle:
    """Checkpoint -> :class:`PolicyHandle`: read the state, rebuild the obs /
    action spaces from one throwaway env (the spaces are not archived
    anywhere else), then adapter-dispatch."""
    from sheeprl_tpu_torch.envs.env import make_env
    from sheeprl_tpu_torch.utils.checkpoint import load_state

    state = load_state(str(ckpt_path))
    try:
        agent_state = agent_state_from_checkpoint(state)
    except ValueError as err:
        raise ValueError(f"Checkpoint '{ckpt_path}': {err}") from None
    env = make_env(cfg, cfg.seed, 0, None, "serve")()
    try:
        obs_space = env.observation_space
        action_space = env.action_space
    finally:
        env.close()
    if not isinstance(obs_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation space (need a Dict): {obs_space}")
    handle = build_policy(cfg, obs_space, action_space, agent_state, device)
    handle.ckpt_path = str(ckpt_path)
    handle.ckpt_step = checkpoint_step(ckpt_path) or 0
    return handle
