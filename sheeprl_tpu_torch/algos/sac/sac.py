"""SAC training (counterpart of ``sheeprl_tpu/algos/sac/sac.py``): the
gradient step, and the off-policy loop SAC, DroQ and SAC-AE share.

Each gradient step, as the JAX ``make_train_step`` orders it: the critic
update against the soft target (the target critic at the next observation
and the actor's action there), the Polyak average of the target critic
(``algo.tau``), the actor update on the just-updated critic, then the
entropy coefficient on the actor's log-probs, held constant.  The next
action and the actor's action share one standard-normal draw, as the JAX
step's one key does.  With ``algo.offline.cql_alpha > 0`` the critic loss
adds the conservative Q penalty (``loss.py::conservative_q_penalty``) over
pre-drawn proposals; at 0 the step draws and launches nothing more.  The
metric vector ``[qf, actor, alpha, grad norm]`` is the mean over the call's
gradient steps and a fifth entry counts the non-finite ones.  Under ``diagnostics`` (the default) each step also
computes the train-health stats over the ``actor``/``critic``/``alpha``
trio, whose global gradient norm is the metric's, and with
``sentinel.policy=skip_update`` a non-finite step has its parameters and
optimizer state put back on the device.  The gradient steps run as a
Python loop with no host sync; the loop fetches their metrics once.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.agent import SACAgent, build_agent
from sheeprl_tpu_torch.algos.sac.loss import conservative_q_penalty, critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.utils import prepare_obs, test
from sheeprl_tpu_torch.diagnostics.health import health_names, health_spec, health_stats, unit_dim
from sheeprl_tpu_torch.diagnostics.sentinel import finite_flag, select_finite, sentinel_spec, skip_update_guard
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.optim import global_norm
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ["Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Grads/global_norm"]


def apply_gradients(optimizer: torch.optim.Optimizer, params: Sequence[torch.Tensor],
                    grads: Sequence[torch.Tensor]) -> None:
    """One ``optimizer`` step on ``grads``, taken of one loss over exactly
    ``params`` (``torch.autograd.grad``), then the gradients dropped: a
    parameter two optimizers hold (SAC-AE's encoder) sees only the
    gradient meant for the step that reads it."""
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    for p in params:
        p.grad = None


@torch.no_grad()
def polyak_(targets: Sequence[torch.Tensor], sources: Sequence[torch.Tensor], tau: float) -> None:
    """optax's ``incremental_update`` in place: ``t = tau * s + (1 - tau) * t``."""
    torch._foreach_mul_(list(targets), 1.0 - tau)
    torch._foreach_add_(list(targets), list(sources), alpha=tau)


def spec_leaves(spec: Mapping[str, Any]) -> List[Tuple[torch.Tensor, int]]:
    """``(tensor, unit axis)`` of every leaf of a converter spec, in the
    spec's order (``interop/flax_params.py``; the axis as the health stats
    count units)."""
    if isinstance(spec, tuple):
        return [(spec[0], unit_dim(spec[1], spec[0].dim()))]
    return [leaf for sub in spec.values() for leaf in spec_leaves(sub)]


def spec_tensors(spec: Mapping[str, Any]) -> List[torch.Tensor]:
    return [t for t, _ in spec_leaves(spec)]


def cql_spec(cfg, actor) -> Tuple[float, int]:
    """``(cql_alpha, cql_samples)`` of ``algo.offline``; an armed penalty
    needs finite action bounds for its uniform proposals (the JAX step's
    check, at build time)."""
    offline = cfg.algo.get("offline") or {}
    alpha = float(offline.get("cql_alpha", 0.0) or 0.0)
    samples = int(offline.get("cql_samples", 4) or 4)
    if alpha > 0 and not (np.isfinite(actor.action_low).all() and np.isfinite(actor.action_high).all()):
        raise ValueError(
            "algo.offline.cql_alpha > 0 needs finite action bounds for its uniform "
            "action proposals (set algo.offline.action_low/high)"
        )
    return alpha, samples


def draw_cql_noise(actor, gradient_steps: int, samples: int, batch_size: int, generator: torch.Generator,
                   device) -> Dict[str, torch.Tensor]:
    """The conservative penalty's draws for ``gradient_steps`` steps:
    ``uniform`` actions in the actor's bounds and the policy proposals'
    standard normals ``eps``, each ``[G, n, B, A]``."""
    low = torch.as_tensor(actor.action_low, device=device)
    high = torch.as_tensor(actor.action_high, device=device)
    shape = (gradient_steps, samples, batch_size, low.shape[0])
    uniform = low + (high - low) * torch.rand(shape, generator=generator, device=device)
    return {"uniform": uniform, "eps": torch.randn(shape, generator=generator, device=device)}


def make_train_step(agent: SACAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg,
                    target_entropy: float) -> Callable[..., torch.Tensor]:
    """Build the gradient steps: ``update(data, eps, cql=None) -> metrics``.

    ``data`` holds ``observations``, ``next_observations``, ``actions``,
    ``rewards`` and ``terminated``, ``[G, B, ...]`` tensors on the device;
    ``eps`` the ``[G, B, A]`` standard-normal draws, one a gradient step;
    ``cql`` (:func:`draw_cql_noise`) the conservative penalty's draws, read
    only when ``update.cql_samples`` is nonzero (``cql_alpha > 0``).
    The agent and the optimizers (``actor``, ``critic``, ``alpha``) update
    in place.  ``metrics`` is one float32 vector: the four
    ``METRIC_ORDER`` means, the non-finite step count, then the health
    stats (``update.health_names``) averaged over the steps."""
    from sheeprl_tpu_torch.interop.flax_params import sac_spec

    sentinel, health = sentinel_spec(cfg), health_spec(cfg)
    cdt = compute_dtype_of(cfg)
    gamma, tau = float(cfg.algo.gamma), float(cfg.algo.tau)
    actor, critic, target = agent.actor, agent.critic, agent.target_critic
    cql_alpha, cql_samples = cql_spec(cfg, actor)
    spec = sac_spec(agent)
    groups = {"actor": spec_tensors(spec["actor"]), "critic": spec_tensors(spec["critic"]),
              "alpha": [agent.log_alpha]}
    target_params = spec_tensors(spec["target_critic"])
    if health.enabled:
        names = list(groups)
        health_out = health_names(names, health.per_module)
        unit_dims = {name: [d for _, d in spec_leaves(spec[key])]
                     for name, key in (("actor", "actor"), ("critic", "critic"), ("alpha", "log_alpha"))}
        before = {n: [torch.empty_like(p) for p in groups[n]] for n in names}
    else:
        health_out = []
    if sentinel.skip_update:
        guarded, snapshot = skip_update_guard([agent], optimizers.values())

    def one_step(batch: Dict[str, torch.Tensor], eps: torch.Tensor, cql: Optional[Dict[str, torch.Tensor]]):
        if sentinel.skip_update:
            with torch.no_grad():
                torch._foreach_copy_(snapshot, guarded)
        if health.enabled:
            with torch.no_grad():
                for n in names:
                    torch._foreach_copy_(before[n], groups[n])
        # network inputs in the compute dtype; the TD target stays fp32
        obs_c, next_obs_c = batch["observations"].to(cdt), batch["next_observations"].to(cdt)
        with torch.no_grad():
            next_actions, next_logprobs = call_cast((actor,), cdt, lambda: actor.sample_and_log_prob(next_obs_c, eps),
                                                    buffers=False)
            next_q = call_cast((target,), cdt, lambda: target(next_obs_c, next_actions)).float()
            alpha = agent.log_alpha.exp()
            next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * gamma * (
                next_q.min(dim=-1, keepdim=True).values - alpha * next_logprobs.float())
        qf_values = call_cast((critic,), cdt, lambda: critic(obs_c, batch["actions"].to(cdt))).float()
        qf_l = critic_loss(qf_values, next_qf_value)
        if cql_alpha > 0:
            qf_l = qf_l + cql_alpha * conservative_q_penalty(
                obs_c, qf_values,
                lambda o, e: call_cast((actor,), cdt, lambda: actor.sample_and_log_prob(o, e), buffers=False),
                lambda o, a: call_cast((critic,), cdt, lambda: critic(o, a)),
                cql["uniform"], cql["eps"])
        qf_grads = torch.autograd.grad(qf_l, groups["critic"])
        apply_gradients(optimizers["critic"], groups["critic"], qf_grads)
        polyak_(target_params, groups["critic"], tau)

        actions, logprobs = call_cast((actor,), cdt, lambda: actor.sample_and_log_prob(obs_c, eps), buffers=False)
        q = call_cast((critic,), cdt, lambda: critic(obs_c, actions)).float()
        actor_l = policy_loss(agent.log_alpha.detach().exp(), logprobs.float(), q.min(dim=-1, keepdim=True).values)
        actor_grads = torch.autograd.grad(actor_l, groups["actor"])
        apply_gradients(optimizers["actor"], groups["actor"], actor_grads)

        alpha_l = entropy_loss(agent.log_alpha, logprobs, target_entropy)
        alpha_grads = torch.autograd.grad(alpha_l, groups["alpha"])
        apply_gradients(optimizers["alpha"], groups["alpha"], alpha_grads)

        grads = {"actor": actor_grads, "critic": qf_grads, "alpha": alpha_grads}
        hrow = None
        if health.enabled:
            with torch.no_grad():
                updates = {n: torch._foreach_sub(groups[n], before[n]) for n in names}
                # the parameters after the update, as the JAX step's
                stats = health_stats(grads, updates, groups, unit_dims=unit_dims, per_module=health.per_module,
                                     dead_eps=health.dead_eps)
            gnorm = stats["grad_norm"]
            hrow = torch.stack([stats[k] for k in health_out]).float()
        else:
            gnorm = torch.sqrt(sum(global_norm(g) ** 2 for g in grads.values()))
        finite = finite_flag(gnorm, qf_l, actor_l, alpha_l)
        if sentinel.skip_update:
            select_finite(finite, guarded, snapshot)
        row = torch.stack([qf_l.float(), actor_l.float(), alpha_l.float(), gnorm, 1.0 - finite.float()]).detach()
        return row, hrow

    def update(data: Dict[str, torch.Tensor], eps: torch.Tensor,
               cql: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        rows, hrows = [], []
        for g in range(eps.shape[0]):
            row, hrow = one_step({k: v[g] for k, v in data.items()}, eps[g],
                                 {k: v[g] for k, v in cql.items()} if cql_alpha > 0 else None)
            rows.append(row)
            if hrow is not None:
                hrows.append(hrow)
        flat = torch.stack(rows)
        metrics = [flat[:, :4].mean(dim=0), flat[:, 4:].sum(dim=0)]
        if hrows:
            metrics.append(torch.stack(hrows).mean(dim=0))
        return torch.cat(metrics)

    update.health_names = health_out
    update.cql_samples = cql_samples if cql_alpha > 0 else 0
    return update


def unported_options(cfg, name: str, skip_update: bool = True) -> List[str]:
    """The options an off-policy loop reads and does not act on; with
    ``skip_update=False`` also ``diagnostics.sentinel.policy=skip_update``
    (the JAX DroQ and SAC-AE steps apply no selection).  An offline run
    never reaches the loop (``cli.run_algorithm`` routes it to
    ``offline/train.py``)."""
    out = []
    if not cfg.model_manager.get("disabled", True):
        out.append("model_manager.disabled=False (model registry)")
    if cfg.metric.get("profiler", {}).get("enabled", False):
        out.append("metric.profiler.enabled=True")
    if not skip_update and sentinel_spec(cfg).skip_update:
        out.append(f"diagnostics.sentinel.policy=skip_update for {name} (its JAX step applies no selection)")
    return out


class SACFamily:
    """SAC's parts of the off-policy loop (:func:`off_policy_main`): the
    agent and its three Adam optimizers, the policy, the replay record (the
    flat concatenation of the vector keys; ``next_observations`` stored
    unless ``buffer.sample_next_obs``), the gradient steps and the
    checkpoint's trees."""

    name = "SAC"
    metric_order = METRIC_ORDER
    pipelined = True
    skip_update = True

    def __init__(self, cfg, obs_space, action_space, state, device):
        from sheeprl_tpu_torch.interop.flax_params import optimizer_state_dict

        self.cfg, self.device = cfg, device
        self.mlp_keys = list(cfg.algo.mlp_keys.encoder)
        self.env_keys = self.mlp_keys  # the observation keys a transition records
        self.agent, self.target_entropy = self.build(cfg, obs_space, action_space, state, device)
        self.cast_params()
        self.optimizers = self.make_optimizers()
        if state and "opt_states" in state:
            for name, optimizer in self.optimizers.items():
                optimizer.load_state_dict(optimizer_state_dict(state["opt_states"][name], optimizer,
                                                               self.opt_specs()[name]))
        self.act_dim = int(np.prod(action_space.shape))
        self.stager = None

    def build(self, cfg, obs_space, action_space, state, device):
        if cfg.algo.cnn_keys.encoder:
            import warnings

            warnings.warn("SAC only uses vector observations; CNN keys are ignored")
        return build_agent(cfg, obs_space, action_space, state["agent"] if state else None, device)

    def cast_params(self) -> None:
        from sheeprl_tpu_torch.parallel.precision import resolve_precision

        param_dtype = resolve_precision(self.cfg.fabric.get("precision", "32-true"))[0]
        if param_dtype != torch.float32:
            # bf16-true: the weights themselves in bf16 (the action-space
            # rescale stays fp32, a constant of the JAX module)
            for p in self.agent.parameters():
                p.data = p.data.to(param_dtype)

    def make_optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        from sheeprl_tpu_torch.config import instantiate

        a = self.agent
        return {"actor": instantiate(self.cfg.algo.actor.optimizer)(a.actor.parameters()),
                "critic": instantiate(self.cfg.algo.critic.optimizer)(a.critic.parameters()),
                "alpha": instantiate(self.cfg.algo.alpha.optimizer)([a.log_alpha])}

    def spec(self) -> Dict[str, Any]:
        """The agent's trees (``interop/flax_params.py``)."""
        from sheeprl_tpu_torch.interop.flax_params import sac_spec

        return sac_spec(self.agent)

    def opt_specs(self) -> Dict[str, Any]:
        spec = self.spec()
        return {"actor": spec["actor"], "critic": spec["critic"], "alpha": spec["log_alpha"]}

    def obs_keys(self) -> tuple:
        return ("observations",)

    def sample_next_obs(self) -> bool:
        return bool(self.cfg.buffer.sample_next_obs)

    def make_update(self):
        self.update = make_train_step(self.agent, self.optimizers, self.cfg, self.target_entropy)
        self.health_names = self.update.health_names
        self.cql_samples = self.update.cql_samples
        return self

    def cql_noise(self, gradient_steps: int, batch_size: int, generator: torch.Generator):
        """The conservative penalty's draws, after the step's own; None when
        it is off."""
        if not self.cql_samples:
            return None
        return draw_cql_noise(self.agent.actor, gradient_steps, self.cql_samples, batch_size, generator,
                              self.device)

    @torch.no_grad()
    def act(self, obs: Dict[str, np.ndarray], num_envs: int, generator: torch.Generator) -> torch.Tensor:
        flat = prepare_obs(obs, self.stager, self.mlp_keys, num_envs)
        eps = torch.randn((num_envs, self.act_dim), generator=generator, device=self.device)
        return self.agent.actor.sample_and_log_prob(flat, eps)[0]

    def record(self, obs, real_next_obs, actions, num_envs: int) -> Dict[str, np.ndarray]:
        def flat(o):
            return np.concatenate([np.asarray(o[k], np.float32).reshape(num_envs, -1) for k in self.mlp_keys], -1)

        out = {"observations": flat(obs)}
        if not self.sample_next_obs():
            out["next_observations"] = flat(real_next_obs)
        return out

    def train(self, rb, batch_size: int, gradient_steps: int, generator: torch.Generator, inject) -> torch.Tensor:
        sample = rb.sample(batch_size=batch_size, n_samples=gradient_steps, sample_next_obs=self.sample_next_obs())
        data = self.stager({k: np.asarray(sample[k], np.float32) for k in
                            ("observations", "next_observations", "actions", "rewards", "terminated")})
        data = inject(data)
        eps = torch.randn((gradient_steps, batch_size, self.act_dim), generator=generator, device=self.device)
        return self.update(data, eps, self.cql_noise(gradient_steps, batch_size, generator))

    def trees(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import dump_trees

        return dump_trees(self.spec())

    def opt_states(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import optax_state

        # optax's bare adam / adamw: the chain's own state, not wrapped
        return {name: optax_state(opt, self.opt_specs()[name], clip=False)[0]
                for name, opt in self.optimizers.items()}

    def extra_state(self) -> Dict[str, Any]:
        return {}

    def modules(self) -> List[torch.nn.Module]:
        return [self.agent]

    def test(self, env, cfg) -> float:
        return test(self.agent.actor, env, cfg, self.device, self.stager)


def off_policy_main(runtime, cfg, family_cls) -> Dict[str, Any]:
    """The loop of the off-policy family (SAC, DroQ, SAC-AE), as the JAX
    loops run it: per iteration one policy step of every env (uniform
    random actions until ``algo.learning_starts``), the transition into the
    replay buffer with a finished episode's real last observation, the
    gradient steps ``Ratio`` owes at ``algo.replay_ratio``, logging and
    checkpoints; one greedy test episode at the end with ``algo.run_test``.
    With ``family_cls.pipelined`` (SAC) the gradient steps run while the
    envs step, on the transitions through the previous step, and after the
    write when the buffer was still empty.  ``checkpoint.resume_from`` (a
    file, resolved by ``cli.run``) restores the agent, the optimizers (either
    package's state), the counters, the Ratio and the replay buffer.
    Returns what the run did."""
    from sheeprl_tpu_torch.config import instantiate
    from sheeprl_tpu_torch.data.buffers import ReplayBuffer
    from sheeprl_tpu_torch.data.slab import step_slab
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.envs.env import make_env, make_env_fns, pipelined_vector_env
    from sheeprl_tpu_torch.envs.player import ObsStager, fetch_values
    from sheeprl_tpu_torch.utils.logger import get_log_dir, get_logger
    from sheeprl_tpu_torch.utils.timer import timer
    from sheeprl_tpu_torch.utils.utils import Ratio, get_diagnostics, save_configs

    unported = unported_options(cfg, family_cls.name, family_cls.skip_update)
    if unported:
        raise NotImplementedError(f"not ported yet (see ROADMAP.md Queue 1): {'; '.join(unported)}")
    device = runtime.device
    num_envs = int(cfg.env.num_envs)

    generator = runtime.seed_everything(cfg.seed)
    logger = get_logger(runtime, cfg)
    log_dir = get_log_dir(runtime, cfg.root_dir, cfg.run_name)
    save_configs(cfg, log_dir)
    logger.log_hyperparams(cfg.as_dict())
    diag = get_diagnostics(runtime, cfg, log_dir)
    aggregator = instantiate(cfg.metric.aggregator)
    if cfg.metric.log_level == 0:
        aggregator.disabled = True
    timer.disabled = cfg.metric.log_level == 0 or bool(cfg.metric.get("disable_timer", False))
    timer.reset()

    envs = pipelined_vector_env(cfg, make_env_fns(cfg, log_dir, "train"))
    observation_space, action_space = envs.single_observation_space, envs.single_action_space
    if not isinstance(observation_space, spaces.Dict):
        raise RuntimeError(f"Unexpected observation type, should be of type Dict, got: {observation_space}")
    if not isinstance(action_space, spaces.Box):
        raise ValueError(f"{family_cls.name} supports only continuous (Box) action spaces")

    resume_from = cfg.checkpoint.get("resume_from")
    state = runtime.load(resume_from) if resume_from else None
    family = family_cls(cfg, observation_space, action_space, state, device).make_update()
    family.stager = ObsStager(device)
    family.update = diag.instrument("train_step", family.update, kind="train")
    family.act = diag.instrument("policy_step", family.act, kind="rollout")
    metric_order, health_out = family.metric_order, family.health_names
    n_losses = len(metric_order)
    diag.register_footprint("params", family.modules())
    diag.register_footprint("opt_state", list(family.optimizers.values()))

    rb = ReplayBuffer(cfg.buffer.size, num_envs, memmap=cfg.buffer.memmap,
                      memmap_dir=os.path.join(log_dir, "memmap_buffer"), obs_keys=family.obs_keys())
    rb.seed(cfg.seed)
    diag.track_buffer("replay", rb)
    if state and state.get("rb") is not None:
        rb.load_state_dict(state["rb"])

    start_iter = (state["iter_num"] if state else 0) + 1
    policy_step_count = state["policy_step"] if state else 0
    last_log = state["last_log"] if state else 0
    last_checkpoint = state["last_checkpoint"] if state else 0
    total_iters = int(cfg.algo.total_steps // num_envs) if not cfg.dry_run else 1
    learning_starts = int(cfg.algo.learning_starts // num_envs) if not cfg.dry_run else 0
    prefill_steps = learning_starts - int(learning_starts > 0)
    if resume_from:
        learning_starts += start_iter
        prefill_steps += start_iter
    ratio = Ratio(cfg.algo.replay_ratio, pretrain_steps=cfg.algo.per_rank_pretrain_steps)
    if state and "ratio" in state:
        ratio.load_state_dict(state["ratio"])
    batch_size = int(cfg.algo.per_rank_batch_size)
    action_rng = np.random.default_rng(cfg.seed)
    obs = envs.reset(seed=cfg.seed)[0]

    metric_rows: List[np.ndarray] = []
    logged: List[Dict[str, float]] = []
    checkpoints: List[str] = []
    gradient_steps_done = 0

    def run_train(iter_num: int, gradient_steps: int) -> None:
        """This iteration's gradient steps and the one fetch of their
        metrics."""
        nonlocal gradient_steps_done
        with timer("Time/train_time", device), diag.span("train"):
            metrics = family.train(rb, batch_size, gradient_steps, generator,
                                   lambda data: diag.maybe_inject_nan(iter_num, data))
            (row,) = fetch_values(metrics)
        gradient_steps_done += gradient_steps
        metric_rows.append(row)
        losses = dict(zip(metric_order, row[:n_losses].tolist()))
        if health_out:
            diag.on_health(policy_step_count, dict(zip(health_out, row[n_losses + 1:].tolist())))
        for name, value in losses.items():
            aggregator.update(name, value)
        diag.on_update(policy_step_count, losses, nonfinite=float(row[n_losses]))

    iterations = 0
    for iter_num in range(start_iter, total_iters + 1):
        iterations += 1
        policy_step_count += num_envs
        diag.note_env_steps(num_envs)
        with timer("Time/env_interaction_time"), diag.span("rollout"):
            if iter_num <= learning_starts:
                actions = envs.sample_actions(action_rng).astype(np.float32)
            else:
                (actions,) = fetch_values(family.act(obs, num_envs, generator))
            with diag.span("env_step_async"):
                envs.step_async(actions.reshape(envs.batched_action_shape))

        gradient_steps, trained = 0, False
        if iter_num >= learning_starts:
            gradient_steps = ratio(policy_step_count - prefill_steps * num_envs)
            if cfg.dry_run:
                gradient_steps = 1
            if family.pipelined and gradient_steps > 0 and not rb.empty:
                run_train(iter_num, gradient_steps)
                trained = True

        with timer("Time/env_interaction_time"), diag.span("env_wait"):
            next_obs, rewards, terminated, truncated, info = envs.step_wait()
        rewards = np.asarray(rewards, dtype=np.float32).reshape(num_envs, -1)
        if "final_info" in info and "episode" in info["final_info"]:
            ep = info["final_info"]["episode"]
            mask = ep.get("_r", info["final_info"].get("_episode"))
            if mask is not None and np.any(mask):
                for r, length in zip(ep["r"][mask], ep["l"][mask]):
                    aggregator.update("Rewards/rew_avg", float(r))
                    aggregator.update("Game/ep_len_avg", float(length))
        # a finished episode's real last observation, not the reset's
        real_next_obs = {k: np.asarray(next_obs[k]).copy() for k in family.env_keys}
        if "final_obs" in info:
            for idx, final_obs in enumerate(info["final_obs"]):
                if final_obs is not None:
                    for k in family.env_keys:
                        real_next_obs[k][idx] = np.asarray(final_obs[k])
        step = {**family.record(obs, real_next_obs, actions, num_envs), "actions": actions.reshape(num_envs, -1),
                "rewards": rewards, "terminated": terminated, "truncated": truncated}
        rb.add(step_slab(num_envs, step, dtypes={"terminated": np.float32, "truncated": np.float32}),
               validate_args=cfg.buffer.validate_args)
        obs = next_obs
        if gradient_steps > 0 and not trained:
            run_train(iter_num, gradient_steps)

        if policy_step_count - last_log >= cfg.metric.log_every or iter_num == total_iters or cfg.dry_run:
            metrics_dict = aggregator.compute()
            timers = timer.compute()
            if timers.get("Time/env_interaction_time", 0) > 0:
                metrics_dict["Time/sps_env_interaction"] = (
                    (policy_step_count - last_log) / timers["Time/env_interaction_time"])
            logger.log_metrics(metrics_dict, policy_step_count)
            logged.append(dict(metrics_dict))
            aggregator.reset()
            timer.reset()
            last_log = policy_step_count

        # a pending preemption (a signal, or the drill) forces the branch:
        # this save is the emergency snapshot
        preempt_now = diag.preempt_due(iter_num)
        if (
            (cfg.checkpoint.every > 0 and policy_step_count - last_checkpoint >= cfg.checkpoint.every)
            or cfg.dry_run
            or preempt_now
            or (iter_num == total_iters and cfg.checkpoint.save_last)
        ):
            last_checkpoint = policy_step_count
            ckpt_state = {
                "agent": family.trees(),
                # optax's layout, so that the JAX package resumes it too
                "opt_states": family.opt_states(),
                "ratio": ratio.state_dict(),
                **family.extra_state(),
                "iter_num": iter_num,
                "policy_step": policy_step_count,
                "last_log": last_log,
                "last_checkpoint": last_checkpoint,
                "batch_size": batch_size,
            }
            ckpt_path = os.path.join(log_dir, "checkpoint", f"ckpt_{policy_step_count}_0.ckpt")
            with diag.span("checkpoint"):
                runtime.call("on_checkpoint_coupled", ckpt_path=ckpt_path, state=ckpt_state,
                             replay_buffer=rb if cfg.buffer.checkpoint else None)
            diag.on_checkpoint(policy_step_count, ckpt_path)
            checkpoints.append(ckpt_path)
            if preempt_now:
                envs.close()
                diag.on_preempted(policy_step_count, iter_num, ckpt_path)

    envs.close()
    test_reward = None
    if cfg.algo.run_test:
        test_reward = family.test(make_env(cfg, cfg.seed, 0, log_dir, "test")(), cfg)
        logger.log_metrics({"Test/cumulative_reward": test_reward}, policy_step_count)
    logger.finalize()
    diag.close("completed")
    width = n_losses + 1 + len(health_out)
    rows = np.asarray(metric_rows, np.float32).reshape(-1, width) if metric_rows else np.zeros((0, width), np.float32)
    return {
        "start_iter": start_iter,
        "policy_steps": policy_step_count,
        "iterations": iterations,
        "gradient_steps": gradient_steps_done,
        "test_reward": test_reward,
        "metric_rows": rows[:, :n_losses],
        "nonfinite_updates": rows[:, n_losses],
        "health_rows": {name: rows[:, n_losses + 1 + i] for i, name in enumerate(health_out)},
        "logged": logged,
        "checkpoints": checkpoints,
        "log_dir": log_dir,
        "family": family,
    }


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The SAC loop (:func:`off_policy_main` with :class:`SACFamily`)."""
    return off_policy_main(runtime, cfg, SACFamily)
