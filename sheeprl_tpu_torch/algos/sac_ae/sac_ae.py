"""SAC-AE training (counterpart of ``sheeprl_tpu/algos/sac_ae/sac_ae.py``).

Each gradient step, as the JAX step orders it: the critic update, whose
optimizer runs over the pair ``(encoder, critic)``; every
``critic.per_rank_target_network_update_freq`` steps the Polyak averages of
the target critic (``algo.tau``) and the target encoder
(``encoder.tau``); every ``actor.per_rank_update_freq`` steps the actor and
the entropy coefficient on the encoder's features, detached; every
``decoder.per_rank_update_freq`` steps the autoencoder: the reconstruction
of the bit-reduced (5 bits) pixels with dequantization noise and of the
vector keys, plus an L2 penalty on the latent, the encoder's gradient to
its own optimizer and the decoder's to its ``adamw``.  The gates read the
cumulative gradient-step counter, a host int the checkpoint keeps as
``cumulative_counter``; a skipped actor or autoencoder update reports a
loss of 0, as the JAX step does.  Each loss's gradient is taken over
exactly its own parameters (``torch.autograd.grad``), so the encoder's two
optimizers never see each other's gradient.  The draws of a step, in the
JAX step's split order: the next action's normal noise, the actor's, the
pixels' uniform noise.  The JAX step computes no health stats and applies
no ``skip_update`` selection; ``run exp=sac_ae`` refuses the latter.  The
metric vector is the mean ``[qf, actor, alpha, reconstruction]`` over the
call's gradient steps, then the count of steps with a non-finite loss.
The loop is SAC's (``algos/sac/sac.py``), serialized as the JAX SAC-AE
loop is, with ``env.screen_size`` forced to 64.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from sheeprl_tpu_torch.algos.sac.loss import critic_loss, entropy_loss, policy_loss
from sheeprl_tpu_torch.algos.sac.sac import SACFamily, spec_tensors, apply_gradients, off_policy_main, polyak_
from sheeprl_tpu_torch.algos.sac_ae.agent import SACAEAgent, build_agent
from sheeprl_tpu_torch.algos.sac_ae.utils import prepare_obs, preprocess_obs, test
from sheeprl_tpu_torch.parallel.dp import local_sample_size, pmean_tree, run_one, run_shards, stage
from sheeprl_tpu_torch.parallel.precision import call_cast, compute_dtype_of
from sheeprl_tpu_torch.utils.registry import register_algorithm

METRIC_ORDER = ["Loss/value_loss", "Loss/policy_loss", "Loss/alpha_loss", "Loss/reconstruction_loss"]


def make_train_step(agent: SACAEAgent, optimizers: Dict[str, torch.optim.Optimizer], cfg, target_entropy: float):
    """Build the gradient steps: ``update(data, noise, counter) ->
    (metrics, counter)``.

    ``data`` holds the encoder's keys and their ``next_<key>`` (pixels raw
    in ``[0, 255]``, a frame stack folded into the channels), ``actions``,
    ``rewards`` and ``terminated``, ``[G, B, ...]`` tensors on the device;
    ``noise`` holds ``eps_next`` and ``eps_actor`` (``[G, B, A]`` standard
    normals) and ``pixels`` (per decoder pixel key, ``[G, B, C, H, W]``
    uniforms); ``counter`` is the cumulative gradient-step count before the
    call."""
    from sheeprl_tpu_torch.interop.flax_params import sac_ae_spec

    cdt = compute_dtype_of(cfg)
    gamma, tau, encoder_tau = float(cfg.algo.gamma), float(cfg.algo.tau), float(cfg.algo.encoder.tau)
    cnn_keys, mlp_keys = list(cfg.algo.cnn_keys.encoder), list(cfg.algo.mlp_keys.encoder)
    cnn_dec, mlp_dec = list(cfg.algo.cnn_keys.decoder), list(cfg.algo.mlp_keys.decoder)
    target_freq = int(cfg.algo.critic.per_rank_target_network_update_freq)
    actor_freq = int(cfg.algo.actor.per_rank_update_freq)
    decoder_freq = int(cfg.algo.decoder.per_rank_update_freq)
    l2_lambda = float(cfg.algo.decoder.l2_lambda)
    encoder, decoder, actor = agent.encoder, agent.decoder, agent.actor
    critic, target_critic, target_encoder = agent.critic, agent.target_critic, agent.target_encoder
    spec = sac_ae_spec(agent)
    params = {name: spec_tensors(spec[name]) for name in
              ("encoder", "decoder", "actor", "critic", "target_encoder", "target_critic")}
    n_enc = len(params["encoder"])
    zero = None

    def inputs(batch: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
        out = {k: (batch[prefix + k] / 255.0).to(cdt) for k in cnn_keys}
        out.update({k: batch[prefix + k].to(cdt) for k in mlp_keys})
        return out

    def one_step(batch, eps_next, eps_actor, pixel_noise, counter: int):
        """One gradient step on one shard's block (a generator: the gradients
        are reduced over the shards, as the JAX step pmeans them)."""
        nonlocal zero
        obs, next_obs = inputs(batch, ""), inputs(batch, "next_")
        with torch.no_grad():
            next_features = call_cast((target_encoder,), cdt, lambda: target_encoder(next_obs))
            next_actions, next_logprobs = call_cast(
                (actor, encoder), cdt, lambda: actor.sample_and_log_prob(encoder(next_obs), eps_next), buffers=False)
            next_q = call_cast((target_critic,), cdt, lambda: target_critic(next_features, next_actions)).float()
            next_qf_value = batch["rewards"] + (1 - batch["terminated"]) * gamma * (
                next_q.min(dim=-1, keepdim=True).values - agent.log_alpha.exp() * next_logprobs.float())
        qf_values = call_cast((encoder, critic), cdt,
                              lambda: critic(encoder(obs), batch["actions"].to(cdt))).float()
        qf_l = critic_loss(qf_values, next_qf_value)
        pair = params["encoder"] + params["critic"]
        grads = yield from pmean_tree(torch.autograd.grad(qf_l, pair))
        apply_gradients(optimizers["critic"], pair, grads)

        if counter % target_freq == 0:
            polyak_(params["target_critic"], params["critic"], tau)
            polyak_(params["target_encoder"], params["encoder"], encoder_tau)

        if zero is None:
            zero = torch.zeros((), device=qf_l.device)
        actor_l = alpha_l = rec_l = zero
        if counter % actor_freq == 0:
            with torch.no_grad():
                features = call_cast((encoder,), cdt, lambda: encoder(obs))
            actions, logprobs = call_cast((actor,), cdt, lambda: actor.sample_and_log_prob(features, eps_actor),
                                          buffers=False)
            q = call_cast((critic,), cdt, lambda: critic(features, actions)).float()
            actor_l = policy_loss(agent.log_alpha.detach().exp(), logprobs.float(), q.min(dim=-1, keepdim=True).values)
            grads = yield from pmean_tree(torch.autograd.grad(actor_l, params["actor"]))
            apply_gradients(optimizers["actor"], params["actor"], grads)
            alpha_l = entropy_loss(agent.log_alpha, logprobs, target_entropy)
            grads = yield from pmean_tree(torch.autograd.grad(alpha_l, [agent.log_alpha]))
            apply_gradients(optimizers["alpha"], [agent.log_alpha], grads)

        if counter % decoder_freq == 0:
            def reconstruction() -> torch.Tensor:
                hidden = encoder(obs)
                recon = decoder(hidden)
                hidden = hidden.float()
                loss = 0.0
                for k in cnn_dec + mlp_dec:
                    target = preprocess_obs(batch[k], pixel_noise[k], bits=5) if k in cnn_dec else batch[k]
                    loss = loss + ((target - recon[k].float()) ** 2).mean()
                    loss = loss + l2_lambda * (0.5 * (hidden**2).sum(dim=-1)).mean()
                return loss

            rec_l = call_cast((encoder, decoder), cdt, reconstruction)
            enc_dec = params["encoder"] + params["decoder"]
            grads = yield from pmean_tree(torch.autograd.grad(rec_l, enc_dec))
            apply_gradients(optimizers["encoder"], params["encoder"], grads[:n_enc])
            apply_gradients(optimizers["decoder"], params["decoder"], grads[n_enc:])
        return torch.stack([qf_l.float(), actor_l.float(), alpha_l.float(), rec_l.float()])

    def body(data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int):
        """The gradient steps on one shard's block (a generator whose
        collectives :func:`~sheeprl_tpu_torch.parallel.dp.run_shards`
        answers); the steps' losses are reduced over the shards, so every
        shard counts the same non-finite steps."""
        rows: List[torch.Tensor] = []
        for g in range(noise["eps_next"].shape[0]):
            row = yield from one_step({k: v[g] for k, v in data.items()}, noise["eps_next"][g], noise["eps_actor"][g],
                                      {k: v[g] for k, v in noise["pixels"].items()}, counter)
            rows.append(row.detach())
            counter += 1
        flat = yield from pmean_tree(torch.stack(rows))
        nonfinite = (~torch.isfinite(flat).all(dim=1)).float().sum()
        return torch.cat([flat.mean(dim=0), nonfinite[None]]), counter

    def update(data: Dict[str, torch.Tensor], noise: Dict[str, Any], counter: int):
        """One shard: the whole batch on this agent's device."""
        return run_one(body(data, noise, counter))

    update.body = body
    update.health_names = []
    return update


class SACAEFamily(SACFamily):
    """SAC-AE's parts of the off-policy loop: the agent and its five
    optimizers, the policy through the encoder, the replay record (each
    observation key as the env gives it; ``next_<key>`` sampled), the
    gradient steps with the cumulative counter, and the checkpoint's seven
    trees."""

    name = "SAC-AE"
    metric_order = METRIC_ORDER
    pipelined = False
    skip_update = False
    registers_models = False

    def __init__(self, cfg, obs_space, action_space, state, device):
        super().__init__(cfg, obs_space, action_space, state, device)
        self.cnn_keys = list(cfg.algo.cnn_keys.encoder)
        self.env_keys = self.cnn_keys + self.mlp_keys
        self.counter = int(state["cumulative_counter"]) if state and "cumulative_counter" in state else 0

    def build(self, cfg, obs_space, action_space, state, device):
        return build_agent(cfg, obs_space, action_space, state["agent"] if state else None, device)

    def make_optimizers(self) -> Dict[str, torch.optim.Optimizer]:
        from sheeprl_tpu_torch.config import instantiate

        a, algo = self.agent, self.cfg.algo
        return {"actor": instantiate(algo.actor.optimizer)(a.actor.parameters()),
                "critic": instantiate(algo.critic.optimizer)([*a.encoder.parameters(), *a.critic.parameters()]),
                "alpha": instantiate(algo.alpha.optimizer)([a.log_alpha]),
                "encoder": instantiate(algo.encoder.optimizer)(a.encoder.parameters()),
                "decoder": instantiate(algo.decoder.optimizer)(a.decoder.parameters())}

    def spec(self) -> Dict[str, Any]:
        from sheeprl_tpu_torch.interop.flax_params import sac_ae_spec

        return sac_ae_spec(self.agent)

    def opt_specs(self) -> Dict[str, Any]:
        spec = self.spec()
        return {"actor": spec["actor"], "critic": [spec["encoder"], spec["critic"]], "alpha": spec["log_alpha"],
                "encoder": spec["encoder"], "decoder": spec["decoder"]}

    def obs_keys(self) -> tuple:
        return tuple(self.cfg.algo.cnn_keys.encoder) + tuple(self.cfg.algo.mlp_keys.encoder)

    def sample_next_obs(self) -> bool:
        return True

    def make_update(self):
        self.update = make_train_step(self.agent, self.optimizers, self.cfg, self.target_entropy)
        self.health_names = []
        self.step = self.dp_step
        return self

    def dp_step(self, data: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """The gradient steps over the shards: shard d's on its block d of
        the batch with draws from its own random stream (shard 0's is
        ``generator``), as the JAX step folds its key per device; the
        cumulative counter advances once for all of them."""
        gradient_steps, rows = data["actions"].shape[:2]
        rows //= len(self.shards)
        shape = (gradient_steps, rows, self.act_dim)
        generators = [generator, *(self.generators or [])[1:]]
        bodies = []
        for shard, block, g in zip(self.shards, stage(data, [s.device for s in self.shards], batch_axis=1),
                                   generators):
            noise = {"eps_next": torch.randn(shape, generator=g, device=shard.device),
                     "eps_actor": torch.randn(shape, generator=g, device=shard.device),
                     "pixels": {k: torch.rand(block[k].shape, generator=g, device=shard.device)
                                for k in self.cfg.algo.cnn_keys.decoder}}
            bodies.append(shard.update.body(block, noise, self.counter))
        metrics, self.counter = run_shards(bodies)[0]
        return metrics

    @torch.no_grad()
    def act(self, obs: Dict[str, np.ndarray], num_envs: int, generator: torch.Generator) -> torch.Tensor:
        features = self.agent.encoder(prepare_obs(obs, self.stager, self.cnn_keys, self.mlp_keys, num_envs))
        eps = torch.randn((num_envs, self.act_dim), generator=generator, device=self.device)
        return self.agent.actor.sample_and_log_prob(features, eps)[0]

    def record(self, obs, real_next_obs, actions, num_envs: int) -> Dict[str, np.ndarray]:
        return {k: np.asarray(obs[k]) for k in self.env_keys}

    def train(self, rb, batch_size: int, gradient_steps: int, generator: torch.Generator, inject) -> torch.Tensor:
        """``gradient_steps`` steps on ``batch_size`` rows a shard, the
        global batch drawn at once."""
        sample = rb.sample(batch_size=local_sample_size(batch_size * len(self.shards)), n_samples=gradient_steps,
                           sample_next_obs=True)
        slab = {}
        for k, v in sample.items():
            if (k[len("next_"):] if k.startswith("next_") else k) in self.cnn_keys:
                # pixels stay uint8 for the copy, a frame stack folded into the channels
                slab[k] = v.reshape(*v.shape[:2], -1, *v.shape[-2:])
            elif k != "truncated":
                slab[k] = np.asarray(v, np.float32)
        staged = self.stager(slab)
        return self.step(inject({k: v.float() for k, v in staged.items()}), generator)

    def extra_state(self) -> Dict[str, Any]:
        return {"cumulative_counter": self.counter}

    def test(self, env, cfg) -> float:
        return test(self.agent, env, cfg, self.device, self.stager)


@register_algorithm()
def main(runtime, cfg) -> Dict[str, Any]:
    """The SAC-AE loop (``algos/sac/sac.py::off_policy_main`` with
    :class:`SACAEFamily`), at 64x64 pixels."""
    cfg.env.screen_size = 64
    return off_policy_main(runtime, cfg, SACAEFamily)
