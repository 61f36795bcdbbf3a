"""Resume and evaluation on the CPU at a tiny width: a JAX-written training
checkpoint (params, optax Adam state, Moments) resumed by the port and
stepped against the JAX step; a port run resuming its own checkpoint from
its run directory with every counter and state restored as saved; the
choice of checkpoint in a directory; ``keep_last`` sparing the resumed
checkpoint; ``eval`` on a JAX-written and a port-written checkpoint."""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from sheeprl_tpu.algos.dreamer_v3 import utils as jax_dv3_utils
from sheeprl_tpu.algos.dreamer_v3.dreamer_v3 import make_train_step as jax_make_train_step
from sheeprl_tpu.config import instantiate as jax_instantiate
from sheeprl_tpu.resilience.manifest import resolve_resume_from as jax_resolve_resume_from
from sheeprl_tpu.utils.checkpoint import save_state as jax_save_state
from sheeprl_tpu.utils.utils import Ratio as JaxRatio
from sheeprl_tpu.utils.utils import save_configs as jax_save_configs
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.algos.dreamer_v3 import dreamer_v3 as dv3
from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import METRIC_ORDER, make_optimizers, make_train_step
from sheeprl_tpu_torch.data.buffers import EnvIndependentReplayBuffer
from sheeprl_tpu_torch.data.device_buffer import DeviceSequentialReplayBuffer
from sheeprl_tpu_torch.interop.flax_params import optax_state, param_spec, to_flax
from sheeprl_tpu_torch.resilience.manifest import (
    checkpoint_step,
    list_checkpoints,
    manifest_path,
    resolve_resume_from,
    verify_checkpoint,
)
from sheeprl_tpu_torch.utils import checkpoint as ckpt_mod
from sheeprl_tpu_torch.utils.checkpoint import CheckpointCallback, OptaxState, load_state, save_state
from sheeprl_tpu_torch.utils.utils import Ratio
from test_torch_dv3_train import OBS_SPACE, RUN, _adam_moments, _batch, _jax_noise, _leaves, _record_margins, _Setup
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

# the resume run: 20 iterations of 2 envs, learning from iteration 4 at half
# a gradient step a policy step, one checkpoint at policy step 24 (iteration
# 12) and none at the end, so the run directory's newest checkpoint is
# mid-run; resumed, the run waits 4 more iterations (as the JAX package
# does) and trains on 17..20
RESUME_RUN = [o for o in RUN if not o.startswith(("algo.total_steps", "checkpoint.every"))] + [
    "algo.total_steps=40", "checkpoint.every=24", "checkpoint.save_last=False", "buffer.checkpoint=True",
    "algo.replay_ratio=0.5",
]


@pytest.fixture(scope="module")
def disc():
    return _Setup("multidiscrete_dummy", (2, 2), False)


def test_a_jax_checkpoint_resumes_here_and_its_next_step_matches_jax(disc, tmp_path, monkeypatch):
    """One JAX step, its params, optax state and Moments into a checkpoint
    written by the JAX package; the port restores it as ``run`` does
    (``load_learner_state``: optax ``mu``/``nu``/``count`` -> Adam's
    ``exp_avg``/``exp_avg_sq``/``step``) and takes the second step, held to
    the two-step test's tolerances."""
    cfg, jax_cfg = disc.cfg, disc.jax_cfg
    opts = {k: optax.chain(optax.clip_by_global_norm(jax_cfg.algo[k].clip_gradients),
                           jax_instantiate(jax_cfg.algo[k].optimizer)) for k in ("world_model", "actor", "critic")}
    params = jax.tree_util.tree_map(jnp.asarray, disc.params)
    opt_states = {k: opts[k].init(params[k]) for k in opts}
    jax_step = jax_make_train_step(disc.wm_def, disc.actor_def, disc.critic_def, opts, jax_cfg, disc.actions_dim, False)
    moments = jax_dv3_utils.init_moments_state()
    batch = {k: v.astype(np.float32) for k, v in _batch(disc, 13).items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    k1, k2 = jax.random.split(jax.random.PRNGKey(21))
    params, opt_states, moments, _ = jax_step(params, opt_states, moments, jbatch, k1, jnp.float32(1.0))[:4]
    path = tmp_path / "ckpt_8_0.ckpt"
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jax_save_state(str(path), {**{k: np_tree(v) for k, v in params.items()}, "opt_states": np_tree(opt_states),
                               "moments": np_tree(moments), "iter_num": 4, "last_log": 8, "last_checkpoint": 8})

    state = load_state(str(path))
    agent = build_agent(disc.actions_dim, False, cfg, OBS_SPACE,
                        {k: state[k] for k in ("world_model", "actor", "critic", "target_critic")}, "cpu")
    optimizers = make_optimizers(cfg, agent)
    moments_state = dv3.load_learner_state(state, agent, optimizers, "cpu")
    for name, opt in optimizers.items():
        steps = {float(s["step"]) for s in opt.state.values()}
        assert steps == {1.0} and len(opt.state) == len(list(getattr(agent, name).parameters()))
    step = make_train_step(agent, optimizers, cfg, False)
    _record_margins(monkeypatch)

    params, opt_states, moments, jax_metrics = jax_step(params, opt_states, moments, jbatch, k2, jnp.float32(0.02))[:4]
    moments_state, metrics = step(moments_state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.02, None,
                                  _jax_noise(disc, k2))
    np.testing.assert_allclose(metrics.numpy(), np.asarray(jax_metrics), atol=1e-4, rtol=1e-4, err_msg=str(METRIC_ORDER))
    want = _leaves({k: params[k] for k in ("world_model", "actor", "critic", "target_critic")})
    got = _leaves(to_flax(*agent))
    for p, value in want.items():
        np.testing.assert_allclose(got[p], value, atol=2e-6, rtol=1e-5, err_msg=p)
    moments_got = _adam_moments(agent, optimizers)
    for name in ("world_model", "actor", "critic"):
        adam_state = opt_states[name][1][0]
        for slot, tree in (("exp_avg", adam_state.mu), ("exp_avg_sq", adam_state.nu)):
            w, g = _leaves(tree), _leaves(moments_got[name][slot])
            scale = max(float(np.abs(v).max()) for v in w.values())
            for p in w:
                np.testing.assert_allclose(g[p], w[p], atol=1e-4 * scale, rtol=1e-3, err_msg=f"{name}{p}")
    np.testing.assert_allclose(moments_state["low"].numpy(), np.asarray(moments["low"]), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(moments_state["high"].numpy(), np.asarray(moments["high"]), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("device_ring", [False, True])
def test_a_port_run_resumes_its_own_checkpoint_from_the_run_directory(tmp_path, monkeypatch, device_ring):
    monkeypatch.chdir(tmp_path)
    extra = ["buffer.device=True", "algo.rssm_chunks=2"] if device_ring else []
    first = cli.run(RESUME_RUN + extra)
    (ckpt,) = first["checkpoints"]
    assert checkpoint_step(ckpt) == 24 and first["gradient_steps"] > 0
    saved = load_state(ckpt)

    restored = {}
    load_learner_state, ring_load = dv3.load_learner_state, (DeviceSequentialReplayBuffer if device_ring
                                                             else EnvIndependentReplayBuffer).load_state_dict
    ratio_load = Ratio.load_state_dict

    def spy_learner(state, agent, optimizers, device):
        moments = load_learner_state(state, agent, optimizers, device)
        spec = param_spec(*agent)
        restored["adam"] = {n: optax_state(o, spec[n]) for n, o in optimizers.items()}
        restored["moments"] = {k: float(v) for k, v in moments.items()}
        return moments

    def spy_ring(self, state):
        out = ring_load(self, state)
        restored["rb"] = self.state_dict()
        return out

    def spy_ratio(self, state):
        out = ratio_load(self, state)
        restored["ratio"] = self.state_dict()
        return out

    monkeypatch.setattr(dv3, "load_learner_state", spy_learner)
    monkeypatch.setattr(DeviceSequentialReplayBuffer if device_ring else EnvIndependentReplayBuffer,
                        "load_state_dict", spy_ring)
    monkeypatch.setattr(Ratio, "load_state_dict", spy_ratio)
    run_dir = str(Path(ckpt).parent.parent)
    second = cli.run(RESUME_RUN + extra + [f"checkpoint.resume_from={run_dir}", "checkpoint.save_last=True"])

    assert second["start_iter"] == saved["iter_num"] + 1 == 13
    assert second["policy_steps"] == 40 and second["player_steps"] == 20 - 12
    assert second["gradient_steps"] > 0 and np.isfinite(second["metric_rows"]).all()
    assert restored["ratio"] == saved["ratio"]
    assert restored["moments"] == {k: float(v) for k, v in saved["moments"].items()}
    # the port writes optax's layout: count, mu and nu come back bit for bit
    for name, entry in saved["opt_states"].items():
        want, got = _optax_leaves(entry), _optax_leaves(restored["adam"][name])
        assert list(got) == list(want) and len(want) > 3
        for path, value in want.items():
            np.testing.assert_array_equal(got[path], value, err_msg=f"{name}{path}")
    rb = restored["rb"]
    if device_ring:
        for k in ("pos", "filled"):
            np.testing.assert_array_equal(rb[k], saved["rb"][k])
        assert {"rssm_recurrent", "rssm_posterior", "rssm_valid"} <= set(rb["buffer"])
        pairs = [(rb["buffer"], saved["rb"]["buffer"])]
    else:
        pairs = [(a["buffer"], b["buffer"]) for a, b in zip(rb["buffers"], saved["rb"]["buffers"])]
    for got, want in pairs:
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the resumed run went on training: its final weights moved off the saved ones
    final = load_state(second["checkpoints"][-1])
    assert any(not np.array_equal(a, b) for a, b in zip(_leaves(final["world_model"]).values(),
                                                        _leaves(saved["world_model"]).values()))


def _optax_leaves(node, path=""):
    """``{path: array}`` of an optax state as the port writes it
    (``OptaxState``) or reads it back (``ForeignObject``)."""
    if isinstance(node, OptaxState):
        node = node.fields
    if isinstance(node, dict):
        return {p: v for k, sub in node.items() for p, v in _optax_leaves(sub, f"{path}/{k}").items()}
    if isinstance(node, tuple):
        return {p: v for i, sub in enumerate(node) for p, v in _optax_leaves(sub, f"{path}[{i}]").items()}
    return {path: np.asarray(node)}


def test_the_newest_verifiable_checkpoint_is_chosen_as_in_jax(tmp_path):
    ckpt_dir = tmp_path / "run" / "version_0" / "checkpoint"
    for step in (10, 20):
        save_state(str(ckpt_dir / f"ckpt_{step}_0.ckpt"), {"iter_num": step})
    (ckpt_dir / "ckpt_30_0.ckpt").write_bytes(b"not a pickle")
    (ckpt_dir / "ckpt_40_0.ckpt.tmp").write_bytes(b"half written")
    run_dir = str(tmp_path / "run")
    assert [checkpoint_step(p) for p in list_checkpoints(run_dir)] == [30, 20, 10]
    assert verify_checkpoint(str(ckpt_dir / "ckpt_30_0.ckpt"))[0] is False
    assert resolve_resume_from(run_dir) == jax_resolve_resume_from(run_dir) == str(ckpt_dir / "ckpt_20_0.ckpt")
    # a manifest that disagrees with its file rejects it; one that agrees verifies it
    Path(manifest_path(str(ckpt_dir / "ckpt_20_0.ckpt"))).write_text('{"format": 1, "bytes": 1, "sha256": "x"}')
    assert verify_checkpoint(str(ckpt_dir / "ckpt_20_0.ckpt")) == (False, "size_mismatch")
    assert resolve_resume_from(run_dir) == jax_resolve_resume_from(run_dir) == str(ckpt_dir / "ckpt_10_0.ckpt")
    with pytest.raises(ValueError, match="fails verification"):
        resolve_resume_from(str(ckpt_dir / "ckpt_30_0.ckpt"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No verifiable checkpoint"):
        resolve_resume_from(str(tmp_path / "empty"))


def test_keep_last_never_deletes_the_resumed_checkpoint(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "PROTECTED_CHECKPOINTS", set())
    folder = tmp_path / "checkpoint"

    class _Runtime:
        def save(self, path, state):
            save_state(path, state)

    callback = CheckpointCallback(keep_last=1)
    callback.on_checkpoint_coupled(_Runtime(), str(folder / "ckpt_4_0.ckpt"), {"iter_num": 2})
    ckpt_mod.protect_checkpoint(str(folder / "ckpt_4_0.ckpt"))
    for step in (8, 12):
        callback.on_checkpoint_coupled(_Runtime(), str(folder / f"ckpt_{step}_0.ckpt"), {"iter_num": step})
    assert sorted(p.name for p in folder.glob("*.ckpt")) == ["ckpt_12_0.ckpt", "ckpt_4_0.ckpt"]


def test_ratio_restores_as_in_jax():
    ours, theirs = Ratio(0.5, pretrain_steps=3), JaxRatio(0.5, pretrain_steps=3)
    for step in (8, 12, 13, 20):
        assert ours(step) == theirs(step)
    state = theirs.state_dict()
    restored, jax_restored = Ratio(1.0).load_state_dict(state), JaxRatio(1.0).load_state_dict(state)
    for step in (24, 31):
        assert restored(step) == jax_restored(step)
    old = {"_ratio": 2.0, "_prev": 4, "_pretrain_steps": 0}
    assert Ratio(1.0).load_state_dict(old).state_dict() == JaxRatio(1.0).load_state_dict(old).state_dict()
    with pytest.raises(KeyError):
        Ratio(1.0).load_state_dict({"credit": 0.0})


def test_eval_scores_a_jax_written_and_a_port_written_checkpoint(disc, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # the JAX package writes the run config and the checkpoint
    jax_dir = tmp_path / "jax_run" / "version_0"
    jax_cfg = disc.jax_cfg
    jax_cfg.root_dir = "evaltest"
    jax_save_configs(jax_cfg, str(jax_dir))
    jax_ckpt = jax_dir / "checkpoint" / "ckpt_8_0.ckpt"
    jax_save_state(str(jax_ckpt), {**disc.params, "iter_num": 4})
    with open(jax_dir / "config.yaml") as fp:
        assert yaml.safe_load(fp)["metric"]["logger"]["_target_"].startswith("sheeprl_tpu.utils.logger")
    reward = cli.evaluation([f"checkpoint_path={jax_ckpt}", "fabric.accelerator=cpu"])
    assert np.isfinite(reward)
    # the evaluation runs as <run>_evaluation, the archived TensorBoard logger
    # re-rooted at it (the port's logger class, not the archived JAX one)
    events = list((tmp_path / "logs" / "runs" / "evaltest" / "version_0_evaluation").rglob("events.out.tfevents.*"))
    assert events, sorted(str(p) for p in (tmp_path / "logs").rglob("*"))
    assert (tmp_path / "logs" / "runs" / "evaltest" / "version_0_evaluation" / "version_0").is_dir()

    out = cli.run(RUN)
    reward = cli.evaluation([f"checkpoint_path={out['checkpoints'][-1]}", "fabric.accelerator=cpu", "root_dir=porteval",
                             "run_name=mine"])
    assert np.isfinite(reward)
    assert (tmp_path / "logs" / "runs" / "porteval" / "mine" / "version_0").is_dir()
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.evaluation(["fabric.accelerator=cpu"])
    assert not os.path.exists(tmp_path / "logs" / "runs" / "porteval" / "mine" / "version_1")


def test_eval_raises_where_no_cuda_device_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "run" / "checkpoint").mkdir(parents=True)
    (tmp_path / "run" / "config.yaml").write_text(
        "algo: {name: dreamer_v3}\nenv: {num_envs: 4}\nmetric: {logger: null}\nroot_dir: x\nfabric: {accelerator: auto}\n")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.evaluation([f"checkpoint_path={tmp_path / 'run' / 'checkpoint' / 'ckpt_0_0.ckpt'}"])
    assert not (tmp_path / "logs").exists()  # refused before the evaluation started
