"""A run's records and registries in the port against the JAX package, on
the CPU at tiny widths: the W&B and MLflow loggers and the MLflow model
manager driven by the JAX tests' fakes, the models a run registers at its
end, ``registration``, ``check_configs``' model-manager gate and the other
global keys (``matmul_precision``, ``num_threads``, ``env.action_repeat``),
the whole-run profiler (``metric.profiler``) and the goodput capture beside
it, and ``available_agents``.

The fakes of ``wandb`` and ``mlflow`` are the JAX tests' own
(``tests/test_utils/test_logger_stubs.py``,
``tests/test_utils/test_mlflow_manager.py``); every comparison is exact.
"""

from __future__ import annotations

import contextlib
import datetime
import getpass
import glob
import importlib.util
import json
import os
import pickle
import sys
import types
import warnings
from pathlib import Path
from types import SimpleNamespace

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import sheeprl_tpu.utils.logger as jax_logger_mod
import sheeprl_tpu.utils.mlflow as jax_mlflow_mod
from sheeprl_tpu.algos.dreamer_v3.agent import build_agent as jax_dv3_build_agent
from sheeprl_tpu.algos.ppo.agent import build_agent as jax_ppo_build_agent
from sheeprl_tpu.cli import check_configs as jax_check_configs
from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.utils.registry import algorithm_registry as jax_algorithm_registry
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.available_agents import agent_rows
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.diagnostics.goodput import GoodputMonitor
from sheeprl_tpu_torch.envs.env import make_env
from sheeprl_tpu_torch.utils import imports as port_imports
from sheeprl_tpu_torch.utils import logger as port_logger_mod
from sheeprl_tpu_torch.utils import mlflow as port_mlflow_mod
from sheeprl_tpu_torch.utils.checkpoint import load_state
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)


def _jax_test_module(name: str):
    """One of the JAX package's test modules under ``tests/test_utils/``,
    loaded from its file under a name of its own: importing it as
    ``test_utils.<name>`` would shadow ``tests/test_utils/test_utils.py``."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", Path(__file__).parent / "test_utils" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_stubs, _manager_tests = _jax_test_module("test_logger_stubs"), _jax_test_module("test_mlflow_manager")
fake_wandb, fake_mlflow = _stubs.fake_wandb, _stubs.fake_mlflow  # the JAX tests' fakes, as fixtures here
FakeClient, _add_run = _manager_tests.FakeClient, _manager_tests._add_run

DV3_TINY = ["exp=dreamer_v3", "env=dummy", "fabric.accelerator=cpu", "env.capture_video=False", "env.screen_size=16",
            "algo.dense_units=8", "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.representation_model.hidden_size=8", "algo.world_model.transition_model.hidden_size=8",
            "algo.world_model.discrete_size=4", "algo.world_model.stochastic_size=4", "algo.per_rank_batch_size=2",
            "algo.per_rank_sequence_length=4", "algo.horizon=3", "algo.learning_starts=16", "algo.total_steps=24",
            "buffer.size=64", "env.num_envs=2", "metric.logger=null", "algo.run_test=False", "diagnostics=off"]
DV2_TINY = ["exp=dreamer_v2"] + [o for o in DV3_TINY[1:]]
PPO_TINY = ["exp=ppo", "env=dummy", "env.id=discrete_dummy", "fabric.accelerator=cpu", "env.capture_video=False",
            "env.num_envs=2", "algo.rollout_steps=8", "algo.per_rank_batch_size=4", "algo.update_epochs=1",
            "algo.total_steps=32", "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]",
            "metric.logger=null", "algo.run_test=False", "diagnostics=off"]
PPO_REC_TINY = ["exp=ppo_recurrent", "env=dummy", "fabric.accelerator=cpu", "env.capture_video=False",
                "algo.mlp_keys.encoder=[state]", "algo.cnn_keys.encoder=[]", "env.num_envs=2",
                "algo.rollout_steps=8", "algo.per_rank_sequence_length=4", "algo.per_rank_num_batches=2",
                "algo.update_epochs=1", "algo.total_steps=16", "metric.logger=null", "algo.run_test=False",
                "diagnostics=off"]


# ---------------------------------------------------------------------------
# the loggers, driven by the JAX tests' fake backends
# ---------------------------------------------------------------------------


def _wandb_calls(cls, fake, save_dir):
    logger = cls(project="proj", save_dir=save_dir, name="run1")
    logger.log_metrics({"Loss/policy_loss": 1.5, "Rewards/rew_avg": 2}, step=7)

    class Cfg(dict):
        def as_dict(self):
            return dict(self)

    logger.log_hyperparams(Cfg({"algo": {"lr": 3e-4}, "seed": 5}))
    logger.finalize()
    return (list(fake.inits), fake.run.logged, fake.run.config.updates, fake.run.finished, logger.name,
            logger.log_dir)


def test_wandb_logger_makes_the_jax_loggers_calls(fake_wandb, monkeypatch, tmp_path):
    monkeypatch.setattr(port_logger_mod, "_IS_WANDB_AVAILABLE", True)
    want = _wandb_calls(jax_logger_mod.WandbLogger, fake_wandb, str(tmp_path))
    fake_wandb.inits.clear()
    assert _wandb_calls(port_logger_mod.WandbLogger, fake_wandb, str(tmp_path)) == want


def _mlflow_calls(cls, fake):
    fake.calls.clear()
    logger = cls(experiment_name="exp1", tracking_uri="http://tracking", run_name="r")
    logger.log_metrics({"Loss/value_loss": 2, "Rewards/rew_avg": 3.5}, step=11)
    logger.log_hyperparams({"algo": {"optimizer": {"lr": 1e-3}, "name": "ppo"}, "seed": 5})
    logger.finalize()
    return list(fake.calls), logger.name


def test_mlflow_logger_makes_the_jax_loggers_calls(fake_mlflow, monkeypatch):
    monkeypatch.setattr(port_logger_mod, "_IS_MLFLOW_AVAILABLE", True)
    want = _mlflow_calls(jax_logger_mod.MLFlowLogger, fake_mlflow)
    assert _mlflow_calls(port_logger_mod.MLFlowLogger, fake_mlflow) == want
    monkeypatch.setenv("MLFLOW_TRACKING_URI", "http://from-env")
    fake_mlflow.calls.clear()
    jax_logger_mod.MLFlowLogger(experiment_name="e")
    want = list(fake_mlflow.calls)
    fake_mlflow.calls.clear()
    port_logger_mod.MLFlowLogger(experiment_name="e")
    assert fake_mlflow.calls == want


@pytest.mark.parametrize("backend", ["WandbLogger", "MLFlowLogger"])
def test_loggers_raise_the_jax_error_without_their_backend(monkeypatch, backend):
    for mod in (jax_logger_mod, port_logger_mod):
        monkeypatch.setattr(mod, "_IS_WANDB_AVAILABLE", False)
        monkeypatch.setattr(mod, "_IS_MLFLOW_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError) as want:
        getattr(jax_logger_mod, backend)()
    with pytest.raises(ModuleNotFoundError) as got:
        getattr(port_logger_mod, backend)()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("option", ["metric=default_wandb", "metric.logger=wandb", "metric.logger=mlflow"])
def test_metric_logger_is_built_and_journals_through_the_proxy(fake_wandb, fake_mlflow, monkeypatch, tmp_path,
                                                                option):
    """``metric=default_wandb`` (both packages) or ``metric.logger=wandb|mlflow``
    (the logger group's option: the JAX package keeps the bare name and its
    ``get_logger`` cannot build it) gives the backend behind the journaling
    proxy."""
    monkeypatch.setattr(port_logger_mod, "_IS_WANDB_AVAILABLE", True)
    monkeypatch.setattr(port_logger_mod, "_IS_MLFLOW_AVAILABLE", True)
    overrides = [o for o in DV3_TINY if o != "metric.logger=null"] + [option, f"root_dir={tmp_path}"]
    cfg = compose(overrides)
    logged = []
    runtime = SimpleNamespace(is_global_zero=True,
                              diagnostics=SimpleNamespace(augment_metrics=lambda step, m: m,
                                                          log_metrics=lambda step, m: logged.append((step, m))))
    logger = port_logger_mod.get_logger(runtime, cfg)
    fake_mlflow.calls.clear()
    logger.log_metrics({"Loss/x": 1.0}, 3)
    assert logged == [(3, {"Loss/x": 1.0})]
    if option.endswith("mlflow"):
        assert logger.name == "mlflow" and fake_mlflow.calls == [("log_metrics", {"Loss/x": 1.0}, 3)]
    else:
        assert logger.name == "wandb" and fake_wandb.inits[0]["project"] == "sheeprl_tpu"
        assert fake_wandb.run.logged == [({"Loss/x": 1.0}, 3)]
    if option.startswith("metric.logger"):
        from sheeprl_tpu.utils.logger import get_logger as jax_get_logger

        with pytest.raises(ValueError):
            jax_get_logger(runtime, jax_compose(overrides))


# ---------------------------------------------------------------------------
# the model manager against the JAX tests' fake client
# ---------------------------------------------------------------------------


class _FixedDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2026, 1, 2, 3, 4, 5)


def _manager(mod, monkeypatch):
    client = FakeClient()
    fake = types.ModuleType("mlflow")
    fake.set_tracking_uri = lambda uri: None
    fake.register_model = lambda model_uri, name, tags=None: client._register(name)
    tracking = types.ModuleType("mlflow.tracking")
    tracking.MlflowClient = lambda: client
    fake.tracking = tracking
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    monkeypatch.setitem(sys.modules, "mlflow.tracking", tracking)
    monkeypatch.setattr(mod, "_IS_MLFLOW_AVAILABLE", True)
    printed = []
    return mod.MlflowModelManager(SimpleNamespace(print=lambda *a: printed.append(a)), tracking_uri="fake://"), \
        client, printed


def _drive_manager(mod, monkeypatch):
    mgr, client, printed = _manager(mod, monkeypatch)
    out = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out.append(mgr.register_model("runs:/abc/agent", "m", description="first drop").version)
        out.append(mgr.register_model("runs:/abc/agent", "m").version)
        out.append(mgr.transition_model("m", 1, "staging", description="promote").current_stage)
        out.append(mgr.transition_model("m", 1, "staging").current_stage)
        out.append(mgr.transition_model("m", 99, "production"))
        out.append(mgr.get_latest_version("m").version)
        out.append(mgr.get_latest_version("none"))
        mgr.delete_model("m", 1, description="obsolete")
        mgr.delete_model("m", 42)
        client.experiments["exp"] = "e1"
        _add_run(client, "r_low", "e1", {"Test/cumulative_reward": 10.0}, ["agent"])
        _add_run(client, "r_best", "e1", {"Test/cumulative_reward": 99.0}, ["agent", "critic"])
        _add_run(client, "r_nometric", "e1", {}, ["agent"])
        info = {"agent": {"path": "agent", "name": "best-agent", "description": "d", "tags": None},
                "critic": {"path": "critic", "name": "best-critic"}, "absent": {"path": "x", "name": "never"}}
        for mode in ("max", "min"):
            best = mgr.register_best_models("exp", info, mode=mode)
            out.append({k: (v.name, v.version) for k, v in best.items()})
        out.append(mgr.register_best_models("missing", {}))
        with pytest.raises(ValueError) as err:
            mgr.register_best_models("exp", {}, mode="median")
        out.append(str(err.value))
    versions = {k: (v.version, v.current_stage, v.description) for k, v in client.versions.items()}
    return out, dict(client.registered), versions, client.deleted, printed, [str(w.message) for w in caught]


def test_model_manager_keeps_the_jax_changelog_and_choices(monkeypatch):
    monkeypatch.setattr(getpass, "getuser", lambda: "builder")
    monkeypatch.setattr(datetime, "datetime", _FixedDatetime)
    want = _drive_manager(jax_mlflow_mod, monkeypatch)
    got = _drive_manager(port_mlflow_mod, monkeypatch)
    assert got == want
    assert "## **Transition:**" in got[1]["m"] and "**Date**: 02/01/2026 03:04:05" in got[1]["m"]
    assert any("already in stage" in w for w in got[5]) and any("not found" in w for w in got[5])


def test_model_manager_raises_the_jax_error_without_mlflow(monkeypatch):
    errors = []
    for mod in (jax_mlflow_mod, port_mlflow_mod):
        monkeypatch.setattr(mod, "_IS_MLFLOW_AVAILABLE", False)
        with pytest.raises(ModuleNotFoundError) as err:
            mod.MlflowModelManager(SimpleNamespace())
        errors.append(str(err.value))
        with pytest.raises(ModuleNotFoundError) as err:
            mod.register_model_from_checkpoint(SimpleNamespace())
        errors.append(str(err.value))
        with pytest.warns(UserWarning, match="mlflow is not installed: skipping model registration"):
            assert mod.log_models(SimpleNamespace(), {"agent": {}}, ".") == {}
    assert errors[:2] == errors[2:]


# ---------------------------------------------------------------------------
# the models a run registers at its end
# ---------------------------------------------------------------------------


class _FakeMlflowRuns:
    """The part of ``mlflow`` ``log_models`` drives: the artifacts' bytes and
    the registrations, in order."""

    def __init__(self):
        self.artifacts, self.registered = {}, []
        module = types.ModuleType("mlflow")

        @contextlib.contextmanager
        def start_run(run_id=None, nested=False):
            yield SimpleNamespace(info=SimpleNamespace(run_id="run-1"))

        def log_artifact(path, artifact_path=None):
            with open(path, "rb") as fp:
                self.artifacts[artifact_path] = fp.read()

        def register_model(model_uri, name, tags=None):
            self.registered.append((model_uri, name, tags))
            return SimpleNamespace(name=name, version=str(len(self.registered)))

        module.start_run, module.log_artifact, module.register_model = start_run, log_artifact, register_model
        self.module = module


@contextlib.contextmanager
def _mlflow_installed(*modules):
    fake = _FakeMlflowRuns()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "mlflow", fake.module)
        for mod in (port_imports, port_mlflow_mod, *modules):
            mp.setattr(mod, "_IS_MLFLOW_AVAILABLE", True)
        yield fake


def _registered_run(tmp_path_factory, overrides, name):
    cwd = os.getcwd()
    root = tmp_path_factory.mktemp(name)
    os.chdir(root)
    try:
        with _mlflow_installed() as fake:
            out = cli.run(overrides + ["model_manager.disabled=False", "metric.profiler.enabled=True",
                                       f"metric.profiler.trace_dir={root / 'trace'}", f"root_dir={root / 'runs'}"])
    finally:
        os.chdir(cwd)
    return SimpleNamespace(out=out, fake=fake, root=root, cfg=compose(overrides))


@pytest.fixture(scope="module")
def dv3_run(tmp_path_factory):
    # the exp configs select no model_manager group (neither package's):
    # the user names the algorithm's
    return _registered_run(tmp_path_factory, DV3_TINY + ["model_manager=dreamer_v3"], "dv3")


@pytest.fixture(scope="module")
def ppo_run(tmp_path_factory):
    return _registered_run(tmp_path_factory, PPO_TINY + ["model_manager=ppo"], "ppo")


def _tree_signature(tree):
    return {jax.tree_util.keystr(p): (tuple(v.shape), np.dtype(v.dtype).name)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_obs_space(cfg):
    env = make_env(cfg, cfg.seed, 0)()
    try:
        obs, act = env.observation_space, env.action_space
    finally:
        env.close()
    gym_obs = gym.spaces.Dict({k: gym.spaces.Box(s.low, s.high, s.shape, s.dtype) for k, s in obs.spaces.items()})
    return gym_obs, int(act.n)


def _check_artifacts(run, models_to_register, jax_params):
    """Exactly the trees the JAX loop would log, each the pickle of the
    run's last checkpoint's tree (the converter's dump of the final
    modules: nothing trains after it) with the JAX tree's structure."""
    archived = run.out["log_dir"]
    registered_names = {name for _, name, _ in run.fake.registered}
    state = load_state(run.out["checkpoints"][-1])
    expected = set(jax_params) & set(models_to_register) & set(run.cfg.model_manager.models)
    assert set(run.fake.artifacts) == expected, (sorted(run.fake.artifacts), sorted(expected), archived)
    assert registered_names == {run.cfg.model_manager.models[k]["model_name"] for k in expected}
    assert [uri for uri, _, _ in run.fake.registered] == [f"runs:/run-1/{k}" for k in run.fake.artifacts]
    for name, blob in run.fake.artifacts.items():
        tree = pickle.loads(blob)
        assert blob == pickle.dumps(port_mlflow_mod.flax_tree(state[name]))
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(jax_params[name])
        assert _tree_signature(tree) == _tree_signature(jax_params[name])


def test_dreamer_v3_registers_the_trees_the_jax_loop_logs(dv3_run):
    from sheeprl_tpu_torch.algos.dreamer_v3.utils import MODELS_TO_REGISTER

    cfg = jax_compose(DV3_TINY + ["model_manager=dreamer_v3"])
    gym_obs, n = _jax_obs_space(dv3_run.cfg)
    params = jax.eval_shape(lambda: jax_dv3_build_agent(None, (n,), False, cfg, gym_obs)[3])
    assert set(dv3_run.fake.artifacts) == {"world_model", "actor", "critic", "target_critic"}
    _check_artifacts(dv3_run, MODELS_TO_REGISTER, params)


def test_ppo_registers_its_agent_as_the_jax_loop_does(ppo_run):
    from sheeprl_tpu_torch.algos.ppo.utils import MODELS_TO_REGISTER

    cfg = jax_compose(PPO_TINY + ["model_manager=ppo"])
    gym_obs, n = _jax_obs_space(ppo_run.cfg)
    params = jax.eval_shape(lambda: jax_ppo_build_agent(None, (n,), False, cfg, gym_obs)[1])
    assert set(ppo_run.fake.artifacts) == {"agent"}
    _check_artifacts(ppo_run, MODELS_TO_REGISTER, {"agent": params})


@pytest.mark.parametrize("exp", ["dreamer_v2", "ppo_recurrent"])
def test_dreamer_v2_and_ppo_recurrent_register_nothing_and_trace_the_run(tmp_path_factory, exp):
    """The JAX DreamerV2 and PPO-recurrent loops read ``model_manager`` and
    register nothing; ``metric.profiler`` traces both runs (it did not: the
    loops neither ran nor refused it)."""
    overrides = DV2_TINY if exp == "dreamer_v2" else PPO_REC_TINY
    run = _registered_run(tmp_path_factory, overrides + [f"model_manager={exp}"], exp)
    assert run.cfg.model_manager.models
    assert run.fake.artifacts == {} and run.fake.registered == []
    assert run.out["gradient_steps" if exp == "dreamer_v2" else "iterations"] > 0
    _check_trace(run.root / "trace")


def _check_trace(trace_dir: Path):
    (path,) = glob.glob(str(trace_dir / "*.pt.trace.json"))
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("ph") == "X" and e.get("cat") == "cpu_op" for e in events)


def test_ppo_run_is_traced_by_the_whole_run_profiler(ppo_run):
    """As ``test_profiler_trace_capture`` checks for the JAX package: a
    trace on disk for a PPO run with ``metric.profiler.enabled=True``."""
    _check_trace(ppo_run.root / "trace")


def test_registration_gives_the_jax_entry_points_pickles(dv3_run, monkeypatch):
    """``register_model_from_checkpoint`` of both packages on one port
    checkpoint, and the port's ``registration`` entry point: equal
    artifacts, byte for byte."""
    from sheeprl_tpu.utils.utils import dotdict as jax_dotdict

    ckpt = dv3_run.out["checkpoints"][-1]
    with _mlflow_installed() as fake:
        cli.registration([f"checkpoint_path={ckpt}"])
        port = dict(fake.artifacts), list(fake.registered)
    cfg = cli._archived_config(Path(ckpt))
    cfg.checkpoint_path = ckpt
    with _mlflow_installed(jax_mlflow_mod) as fake:
        jax_mlflow_mod.register_model_from_checkpoint(jax_dotdict(cfg.as_dict()))
        want = dict(fake.artifacts), list(fake.registered)
    assert port == want
    assert set(port[0]) == {"world_model", "actor", "critic", "target_critic", "moments"}


def test_registration_refuses_without_mlflow(dv3_run, monkeypatch):
    monkeypatch.setattr(port_mlflow_mod, "_IS_MLFLOW_AVAILABLE", False)
    with pytest.raises(ModuleNotFoundError, match="mlflow is not installed; cannot register models"):
        cli.registration([f"checkpoint_path={dv3_run.out['checkpoints'][-1]}"])
    with pytest.raises(ValueError, match="checkpoint_path"):
        cli.registration([])


# ---------------------------------------------------------------------------
# check_configs: the model-manager gate and the global keys
# ---------------------------------------------------------------------------


def _check(check, cfg):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        check(cfg)
    return [(w.category, str(w.message)) for w in caught]


@pytest.mark.parametrize("option", ["model_manager.disabled=False", "env.action_repeat=0"])
def test_check_configs_warns_and_repairs_as_the_jax_one(monkeypatch, option):
    import sheeprl_tpu.utils.imports as jax_imports

    monkeypatch.setattr(jax_imports, "_IS_MLFLOW_AVAILABLE", False)
    monkeypatch.setattr(port_imports, "_IS_MLFLOW_AVAILABLE", False)
    overrides = PPO_TINY + [option]
    jax_cfg, cfg = jax_compose(overrides), compose(overrides)
    want, got = _check(jax_check_configs, jax_cfg), _check(cli.check_configs, cfg)
    assert got == want and len(got) == 1
    assert cfg.model_manager.disabled is jax_cfg.model_manager.disabled is True
    assert cfg.env.action_repeat == jax_cfg.env.action_repeat == 1


def test_check_configs_refuses_a_bad_matmul_precision_as_the_jax_one():
    overrides = PPO_TINY + ["matmul_precision=fastest"]
    with pytest.raises(ValueError) as want:
        jax_check_configs(jax_compose(overrides))
    with pytest.raises(ValueError) as got:
        cli.check_configs(compose(overrides))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("value,torch_value", [("default", None), ("highest", "highest"), ("high", "high"),
                                               ("tensorfloat32", "high"), ("bfloat16", "medium")])
def test_run_applies_matmul_precision_and_num_threads(monkeypatch, value, torch_value):
    """``matmul_precision`` sets the float32 product's precision, and
    ``num_threads`` the env workers' BLAS threads, before the run starts (the
    port read neither)."""
    before = torch.get_float32_matmul_precision()
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    seen = {}
    monkeypatch.setattr(cli, "run_algorithm", lambda cfg: seen.update(
        precision=torch.get_float32_matmul_precision(), threads=os.environ.get("MKL_NUM_THREADS")))
    try:
        cli.run(PPO_TINY + [f"matmul_precision={value}", "num_threads=3"])
    finally:
        torch.set_float32_matmul_precision(before)
    assert seen == {"precision": torch_value or before, "threads": "3"}


# ---------------------------------------------------------------------------
# the goodput capture beside a whole-run trace; the agents' table
# ---------------------------------------------------------------------------


def test_goodput_capture_is_busy_while_a_whole_run_trace_holds_the_profiler(tmp_path):
    cfg = {"diagnostics": {"goodput": {"watchdog": {"enabled": False}, "profile": {"enabled": True, "max_ms": 10}}}}
    journal = []
    mon = GoodputMonitor(cfg)
    mon.open(lambda event, **fields: journal.append((event, fields)), lambda: None, log_dir=str(tmp_path))
    try:
        with cli.whole_run_profile(str(tmp_path / "trace"), torch.device("cpu")) as path:
            assert mon.capture_profile() == {"status": "busy"}
            torch.ones(2).sum()
        assert mon.capture_profile()["status"] == "ok"
    finally:
        mon.close()
    assert [fields["status"] for event, fields in journal if event == "profile_capture"] == ["busy", "ok"]
    assert os.path.exists(path)


def test_available_agents_are_the_jax_packages_ported_rows():
    rows = agent_rows()
    names = {name for _, name, _, _ in rows}
    want = sorted((module.removeprefix("sheeprl_tpu."), m["name"], m["entrypoint"], m["decoupled"])
                  for module, metadata in jax_algorithm_registry.items() for m in metadata if m["name"] in names)
    got = sorted((module.removeprefix("sheeprl_tpu_torch."), name, entrypoint, decoupled)
                 for module, name, entrypoint, decoupled in rows)
    assert got == want and len(got) == 18
    assert sorted(name for _, name, _, decoupled in got if decoupled) == ["ppo_decoupled", "sac_decoupled"]
