"""The port stands alone: importing every module of ``sheeprl_tpu_torch``
and ``chip_smoke.py`` loads neither JAX nor the JAX package, the port's
entry points (``serve`` and ``run``) refuse to fall back to the CPU, and the
chip smoke refuses to run without a CUDA device."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.utils.utils import dotdict

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import sheeprl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu"))
print(len(names), leaked)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_and_chip_smoke_import_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.strip().split(" ", 1)
    assert int(count) >= 20 and leaked == "[]", out.stdout


def test_serve_without_cpu_accelerator_raises_where_no_cuda_device(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    for accelerator in ("auto", "cuda", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.select_device(dotdict({"fabric": {"accelerator": accelerator}}))
    assert str(cli.select_device(dotdict({"fabric": {"accelerator": "cpu"}}))) == "cpu"


def test_serve_entry_point_raises_where_no_cuda_device(tmp_path, monkeypatch):
    (tmp_path / "checkpoint").mkdir()
    (tmp_path / "config.yaml").write_text("fabric:\n  accelerator: auto\n")
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.serve([f"checkpoint_path={tmp_path / 'checkpoint' / 'ckpt_0_0.ckpt'}"])


def test_run_entry_point_raises_where_no_cuda_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["exp=dreamer_v3", "env=dummy", "diagnostics=off"])
    assert not (tmp_path / "logs").exists()  # refused before the run started


def test_chip_smoke_fails_and_prints_no_result_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode != 0 and '"ok"' not in out.stdout


_WORKER_IMPORTS = """
import sys
import sheeprl_tpu_torch.envs.executor, sheeprl_tpu_torch.envs.env, sheeprl_tpu_torch.envs.pipeline
import sheeprl_tpu_torch.envs.wrappers, sheeprl_tpu_torch.envs.dummy
print(sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "sheeprl_tpu", "gymnasium")))
"""


def test_env_worker_modules_import_neither_torch_nor_gymnasium():
    """What a spawned env worker imports to unpickle its env thunks
    (``envs/executor.py``, ``env.py``, ``wrappers.py``, ``dummy.py``) loads
    no torch, so it cannot touch CUDA, and no gymnasium, which the card
    lacks."""
    out = subprocess.run(
        [sys.executable, "-c", _WORKER_IMPORTS], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_ppo_run_raises_where_no_cuda_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run(["exp=ppo", "env=dummy"])
    assert not (tmp_path / "logs").exists()


@pytest.mark.parametrize("exp", ["dreamer_v3_jepa", "a2c"])
def test_jepa_and_a2c_runs_raise_where_no_cuda_device(tmp_path, monkeypatch, exp):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([f"exp={exp}", "env=dummy", "diagnostics=off"])
    assert not (tmp_path / "logs").exists()


def test_the_walk_reaches_the_jepa_and_a2c_modules():
    """Every module the import test loads includes this slice's."""
    import importlib
    import pkgutil

    import sheeprl_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")}
    new = {f"sheeprl_tpu_torch.algos.{algo}.{mod}" for algo, mods in
           (("dreamer_v3_jepa", ("agent", "utils", "dreamer_v3_jepa", "evaluate")),
            ("a2c", ("agent", "loss", "utils", "a2c", "evaluate"))) for mod in mods} | {"sheeprl_tpu_torch.models.jepa"}
    assert new <= names
    for name in sorted(new):
        importlib.import_module(name)



@pytest.mark.parametrize("exp", ["p2e_dv3_exploration", "p2e_dv3_finetuning"])
def test_p2e_runs_raise_where_no_cuda_device(tmp_path, monkeypatch, exp):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([f"exp={exp}", "env=dummy", "diagnostics=off", "checkpoint.exploration_ckpt_path=x"])
    assert not (tmp_path / "logs").exists()


def test_the_walk_reaches_the_p2e_modules():
    """Every module the import test loads includes the P2E slice's."""
    import importlib
    import pkgutil

    import sheeprl_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")}
    new = {f"sheeprl_tpu_torch.algos.p2e_dv3.{mod}" for mod in
           ("agent", "utils", "p2e_dv3_exploration", "p2e_dv3_finetuning", "evaluate")}
    assert new <= names
    for name in sorted(new):
        importlib.import_module(name)


@pytest.mark.parametrize("exp", ["sac", "droq", "sac_ae"])
def test_sac_family_runs_raise_where_no_cuda_device(tmp_path, monkeypatch, exp):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([f"exp={exp}", "env=dummy", "env.id=continuous_dummy", "diagnostics=off"])
    assert not (tmp_path / "logs").exists()


def test_the_walk_reaches_the_sac_family_modules():
    """Every module the import test loads includes the SAC family's."""
    import importlib
    import pkgutil

    import sheeprl_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")}
    new = {f"sheeprl_tpu_torch.algos.{algo}.{mod}" for algo, mods in
           (("sac", ("agent", "loss", "utils", "sac", "evaluate", "step_profile")),
            ("droq", ("agent", "utils", "droq", "evaluate")),
            ("sac_ae", ("agent", "utils", "sac_ae", "evaluate"))) for mod in mods}
    assert new <= names
    for name in sorted(new):
        importlib.import_module(name)


@pytest.mark.parametrize("algo", ["droq", "sac_ae"])
def test_serve_refuses_droq_and_sac_ae(algo):
    """The JAX package serves neither; the port's ``serve`` refuses their
    checkpoints before it builds anything."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.serving.loader import build_policy

    cfg = compose([f"exp={algo}", "env=dummy", "env.id=continuous_dummy"])
    obs = spaces.Dict({"state": spaces.Box(-1, 1, (3,))})
    with pytest.raises(ValueError, match=f"'{algo}' has no servable adapter"):
        build_policy(cfg, obs, spaces.Box(-1, 1, (2,)), None, "cpu")


@pytest.mark.parametrize("exp", ["dreamer_v2", "dreamer_v1", "ppo_recurrent"])
def test_dreamer_v1_v2_and_ppo_recurrent_runs_raise_where_no_cuda_device(tmp_path, monkeypatch, exp):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.run([f"exp={exp}", "env=dummy", "diagnostics=off", "algo.mlp_keys.encoder=[state]"])
    assert not (tmp_path / "logs").exists()


def test_the_walk_reaches_the_dreamer_v1_v2_and_ppo_recurrent_modules():
    """Every module the import test loads includes this slice's."""
    import importlib
    import pkgutil

    import sheeprl_tpu_torch

    names = {m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")}
    new = {f"sheeprl_tpu_torch.algos.{algo}.{mod}" for algo, mods in
           (("dreamer_v2", ("agent", "loss", "utils", "dreamer_v2", "evaluate")),
            ("dreamer_v1", ("agent", "loss", "utils", "dreamer_v1", "evaluate")),
            ("ppo_recurrent", ("agent", "utils", "ppo_recurrent", "evaluate"))) for mod in mods}
    assert new <= names
    for name in sorted(new):
        importlib.import_module(name)


@pytest.mark.parametrize("algo", ["dreamer_v1", "dreamer_v2"])
def test_serve_refuses_dreamer_v1_and_v2(algo):
    """The JAX package serves neither; the port's ``serve`` refuses their
    checkpoints before it builds anything."""
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.envs import spaces
    from sheeprl_tpu_torch.serving.loader import build_policy

    cfg = compose([f"exp={algo}", "env=dummy"])
    obs = spaces.Dict({"rgb": spaces.Box(0, 255, (3, 64, 64), "uint8")})
    with pytest.raises(ValueError, match=f"'{algo}' has no servable adapter"):
        build_policy(cfg, obs, spaces.Discrete(2), None, "cpu")


_IMPORT_OFFLINE = """
import sys
from sheeprl_tpu_torch.data import datasets
from sheeprl_tpu_torch.offline import export, train
from sheeprl_tpu_torch import cli
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu"))
print(train.OFFLINE_ALGOS, leaked)
"""


def test_the_offline_modules_import_no_jax():
    """The dataset layer, the export and the offline loop stand alone (the
    walk above imports them too), and the usage names the export command."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_OFFLINE], cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "('sac', 'droq', 'dreamer_v3') []", out.stdout
    usage = subprocess.run([sys.executable, "-m", "sheeprl_tpu_torch"], cwd=ROOT, env=_env(), capture_output=True,
                           text=True, timeout=120)
    assert usage.returncode != 0 and "sheeprl_tpu_torch export <run dir>" in usage.stderr
