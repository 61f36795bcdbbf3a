"""The port's config composition against the JAX package's: the same
overrides compose to the same dict once the package prefix of the
``_target_`` strings is normalized (and the port's optimizer factories,
``sheeprl_tpu_torch.utils.optim.*``, read as the optax functions they
stand for)."""

from __future__ import annotations

from typing import Any

import pytest

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config import compose_group as jax_compose_group
from sheeprl_tpu_torch.config import CONFIG_DIR, ConfigError, compose, compose_group, deep_merge


def _normalized(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _normalized(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_normalized(v) for v in node]
    if isinstance(node, str):
        return node.replace("sheeprl_tpu_torch.utils.optim.", "optax.").replace("sheeprl_tpu_torch.", "sheeprl_tpu.")
    return node


@pytest.mark.parametrize(
    "overrides",
    [
        ["exp=dreamer_v3", "env=dummy"],
        ["exp=dreamer_v3", "env=dummy", "algo=dreamer_v3_XL", "algo.world_model.discrete_size=16"],
        ["exp=dreamer_v3_100k_ms_pacman", "env=dummy"],
    ],
)
def test_compose_matches_the_jax_package(overrides):
    overrides = [*overrides, "run_name=fixed"]  # run_name embeds the clock
    got = compose(overrides)
    want = jax_compose(overrides)
    assert _normalized(got.as_dict()) == want.as_dict()
    assert got.algo.world_model.recurrent_model.recurrent_state_size == want.algo.world_model.recurrent_model.recurrent_state_size


def test_dreamer_v3_composes_to_dv3_s_with_port_targets():
    cfg = compose(["exp=dreamer_v3", "env=dummy", "run_name=fixed"])
    wm = cfg.algo.world_model
    assert (wm.recurrent_model.recurrent_state_size, cfg.algo.dense_units, cfg.algo.mlp_layers) == (512, 512, 2)
    assert (wm.encoder.cnn_channels_multiplier, wm.stochastic_size, wm.discrete_size) == (32, 32, 32)
    assert cfg.env.wrapper._target_ == "sheeprl_tpu_torch.envs.env.get_dummy_env"
    strings = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif isinstance(node, str):
            strings.append(node)

    walk(cfg.as_dict())
    assert not [s for s in strings if s.startswith("sheeprl_tpu.")]
    # the DV3 path instantiates no optax target
    assert not [s for s in strings if s.startswith("optax.")]
    for name in ("world_model", "actor", "critic"):
        assert cfg.algo[name].optimizer._target_ == "sheeprl_tpu_torch.utils.optim.adam"


def test_no_yaml_names_the_jax_package():
    for path in CONFIG_DIR.rglob("*.yaml"):
        assert "sheeprl_tpu." not in path.read_text().replace("sheeprl_tpu_torch.", ""), path


def test_serving_group_and_deep_merge():
    serving = compose_group("serving", "default")
    assert _normalized(serving.as_dict()) == jax_compose_group("serving", "default").as_dict()
    deep_merge(serving, {"sessions": {"capacity": 8}, "batch_buckets": [2, 4]})
    assert serving.sessions.capacity == 8 and serving.batch_buckets == [2, 4] and serving.port == 0


def test_missing_experiment_is_an_error():
    with pytest.raises(ConfigError):
        compose(["env=dummy"])
