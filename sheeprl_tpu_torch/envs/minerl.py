"""MineRL 0.4.4 adapter: counterpart of ``sheeprl_tpu/envs/minerl.py`` over
the port's spaces.

Flattens MineRL's dict action space into one Discrete menu (one entry per
binary command, camera quadrant, and enum value), exposes a Dict observation
with the POV frame (CHW), life stats, dense inventory vectors and optionally
compass/equipment, and applies the shared sticky-attack/jump and pitch-clamp
state machines of ``envs/_minecraft.py``.  Tasks are the custom specs of
``envs/minerl_envs`` (navigate / obtain-diamond / obtain-iron-pickaxe),
selected by id.  Importing the module raises ``ModuleNotFoundError`` where
``minerl`` is missing.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs._minecraft import PitchTracker, StickyActions, count_items
from sheeprl_tpu_torch.utils.imports import _IS_MINERL_AVAILABLE

if not _IS_MINERL_AVAILABLE:
    raise ModuleNotFoundError("No module named 'minerl'")

import minerl.herobraine.hero.spaces as minerl_spaces  # noqa: E402
from minerl.herobraine.hero import mc  # noqa: E402

from sheeprl_tpu_torch.envs.minerl_envs.specs import (  # noqa: E402
    CustomNavigate,
    CustomObtainDiamond,
    CustomObtainIronPickaxe,
)

TASKS = {
    "custom_navigate": CustomNavigate,
    "custom_obtain_diamond": CustomObtainDiamond,
    "custom_obtain_iron_pickaxe": CustomObtainIronPickaxe,
}

N_ALL_ITEMS = len(mc.ALL_ITEMS)
ITEM_NAME_TO_ID = {name: i for i, name in enumerate(mc.ALL_ITEMS)}
CAMERA_DELTAS = (
    np.array([-15.0, 0.0]),  # pitch down
    np.array([15.0, 0.0]),  # pitch up
    np.array([0.0, -15.0]),  # yaw left
    np.array([0.0, 15.0]),  # yaw right
)
_MOVEMENT_COMBOS = {"jump", "sneak", "sprint"}  # these also press forward


def _noop_action(action_space) -> Dict[str, Any]:
    """The all-zeros / all-'none' MineRL action dict."""
    noop: Dict[str, Any] = {}
    for name, space in action_space.spaces.items():
        if isinstance(space, minerl_spaces.Enum):
            noop[name] = "none"
        elif name == "camera":
            noop[name] = (0.0, 0.0)
        else:
            noop[name] = 0
    return noop


def build_action_menu(action_space) -> List[Dict[str, Any]]:
    """Enumerate the discrete action menu: entry 0 is no-op, then one entry
    per binary command (jump/sneak/sprint also press forward), four camera
    quadrant moves, and one entry per non-'none' enum value
    (upstream sheeprl's minerl.py:117-138)."""
    menu: List[Dict[str, Any]] = [{}]
    for name, space in action_space.spaces.items():
        if isinstance(space, minerl_spaces.Enum):
            for value in sorted(set(space.values.tolist()) - {"none"}):
                menu.append({name: value})
        elif name == "camera":
            menu.extend({name: delta} for delta in CAMERA_DELTAS)
        else:
            entry: Dict[str, Any] = {name: 1}
            if name in _MOVEMENT_COMBOS:
                entry["forward"] = 1
            menu.append(entry)
    return menu


class MineRLWrapper:
    metadata = {"render_modes": ["rgb_array", "human"]}

    def __init__(
        self,
        id: str,
        height: int = 64,
        width: int = 64,
        pitch_limits: Tuple[int, int] = (-60, 60),
        seed: Optional[int] = None,
        sticky_attack: int = 30,
        sticky_jump: int = 10,
        break_speed_multiplier: int = 100,
        multihot_inventory: bool = True,
        **kwargs: Any,
    ):
        if "navigate" not in id.lower():
            kwargs.pop("extreme", None)
        spec = TASKS[id.lower()](break_speed=break_speed_multiplier, **kwargs)
        self._env = spec.make()
        self._sticky = StickyActions(
            attack_for=0 if break_speed_multiplier > 1 else sticky_attack, jump_for=sticky_jump
        )
        self._pitch = PitchTracker(limits=(float(pitch_limits[0]), float(pitch_limits[1])))
        self._menu = build_action_menu(self._env.action_space)
        self._noop = _noop_action(self._env.action_space)
        self.action_space = spaces.Discrete(len(self._menu))

        # inventory vocabulary: every Minecraft item (multihot) or just the
        # task's obtainable items
        if multihot_inventory:
            self._item_to_id = ITEM_NAME_TO_ID
            self._n_items = N_ALL_ITEMS
        else:
            task_items = list(self._env.observation_space["inventory"].spaces.keys())
            self._item_to_id = {name: i for i, name in enumerate(task_items)}
            self._n_items = len(task_items)
        self._max_inventory = np.zeros(self._n_items, np.float32)

        obs_spaces: Dict[str, spaces.Space] = {
            "rgb": spaces.Box(0, 255, (3, height, width), np.uint8),
            "life_stats": spaces.Box(0.0, np.array([20.0, 20.0, 300.0]), (3,), np.float32),
            "inventory": spaces.Box(0.0, np.inf, (self._n_items,), np.float32),
            "max_inventory": spaces.Box(0.0, np.inf, (self._n_items,), np.float32),
        }
        if "compass" in self._env.observation_space.spaces:
            obs_spaces["compass"] = spaces.Box(-180.0, 180.0, (1,), np.float32)
        self._has_equipment = "equipped_items" in self._env.observation_space.spaces
        if self._has_equipment:
            if multihot_inventory:
                self._equip_to_id = ITEM_NAME_TO_ID
                self._n_equip = N_ALL_ITEMS
            else:
                equip_values = self._env.observation_space["equipped_items"]["mainhand"]["type"].values.tolist()
                self._equip_to_id = {name: i for i, name in enumerate(equip_values)}
                self._n_equip = len(equip_values)
            obs_spaces["equipment"] = spaces.Box(0.0, 1.0, (self._n_equip,), np.int32)
        self.observation_space = spaces.Dict(obs_spaces)
        self.render_mode = "rgb_array"
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    # ---- conversions ------------------------------------------------------------

    def _convert_action(self, action) -> Dict[str, Any]:
        cmd = dict(self._noop)
        cmd.update(self._menu[int(np.asarray(action).item())])
        attack, jump = self._sticky.update(attack=bool(cmd["attack"]), jump=bool(cmd["jump"]))
        cmd["attack"], cmd["jump"] = int(attack), int(jump)
        if jump:
            cmd["forward"] = 1  # sticky jump keeps moving forward
        d_pitch, d_yaw = self._pitch.apply(*np.asarray(cmd["camera"], np.float64))
        cmd["camera"] = np.array([d_pitch, d_yaw])
        return cmd

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        inventory = count_items(
            obs["inventory"].keys(), obs["inventory"].values(), self._item_to_id, self._n_items
        )
        self._max_inventory = np.maximum(inventory, self._max_inventory)
        out: Dict[str, np.ndarray] = {
            "rgb": obs["pov"].copy().transpose(2, 0, 1),
            "life_stats": np.array(
                [obs["life_stats"]["life"], obs["life_stats"]["food"], obs["life_stats"]["air"]],
                np.float32,
            ),
            "inventory": inventory,
            "max_inventory": self._max_inventory.copy(),
        }
        if "compass" in self.observation_space.spaces:
            out["compass"] = np.asarray(obs["compass"]["angle"], np.float32).reshape(-1)
        if self._has_equipment:
            onehot = np.zeros(self._n_equip, np.int32)
            equipped = str(obs["equipped_items"]["mainhand"]["type"])
            onehot[self._equip_to_id.get(equipped, self._equip_to_id["air"])] = 1
            out["equipment"] = onehot
        return out

    # ---- gym API ----------------------------------------------------------------

    def step(self, action) -> Tuple[Dict[str, np.ndarray], float, bool, bool, Dict[str, Any]]:
        obs, reward, done, info = self._env.step(self._convert_action(action))
        return self._convert_obs(obs), float(reward), bool(done), False, info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
        obs = self._env.reset()
        self._sticky.reset()
        self._pitch.reset()
        self._max_inventory = np.zeros(self._n_items, np.float32)
        return self._convert_obs(obs), {}

    def render(self) -> Optional[np.ndarray]:
        return self._env.render(self.render_mode)

    def close(self) -> None:
        self._env.close()
