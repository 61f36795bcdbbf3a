"""MineDojo adapter: counterpart of ``sheeprl_tpu/envs/minedojo.py`` over
the port's spaces.

A MultiDiscrete([n_action_types, n_craft_items, n_all_items]) action space
over MineDojo's 8-slot action encoding, and a Dict observation with dense
per-item inventory/equipment vectors plus the action masks the hierarchical
``MinedojoActor`` reads (``sheeprl_tpu_torch/algos/dreamer_v3/agent.py``).
Sticky attack/jump and pitch clamping are the shared state machines of
``envs/_minecraft.py``.  Importing the module raises
``ModuleNotFoundError`` where ``minedojo`` is missing.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import numpy as np

from sheeprl_tpu_torch.envs import spaces
from sheeprl_tpu_torch.envs._minecraft import MineDojoSticky, PitchTracker, count_items
from sheeprl_tpu_torch.utils.imports import _IS_MINEDOJO_AVAILABLE

if not _IS_MINEDOJO_AVAILABLE:
    raise ModuleNotFoundError("No module named 'minedojo'")

import minedojo  # noqa: E402
import minedojo.tasks  # noqa: E402
from minedojo.sim import ALL_CRAFT_SMELT_ITEMS, ALL_ITEMS  # noqa: E402

N_ALL_ITEMS = len(ALL_ITEMS)
ITEM_NAME_TO_ID = {name: i for i, name in enumerate(ALL_ITEMS)}
ITEM_ID_TO_NAME = dict(enumerate(ALL_ITEMS))

# The 19 composite action types, each encoded as an 8-slot ARNN action:
# [move, strafe, jump/sneak/sprint, pitch(0..24, 12=noop), yaw(0..24, 12=noop),
#  functional(0=noop 1=use 2=drop 3=attack 4=craft 5=equip 6=place 7=destroy),
#  craft arg, inventory arg]
_NOOP = (0, 0, 0, 12, 12, 0, 0, 0)


def _arnn(move=0, strafe=0, body=0, pitch=12, yaw=12, fn=0) -> np.ndarray:
    return np.array([move, strafe, body, pitch, yaw, fn, 0, 0])


ACTION_MAP: Dict[int, np.ndarray] = {
    0: _arnn(),  # no-op
    1: _arnn(move=1),  # forward
    2: _arnn(move=2),  # back
    3: _arnn(strafe=1),  # left
    4: _arnn(strafe=2),  # right
    5: _arnn(move=1, body=1),  # jump + forward
    6: _arnn(move=1, body=2),  # sneak + forward
    7: _arnn(move=1, body=3),  # sprint + forward
    8: _arnn(pitch=11),  # pitch down −15°
    9: _arnn(pitch=13),  # pitch up +15°
    10: _arnn(yaw=11),  # yaw −15°
    11: _arnn(yaw=13),  # yaw +15°
    12: _arnn(fn=1),  # use
    13: _arnn(fn=2),  # drop
    14: _arnn(fn=3),  # attack
    15: _arnn(fn=4),  # craft
    16: _arnn(fn=5),  # equip
    17: _arnn(fn=6),  # place
    18: _arnn(fn=7),  # destroy
}
_FN_ATTACK, _FN_CRAFT = 3, 4
_FN_WITH_ITEM_ARG = (5, 6, 7)  # equip / place / destroy


class MineDojoWrapper:
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
        **kwargs: Any,
    ):
        self._start_position = kwargs.get("start_position", None)
        break_speed = kwargs.pop("break_speed_multiplier", 100)
        if self._start_position is not None and not (
            pitch_limits[0] <= self._start_position["pitch"] <= pitch_limits[1]
        ):
            raise ValueError(
                f"Initial pitch {self._start_position['pitch']} outside the limits {pitch_limits}"
            )
        # a >1 break-speed multiplier already shortens digging; stickiness on
        # top of it would overshoot (upstream sheeprl's minedojo.py:74)
        self._sticky = MineDojoSticky(
            attack_for=0 if break_speed > 1 else sticky_attack, jump_for=sticky_jump
        )
        self._pitch = PitchTracker(limits=(float(pitch_limits[0]), float(pitch_limits[1])))

        # minedojo.make mutates the global task-spec table; restore it after
        task_specs_backup = copy.deepcopy(minedojo.tasks.ALL_TASKS_SPECS)
        self._env = minedojo.make(
            task_id=id,
            image_size=(height, width),
            world_seed=seed,
            fast_reset=True,
            break_speed_multiplier=break_speed,
            **kwargs,
        )
        minedojo.tasks.ALL_TASKS_SPECS = task_specs_backup

        self._slot_of_item: Dict[str, int] = {}  # item name -> first inventory slot
        self._slot_names: np.ndarray = np.array([])
        self._inventory_max = np.zeros(N_ALL_ITEMS, np.float32)
        self.action_space = spaces.MultiDiscrete(
            np.array([len(ACTION_MAP), len(ALL_CRAFT_SMELT_ITEMS), N_ALL_ITEMS])
        )
        self.observation_space = spaces.Dict(
            {
                "rgb": spaces.Box(0, 255, self._env.observation_space["rgb"].shape, np.uint8),
                "inventory": spaces.Box(0.0, np.inf, (N_ALL_ITEMS,), np.float32),
                "inventory_max": spaces.Box(0.0, np.inf, (N_ALL_ITEMS,), np.float32),
                "inventory_delta": spaces.Box(-np.inf, np.inf, (N_ALL_ITEMS,), np.float32),
                "equipment": spaces.Box(0.0, 1.0, (N_ALL_ITEMS,), np.int32),
                "life_stats": spaces.Box(0.0, np.array([20.0, 20.0, 300.0]), (3,), np.float32),
                "mask_action_type": spaces.Box(0, 1, (len(ACTION_MAP),), bool),
                "mask_equip_place": spaces.Box(0, 1, (N_ALL_ITEMS,), bool),
                "mask_destroy": spaces.Box(0, 1, (N_ALL_ITEMS,), bool),
                "mask_craft_smelt": spaces.Box(0, 1, (len(ALL_CRAFT_SMELT_ITEMS),), bool),
            }
        )
        self.render_mode = "rgb_array"
        self.observation_space.seed(seed)
        self.action_space.seed(seed)

    # ---- observation conversion -------------------------------------------------

    def _scan_inventory(self, inventory: Dict[str, Any]) -> np.ndarray:
        names = ["_".join(str(n).split(" ")) for n in inventory["name"].tolist()]
        self._slot_names = np.array(names)
        self._slot_of_item = {}
        for slot, name in enumerate(names):
            self._slot_of_item.setdefault(name, slot)
        counts = count_items(names, inventory["quantity"], ITEM_NAME_TO_ID, N_ALL_ITEMS)
        self._inventory_max = np.maximum(counts, self._inventory_max)
        return counts

    @staticmethod
    def _inventory_delta(delta: Dict[str, Any]) -> np.ndarray:
        out = np.zeros(N_ALL_ITEMS, np.float32)
        for names_key, qty_key, sign in (
            ("inc_name_by_craft", "inc_quantity_by_craft", 1.0),
            ("dec_name_by_craft", "dec_quantity_by_craft", -1.0),
            ("inc_name_by_other", "inc_quantity_by_other", 1.0),
            ("dec_name_by_other", "dec_quantity_by_other", -1.0),
        ):
            for name, qty in zip(delta[names_key], delta[qty_key]):
                out[ITEM_NAME_TO_ID["_".join(str(name).split(" "))]] += sign * float(qty)
        return out

    @staticmethod
    def _equipment_onehot(equipment: Dict[str, Any]) -> np.ndarray:
        onehot = np.zeros(N_ALL_ITEMS, np.int32)
        onehot[ITEM_NAME_TO_ID["_".join(str(equipment["name"][0]).split(" "))]] = 1
        return onehot

    def _masks(self, masks: Dict[str, Any]) -> Dict[str, np.ndarray]:
        # per-slot equip/destroy masks -> per-item-id masks
        equip_mask = np.zeros(N_ALL_ITEMS, bool)
        destroy_mask = np.zeros(N_ALL_ITEMS, bool)
        for name, can_equip, can_destroy in zip(self._slot_names, masks["equip"], masks["destroy"]):
            item_id = ITEM_NAME_TO_ID[name]
            equip_mask[item_id] |= bool(can_equip)
            destroy_mask[item_id] |= bool(can_destroy)
        action_type = masks["action_type"].copy()
        action_type[5:7] &= bool(equip_mask.any())  # equip/place need an equippable item
        action_type[7] &= bool(destroy_mask.any())
        return {
            # the 12 movement/camera action types are always legal
            "mask_action_type": np.concatenate((np.ones(12, bool), action_type[1:])),
            "mask_equip_place": equip_mask,
            "mask_destroy": destroy_mask,
            "mask_craft_smelt": np.asarray(masks["craft_smelt"], bool),
        }

    def _convert_obs(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {
            "rgb": obs["rgb"].copy(),
            "inventory": self._scan_inventory(obs["inventory"]),
            "inventory_max": self._inventory_max,
            "inventory_delta": self._inventory_delta(obs["delta_inv"]),
            "equipment": self._equipment_onehot(obs["equipment"]),
            "life_stats": np.concatenate(
                (obs["life_stats"]["life"], obs["life_stats"]["food"], obs["life_stats"]["oxygen"])
            ),
            **self._masks(obs["masks"]),
        }

    # ---- action conversion ------------------------------------------------------

    def _convert_action(self, action: np.ndarray) -> np.ndarray:
        arnn = ACTION_MAP[int(action[0])].copy()
        arnn = self._sticky.apply(arnn)
        arnn[6] = int(action[1]) if arnn[5] == _FN_CRAFT else 0
        # equip/place/destroy take the *slot* of the chosen item id
        if arnn[5] in _FN_WITH_ITEM_ARG:
            arnn[7] = self._slot_of_item[ITEM_ID_TO_NAME[int(action[2])]]
        else:
            arnn[7] = 0
        return arnn

    # ---- gym API ----------------------------------------------------------------

    @staticmethod
    def _location(obs: Dict[str, Any]) -> Dict[str, float]:
        pos = obs["location_stats"]["pos"]
        return {
            "x": float(pos[0]),
            "y": float(pos[1]),
            "z": float(pos[2]),
            "pitch": float(obs["location_stats"]["pitch"].item()),
            "yaw": float(obs["location_stats"]["yaw"].item()),
        }

    @staticmethod
    def _life(obs: Dict[str, Any]) -> Dict[str, float]:
        return {
            "life": float(obs["life_stats"]["life"].item()),
            "oxygen": float(obs["life_stats"]["oxygen"].item()),
            "food": float(obs["life_stats"]["food"].item()),
        }

    def step(self, action: np.ndarray) -> Tuple[Any, float, bool, bool, Dict[str, Any]]:
        arnn = self._convert_action(np.asarray(action))
        d_pitch, _ = self._pitch.apply((arnn[3] - 12) * 15.0, (arnn[4] - 12) * 15.0)
        if d_pitch == 0.0 and arnn[3] != 12:
            arnn[3] = 12  # camera veto: pitch would leave the limits

        obs, reward, done, info = self._env.step(arnn)
        out_of_time = bool(info.get("TimeLimit.truncated", False))
        loc = self._location(obs)
        self._pitch.pitch, self._pitch.yaw = loc["pitch"], loc["yaw"]
        info.update(
            {
                "life_stats": self._life(obs),
                "location_stats": loc,
                "action": np.asarray(action).tolist(),
                "biomeid": float(obs["location_stats"]["biome_id"].item()),
            }
        )
        return self._convert_obs(obs), float(reward), done and not out_of_time, done and out_of_time, info

    def reset(
        self, *, seed: Optional[int] = None, options: Optional[Dict[str, Any]] = None
    ) -> Tuple[Any, Dict[str, Any]]:
        obs = self._env.reset()
        loc = self._location(obs)
        self._sticky.reset()
        self._pitch.reset(pitch=loc["pitch"], yaw=loc["yaw"])
        self._inventory_max = np.zeros(N_ALL_ITEMS, np.float32)
        return self._convert_obs(obs), {
            "life_stats": self._life(obs),
            "location_stats": loc,
            "biomeid": float(obs["location_stats"]["biome_id"].item()),
        }

    def render(self) -> Optional[np.ndarray]:
        prev = self._env.unwrapped._prev_obs
        return None if prev is None else prev["rgb"]

    def close(self) -> None:
        self._env.close()
