"""Custom MineRL (herobraine) task specs, Navigate and Obtain variants:
counterpart of ``sheeprl_tpu/envs/minerl_envs/specs.py``.

The per-task differences (observables, actionables, reward schedule, quit
conditions, world generation) are declarative class attributes on one spec
base.  Shared behaviors:
  * a ``BreakSpeedMultiplier`` agent-start handler (faster digging);
  * time limits are handled outside the simulator (max_episode_steps=None),
    because MineRL cannot tell terminated from truncated: the port's
    ``TimeLimit`` wrapper in ``make_env`` does it instead;
  * the simple-embodiment keyboard action set and the camera.
Importing the module raises ``ModuleNotFoundError`` where ``minerl`` is
missing.
"""

from __future__ import annotations

from abc import ABC
from typing import Any, Dict, List, Optional, Sequence

from sheeprl_tpu_torch.utils.imports import _IS_MINERL_AVAILABLE

if not _IS_MINERL_AVAILABLE:
    raise ModuleNotFoundError("No module named 'minerl'")

from minerl.herobraine.env_spec import EnvSpec  # noqa: E402
from minerl.herobraine.hero import handler, handlers  # noqa: E402
from minerl.herobraine.hero.mc import INVERSE_KEYMAP  # noqa: E402

KEYBOARD_ACTIONS = ("forward", "back", "left", "right", "jump", "sneak", "sprint", "attack")
NONE = "none"

# The item hierarchy toward a diamond, with the standard MineRL milestone
# rewards.  ObtainIronPickaxe uses the same ladder truncated before diamond.
DIAMOND_REWARD_LADDER: List[Dict[str, Any]] = [
    {"type": "log", "amount": 1, "reward": 1},
    {"type": "planks", "amount": 1, "reward": 2},
    {"type": "stick", "amount": 1, "reward": 4},
    {"type": "crafting_table", "amount": 1, "reward": 4},
    {"type": "wooden_pickaxe", "amount": 1, "reward": 8},
    {"type": "cobblestone", "amount": 1, "reward": 16},
    {"type": "furnace", "amount": 1, "reward": 32},
    {"type": "stone_pickaxe", "amount": 1, "reward": 32},
    {"type": "iron_ore", "amount": 1, "reward": 64},
    {"type": "iron_ingot", "amount": 1, "reward": 128},
    {"type": "iron_pickaxe", "amount": 1, "reward": 256},
    {"type": "diamond", "amount": 1, "reward": 1024},
]

OBTAIN_INVENTORY_ITEMS = (
    "dirt", "coal", "torch", "log", "planks", "stick", "crafting_table",
    "wooden_axe", "wooden_pickaxe", "stone", "cobblestone", "furnace",
    "stone_axe", "stone_pickaxe", "iron_ore", "iron_ingot", "iron_axe", "iron_pickaxe",
)  # fmt: skip
TOOL_ITEMS = (
    "wooden_axe", "wooden_pickaxe", "stone_axe", "stone_pickaxe", "iron_axe", "iron_pickaxe",
)  # fmt: skip


class BreakSpeedMultiplier(handler.Handler):
    """Malmo agent-start flag that scales block-breaking speed."""

    def __init__(self, multiplier: float = 1.0):
        self.multiplier = multiplier

    def to_string(self) -> str:
        return f"break_speed({self.multiplier})"

    def xml_template(self) -> str:
        return "<BreakSpeedMultiplier>{{multiplier}}</BreakSpeedMultiplier>"


class _SimpleEmbodimentSpec(EnvSpec, ABC):
    """Shared base: POV + location + life-stats observables, keyboard+camera
    actions, break-speed agent start."""

    def __init__(self, name: str, *args, resolution=(64, 64), break_speed: float = 100, **kwargs):
        self.resolution = resolution
        self.break_speed = break_speed
        super().__init__(name, *args, **kwargs)

    def create_agent_start(self) -> List[handler.Handler]:
        return [BreakSpeedMultiplier(self.break_speed)]

    def create_observables(self) -> List[handler.Handler]:
        return [
            handlers.POVObservation(self.resolution),
            handlers.ObservationFromCurrentLocation(),
            handlers.ObservationFromLifeStats(),
        ]

    def create_actionables(self) -> List[handler.Handler]:
        keyboard = [
            handlers.KeybasedCommandAction(key, value)
            for key, value in INVERSE_KEYMAP.items()
            if key in KEYBOARD_ACTIONS
        ]
        return keyboard + [handlers.CameraAction()]

    def create_monitors(self) -> List[handler.Handler]:
        return []

    def create_server_quit_producers(self) -> List[handler.Handler]:
        return [handlers.ServerQuitWhenAnyAgentFinishes()]

    def get_docstring(self) -> str:
        return self.__class__.__doc__ or ""


class CustomNavigate(_SimpleEmbodimentSpec):
    """Reach a diamond block ~64 m away guided by a compass observation.

    `dense` adds per-block progress reward; `extreme` spawns in extreme-hills
    terrain.  +100 on touching the goal block, which also ends the episode.
    """

    def __init__(self, dense: bool, extreme: bool, *args, **kwargs):
        self.dense, self.extreme = dense, extreme
        name = "CustomMineRLNavigate{}{}-v0".format("Extreme" if extreme else "", "Dense" if dense else "")
        kwargs.pop("max_episode_steps", None)  # TimeLimit lives outside the sim
        super().__init__(name, *args, max_episode_steps=None, **kwargs)

    def is_from_folder(self, folder: str) -> bool:
        return folder == ("navigateextreme" if self.extreme else "navigate")

    def create_observables(self) -> List[handler.Handler]:
        return super().create_observables() + [
            handlers.CompassObservation(angle=True, distance=False),
            handlers.FlatInventoryObservation(["dirt"]),
        ]

    def create_actionables(self) -> List[handler.Handler]:
        place_dirt = handlers.PlaceBlock([NONE, "dirt"], _other=NONE, _default=NONE)
        return super().create_actionables() + [place_dirt]

    def create_rewardables(self) -> List[handler.Handler]:
        goal = handlers.RewardForTouchingBlockType(
            [{"type": "diamond_block", "behaviour": "onceOnly", "reward": 100.0}]
        )
        if self.dense:
            return [goal, handlers.RewardForDistanceTraveledToCompassTarget(reward_per_block=1.0)]
        return [goal]

    def create_agent_start(self) -> List[handler.Handler]:
        compass = handlers.SimpleInventoryAgentStart([{"type": "compass", "quantity": "1"}])
        return super().create_agent_start() + [compass]

    def create_agent_handlers(self) -> List[handler.Handler]:
        return [handlers.AgentQuitFromTouchingBlockType(["diamond_block"])]

    def create_server_world_generators(self) -> List[handler.Handler]:
        if self.extreme:
            return [handlers.BiomeGenerator(biome=3, force_reset=True)]
        return [handlers.DefaultWorldGenerator(force_reset=True)]

    def create_server_decorators(self) -> List[handler.Handler]:
        return [
            handlers.NavigationDecorator(
                max_randomized_radius=64,
                min_randomized_radius=64,
                block="diamond_block",
                placement="surface",
                max_radius=8,
                min_radius=0,
                max_randomized_distance=8,
                min_randomized_distance=0,
                randomize_compass_location=True,
            )
        ]

    def create_server_initial_conditions(self) -> List[handler.Handler]:
        return [
            handlers.TimeInitialCondition(allow_passage_of_time=False, start_time=6000),
            handlers.WeatherInitialCondition("clear"),
            handlers.SpawningInitialCondition("false"),
        ]

    def determine_success_from_rewards(self, rewards: Sequence[float]) -> bool:
        return sum(rewards) >= (160.0 if self.dense else 100.0)


class _CustomObtain(_SimpleEmbodimentSpec):
    """Shared machinery for the Obtain* tasks: crafting/smelting/placing
    action handlers, the obtain inventory view, and a milestone reward ladder
    (each rung rewarded once, or on every collection when `dense`)."""

    target_item: str = ""
    quit_handler_factory = staticmethod(
        lambda: [handlers.AgentQuitFromPossessingItem([{"type": "diamond", "amount": 1}])]
    )

    def __init__(self, dense: bool, *args, reward_schedule: Optional[List[Dict[str, Any]]] = None, **kwargs):
        self.dense = dense
        self.reward_schedule = reward_schedule or [{"type": self.target_item, "amount": 1, "reward": 1}]
        camel = "".join(part.capitalize() for part in self.target_item.split("_"))
        name = "CustomMineRLObtain{}{}-v0".format(camel, "Dense" if dense else "")
        kwargs.pop("max_episode_steps", None)
        super().__init__(name, *args, max_episode_steps=None, **kwargs)

    def is_from_folder(self, folder: str) -> bool:
        return folder == f"o_{self.target_item}"

    def create_observables(self) -> List[handler.Handler]:
        return super().create_observables() + [
            handlers.FlatInventoryObservation(list(OBTAIN_INVENTORY_ITEMS)),
            handlers.EquippedItemObservation(
                items=["air", *TOOL_ITEMS, "other"], _default="air", _other="other"
            ),
        ]

    def create_actionables(self) -> List[handler.Handler]:
        return super().create_actionables() + [
            handlers.PlaceBlock(
                [NONE, "dirt", "stone", "cobblestone", "crafting_table", "furnace", "torch"],
                _other=NONE,
                _default=NONE,
            ),
            handlers.EquipAction([NONE, "air", *TOOL_ITEMS], _other=NONE, _default=NONE),
            handlers.CraftAction([NONE, "torch", "stick", "planks", "crafting_table"], _other=NONE, _default=NONE),
            handlers.CraftNearbyAction([NONE, *TOOL_ITEMS, "furnace"], _other=NONE, _default=NONE),
            handlers.SmeltItemNearby([NONE, "iron_ingot", "coal"], _other=NONE, _default=NONE),
        ]

    def create_rewardables(self) -> List[handler.Handler]:
        reward_cls = handlers.RewardForCollectingItems if self.dense else handlers.RewardForCollectingItemsOnce
        return [reward_cls(self.reward_schedule)]

    def create_agent_handlers(self) -> List[handler.Handler]:
        return self.quit_handler_factory()

    def create_server_world_generators(self) -> List[handler.Handler]:
        return [handlers.DefaultWorldGenerator(force_reset=True)]

    def create_server_decorators(self) -> List[handler.Handler]:
        return []

    def create_server_initial_conditions(self) -> List[handler.Handler]:
        return [
            handlers.TimeInitialCondition(start_time=6000, allow_passage_of_time=True),
            handlers.SpawningInitialCondition(allow_spawning=True),
        ]

    def determine_success_from_rewards(self, rewards: Sequence[float]) -> bool:
        # success = hit (almost) every rung of the ladder; 10% slack
        ladder = {rung["reward"] for rung in self.reward_schedule}
        misses_allowed = round(len(self.reward_schedule) * 0.1)
        return len(ladder.intersection(set(rewards))) >= len(ladder) - misses_allowed


class CustomObtainDiamond(_CustomObtain):
    """Obtain a diamond from scratch; episode ends on success."""

    target_item = "diamond"

    def __init__(self, dense: bool, *args, **kwargs):
        super().__init__(dense, *args, reward_schedule=list(DIAMOND_REWARD_LADDER), **kwargs)


class CustomObtainIronPickaxe(_CustomObtain):
    """Obtain (craft) an iron pickaxe; episode ends on crafting it."""

    target_item = "iron_pickaxe"
    quit_handler_factory = staticmethod(
        lambda: [handlers.AgentQuitFromCraftingItem([{"type": "iron_pickaxe", "amount": 1}])]
    )

    def __init__(self, dense: bool, *args, **kwargs):
        super().__init__(dense, *args, reward_schedule=DIAMOND_REWARD_LADDER[:-1], **kwargs)
