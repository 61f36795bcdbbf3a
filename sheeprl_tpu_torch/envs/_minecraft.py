"""Host-side logic shared by the Minecraft-family adapters (MineRL,
MineDojo): counterpart of ``sheeprl_tpu/envs/_minecraft.py``.  The
sticky-action bookkeeping and the pitch clamping live once, as pure
dataclasses with no simulator dependency, so they are testable where
neither ``minerl`` nor ``minedojo`` is installed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

__all__ = ["StickyActions", "MineDojoSticky", "PitchTracker", "count_items"]


@dataclass
class StickyActions:
    """MineRL-style sticky attack/jump: repeat for a configurable number of
    steps after last selected, unconditionally (Hafner's Minecraft trick;
    upstream sheeprl's minerl.py:238-252).  A sticky attack suppresses jumping; the
    MineRL adapter additionally presses `forward` while a jump is sticky.

    `attack_for`/`jump_for` of 0 disables the respective stickiness.  The
    caller asks `update(attack=..., jump=...)` each step with the *selected*
    flags and receives the *effective* flags.
    """

    attack_for: int = 30
    jump_for: int = 10
    _attack_left: int = field(default=0, init=False)
    _jump_left: int = field(default=0, init=False)

    def update(self, attack: bool, jump: bool) -> Tuple[bool, bool]:
        if self.attack_for:
            if attack:
                self._attack_left = self.attack_for
            if self._attack_left > 0:
                attack = True
                jump = False
                self._attack_left -= 1
        if self.jump_for:
            if jump:
                self._jump_left = self.jump_for
            if self._jump_left > 0:
                jump = True
                self._jump_left -= 1
        return attack, jump

    def reset(self) -> None:
        self._attack_left = 0
        self._jump_left = 0


@dataclass
class MineDojoSticky:
    """MineDojo-style *cancelable* sticky attack/jump, operating on the
    converted 8-slot MineDojo action vector (upstream sheeprl's minedojo.py:184-215).

    Differences from the MineRL machine, preserved exactly:
    - selecting attack arms ``attack_for - 1`` *extra* repeats (the selection
      step itself is not counted down);
    - a pending sticky attack only fires on functional no-ops and is canceled
      by any other functional action; it does NOT suppress jumping;
    - a pending sticky jump only fires when no forward/backward was selected
      (pressing forward too when the agent is otherwise still) and is canceled
      when the agent picks sneak/sprint instead of jump.

    Vector slots: 0 forward/backward, 1 left/right, 2 jump/sneak/sprint
    (1 = jump), 5 functional (3 = attack).
    """

    attack_for: int = 30
    jump_for: int = 10
    _attack_left: int = field(default=0, init=False)
    _jump_left: int = field(default=0, init=False)

    def apply(self, vec: np.ndarray) -> np.ndarray:
        if self.attack_for:
            if vec[5] == 3:
                self._attack_left = self.attack_for - 1
            if self._attack_left > 0 and vec[5] == 0:
                vec[5] = 3
                self._attack_left -= 1
            elif vec[5] != 3:
                self._attack_left = 0
        if self.jump_for:
            if vec[2] == 1:
                self._jump_left = self.jump_for - 1
            if self._jump_left > 0 and vec[0] == 0:
                vec[2] = 1
                if vec[0] == 0 and vec[1] == 0:
                    vec[0] = 1
                self._jump_left -= 1
            elif vec[2] != 1:
                self._jump_left = 0
        return vec

    def reset(self) -> None:
        self._attack_left = 0
        self._jump_left = 0


@dataclass
class PitchTracker:
    """Track camera pitch/yaw and veto camera commands that would push the
    pitch outside `limits` (upstream sheeprl's minerl.py:293-299, minedojo.py:243-248).
    """

    limits: Tuple[float, float] = (-60.0, 60.0)
    pitch: float = field(default=0.0, init=False)
    yaw: float = field(default=0.0, init=False)

    def apply(self, d_pitch: float, d_yaw: float) -> Tuple[float, float]:
        """Returns the (possibly vetoed) camera delta actually allowed."""
        new_pitch = self.pitch + d_pitch
        if not (self.limits[0] <= new_pitch <= self.limits[1]):
            d_pitch = 0.0
            new_pitch = self.pitch
        self.pitch = new_pitch
        self.yaw = ((self.yaw + d_yaw) + 180.0) % 360.0 - 180.0
        return d_pitch, d_yaw

    def reset(self, pitch: float = 0.0, yaw: float = 0.0) -> None:
        self.pitch = pitch
        self.yaw = yaw


def count_items(
    names, quantities, name_to_id: Dict[str, int], size: int, air_counts_once: bool = True
) -> np.ndarray:
    """Turn an (item name, quantity) listing into a dense per-item count vector
    (the multihot inventory of upstream sheeprl's minerl.py:262-273 / minedojo.py:124-144).

    Minecraft reports every empty slot as one `air` item; with
    `air_counts_once` each air slot contributes 1 (as upstream sheeprl does).
    """
    counts = np.zeros(size, dtype=np.float32)
    for name, qty in zip(names, quantities):
        name = "_".join(str(name).split(" "))
        if name not in name_to_id:
            continue
        counts[name_to_id[name]] += 1.0 if (name == "air" and air_counts_once) else float(qty)
    return counts
