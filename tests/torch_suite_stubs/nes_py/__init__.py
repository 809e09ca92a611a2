"""Stand-in for nes_py 8.2.1 (``nes_py.NESEnv``, ``nes_py.wrappers``).

Mirrors: ``NESEnv`` as a legacy ``gym.Env`` with a ``Box(0, 255, (240,
256, 3), uint8)`` observation space and ``Discrete(256)`` (one controller
byte) action space; ``reset(seed=None, options=None, return_info=None)``
returns the frame; ``step(byte)`` returns ``(frame, reward, done, info)``;
``render(mode="human")`` returns the frame for ``mode="rgb_array"``. The
emulation is the subclass's (``gym_super_mario_bros``'s stand-in).
"""
import gym
import numpy as np

__version__ = "8.2.1-stand-in"
SCREEN_SHAPE_24_BIT = (240, 256, 3)


class NESEnv(gym.Env):
    metadata = {"render.modes": ["rgb_array", "human"], "video.frames_per_second": 60}
    observation_space = gym.spaces.Box(0, 255, SCREEN_SHAPE_24_BIT, np.uint8)
    action_space = gym.spaces.Discrete(256)

    def render(self, mode="human"):
        if mode == "rgb_array":
            return self.screen
        return None
