"""``nes_py.wrappers.JoypadSpace`` (nes_py 8.2.1): a discrete action space
over lists of button names, each mapped to one controller byte; its
``reset()`` takes no arguments, as nes_py's does."""
import gym


class JoypadSpace(gym.Wrapper):
    _button_map = {"right": 0b10000000, "left": 0b01000000, "down": 0b00100000, "up": 0b00010000,
                   "start": 0b00001000, "select": 0b00000100, "B": 0b00000010, "A": 0b00000001, "NOOP": 0b00000000}

    def __init__(self, env, actions):
        super().__init__(env)
        self.action_space = gym.spaces.Discrete(len(actions))
        self._action_map = {}
        self._action_meanings = {}
        for action, button_list in enumerate(actions):
            byte_action = 0
            for button in button_list:
                byte_action |= self._button_map[button]
            self._action_map[action] = byte_action
            self._action_meanings[action] = " ".join(button_list)

    def step(self, action):
        return self.env.step(self._action_map[action])

    def reset(self):
        return self.env.reset()

    def get_action_meanings(self):
        return [self._action_meanings[a] for a in self._action_meanings]
