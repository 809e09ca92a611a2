"""Device placement of the player and the learner."""

from .placement import ParamMirror, make_param_mirror, player_device

__all__ = ["ParamMirror", "make_param_mirror", "player_device"]
