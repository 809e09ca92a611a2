from .compose import CONFIG_ROOT, compose, load_config_file, save_config
from .container import Config, resolve_interpolations
from .instantiate import instantiate, locate

__all__ = [
    "Config", "compose", "instantiate", "locate", "resolve_interpolations", "CONFIG_ROOT", "load_config_file",
    "save_config",
]
