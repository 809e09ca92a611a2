from .buffers import EnvIndependentReplayBuffer, EpisodeBuffer, ReplayBuffer, SequentialReplayBuffer
from .memmap import MemmapArray

__all__ = ["EnvIndependentReplayBuffer", "EpisodeBuffer", "MemmapArray", "ReplayBuffer", "SequentialReplayBuffer"]
