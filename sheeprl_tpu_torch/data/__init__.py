from .buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer
from .memmap import MemmapArray

__all__ = ["EnvIndependentReplayBuffer", "MemmapArray", "ReplayBuffer", "SequentialReplayBuffer"]
