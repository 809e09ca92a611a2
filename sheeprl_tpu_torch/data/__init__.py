from .buffers import EnvIndependentReplayBuffer, ReplayBuffer, SequentialReplayBuffer

__all__ = ["EnvIndependentReplayBuffer", "ReplayBuffer", "SequentialReplayBuffer"]
