"""Preemption-safe training: the RunGuard, the cooperative preemption drain,
asynchronous checkpoint writes and the resume manifest."""
