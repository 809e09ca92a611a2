"""``minerl.herobraine`` of the stand-in: ``env_spec.EnvSpec`` and ``hero``."""
