"""``minerl.herobraine.hero`` of the stand-in: ``handler``, ``handlers``,
``mc`` and ``spaces``."""
from . import handler, handlers, mc, spaces  # noqa: F401
