"""Stand-in for the ``diambra`` namespace package (diambra 0.0.17 with
diambra-arena 2.2.x): see ``diambra.arena``."""
