"""``minerl.herobraine.hero.handlers.translation.TranslationHandler``: a
handler that contributes a space (an observation or an action)."""
from ..handler import Handler


class TranslationHandler(Handler):
    key = None

    def space(self):
        raise NotImplementedError
