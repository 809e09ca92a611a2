"""``minerl.herobraine.hero.handler.Handler`` (MineRL 0.4.4): a mission-XML
fragment with ``to_string`` and ``xml_template``; the stand-in keeps the
arguments it was made with."""


class Handler:
    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs

    def to_string(self) -> str:
        return type(self).__name__

    def xml_template(self) -> str:
        return ""
