"""The action lists of gym-super-mario-bros 7.4.0 (``actions.py``)."""
RIGHT_ONLY = [["NOOP"], ["right"], ["right", "A"], ["right", "B"], ["right", "A", "B"]]
SIMPLE_MOVEMENT = [["NOOP"], ["right"], ["right", "A"], ["right", "B"], ["right", "A", "B"], ["A"], ["left"]]
COMPLEX_MOVEMENT = [["NOOP"], ["right"], ["right", "A"], ["right", "B"], ["right", "A", "B"], ["A"], ["left"],
                    ["left", "A"], ["left", "B"], ["left", "A", "B"], ["down"], ["up"]]
