"""``minerl.herobraine.hero.mc`` of the stand-in: ``ALL_ITEMS`` (a subset of
MineRL 0.4.4's, holding every item the custom tasks name) and
``INVERSE_KEYMAP``."""
ALL_ITEMS = [
    "air", "dirt", "stone", "cobblestone", "log", "planks", "stick", "crafting_table", "wooden_axe",
    "wooden_pickaxe", "stone_axe", "stone_pickaxe", "iron_ore", "iron_ingot", "iron_axe", "iron_pickaxe",
    "coal", "torch", "furnace", "diamond", "compass", "diamond_block", "sand", "gravel",
]
INVERSE_KEYMAP = {
    "forward": "key.keyboard.w", "back": "key.keyboard.s", "left": "key.keyboard.a", "right": "key.keyboard.d",
    "jump": "key.keyboard.space", "sneak": "key.keyboard.left.shift", "sprint": "key.keyboard.left.control",
    "attack": "key.mouse.left", "use": "key.mouse.right", "drop": "key.keyboard.q",
    "inventory": "key.keyboard.e", "swapHands": "key.keyboard.f",
}
