"""``minedojo.sim`` of the stand-in: the item vocabularies (a subset of
MineDojo 0.1's ``ALL_ITEMS`` and ``ALL_CRAFT_SMELT_ITEMS``, in its
snake_case spelling; the simulator reports names with spaces)."""
ALL_ITEMS = [
    "air", "dirt", "stone", "cobblestone", "log", "planks", "stick", "crafting_table", "wooden_pickaxe",
    "stone_pickaxe", "wooden_sword", "iron_ore", "iron_ingot", "coal", "furnace", "torch", "bucket",
    "milk_bucket", "water_bucket", "wheat", "diamond", "iron_pickaxe",
]
ALL_CRAFT_SMELT_ITEMS = [
    "planks", "stick", "crafting_table", "wooden_pickaxe", "stone_pickaxe", "wooden_sword", "furnace", "torch",
    "bucket", "iron_ingot", "iron_pickaxe",
]
