"""The 51 concept categories of the NEURONS multi-label classification task
and the key-object discovery priority/background lists (a copy of
neurons_tpu/data/categories.py, which the port does not import)."""

CLS_DICT = {
    0: "animal", 1: "human", 2: "vehicle", 3: "building", 4: "clothing",
    5: "weapon", 6: "plant", 7: "appliance", 8: "tool", 9: "container",
    10: "body part", 11: "furniture", 12: "device", 13: "fabric",
    14: "fruit", 15: "vegetable", 16: "insect", 17: "landscape feature",
    18: "water body", 19: "organism", 20: "fish", 21: "reptile",
    22: "mammal", 23: "accessory", 24: "sports equipment", 25: "food",
    26: "drink", 27: "light source", 28: "weather phenomenon", 29: "jewelry",
    30: "musical instrument", 31: "structure", 32: "flying vehicle",
    33: "toy", 34: "kitchen item", 35: "writing tool", 36: "gardening tool",
    37: "scientific equipment", 38: "furniture accessory", 39: "roadway",
    40: "weaponry accessory", 41: "sports field", 42: "money",
    43: "timekeeping device", 44: "decoration", 45: "art", 46: "stationery",
    47: "kitchen appliance", 48: "rock/mineral", 49: "soil/substrate",
    50: "climate/atmosphere component",
}

NUM_CLASSES = len(CLS_DICT)

# Key-object discovery: categories given a 2x displacement-score boost
# (animals/people move and matter; reference find_key_obj.py priority list)
PRIORITY_CATEGORIES = {
    "human", "animal", "mammal", "fish", "insect", "reptile", "organism",
}

# Categories never selected as the key object (scene/background semantics)
BACKGROUND_CATEGORIES = {
    "landscape feature", "water body", "weather phenomenon", "roadway",
    "soil/substrate", "climate/atmosphere component", "structure",
    "building", "sports field",
}
