"""Compositional prompt suffix sampling (the port's own copy of
`adaface_tpu/data/compositions.py`, numpy only, unchanged in behavior).

An action/appearance fragment, then optional style / modifier / artist /
background / time / light / second-object clauses with the training vs
inference probabilities (train option p=[0.75,0.25], background
p=[0.4,0.6]; eval p=[0.3,0.7]). A fragment is a template string with
`{a|b|c}` choice groups, expanded uniformly per group.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

_CHOICE = re.compile(r"\{([^{}]*)\}")


def expand_template(template: str, rng: np.random.Generator) -> str:
    """Expand `{a|b|c}` groups by uniform choice; empty alternative allowed."""

    def repl(m):
        return rng.choice(m.group(1).split("|"))

    out = _CHOICE.sub(repl, template)
    return re.sub(r"\s+", " ", out).strip()


# actions only meaningful for humans/animals — alternatives match the
# reference banks (`compositions.py:5-35`) so the training-prompt
# distribution is identical
ANIMAL_ACTIONS = [
    "lifting a {rock|box|barbell|cat|dog}",
    "doing {makeup|housekeeping|gardening|exercise}",
    "carrying a {bag|backpack|luggage|laptop|book|briefcase|purse|suitcase"
    "|bouquet|baby|cat|dog|teddy bear}",
    "holding a {mobile phone|book|cup of water|piece of paper|flower|bouquet"
    "|pen|sign|cat|dog|teddy bear|baby|rock|leaf|mushroom|stick|fruit}",
    "{sitting|sleeping} {on a table|on a chair|on a bench|on a tank"
    "|in a wheelchair|on the ground|on flying cloud}",
    "swimming {in a pool|underwater|in the ocean|in a lake|in a river}"
    "{ among tropical fishes|}",
    "pushing a {door|table|car|wheelchair|stroller|shopping cart|bicycle"
    "|motorcycle|scooter}",
    "running {in a forest|at the beach|over forest leaves|on a trail"
    "|under the moon|on a treadmill}",
    "walking {in a forest|at the beach|over forest leaves|on a trail"
    "|under the moon|on a treadmill}",
    "throwing {a ball|a rock|water|a dart|a frisbee|a knife|a javelin}",
    "catching {a ball|an arrow|a butterfly|a fish|a leaf}",
    "kicking a {ball|bottle|tree|rock|punching bag|pole|box}",
    "playing {a card game|a video game|a piano|a violin|basketball|tennis}",
    "riding a {bike|motorcycle|scooter|horse|car|bus|train|boat}",
    "{kissing|hugging|holding} a {boy|girl|baby|lady|man|cat}",
    "dancing with a {boy|girl|lady|man|villager}",
    "standing {besides a friend|besides a tree|besides a car|in a river"
    "|on a table|on a stair|on a board|on a box}",
    "opening a {door|window|book|bottle|jar|box|envelope|bag|pouch|wallet"
    "|suitcase}",
    "pointing at {the sky|the sun|the beach|the mountains|the forest}",
    "looking at {a book|a mobile phone|the screen|the sky|the sun|the beach"
    "|a UFO|a painting|a clock|a mirror}",
    "drinking {a bottle of water|a cup of wine|beer|milk|a glass of juice"
    "|a cup of tea}",
    "eating {a sandwich|an ice cream|a pizza|a burger|pasta|cake|sushi|soup"
    "|tacos}",
]

ANIMAL_DRESSES = [
    "wearing a {tshirt|stormtrooper costume|superman costume|ironman armor"
    "|ski outfit|astronaut outfit|suit|baseball cap}",
    "wearing {a red hat|a santa hat|a rainbow scarf|a black top hat and a monocle"
    "|pink glasses|a yellow shirt|aikido uniform|green robe}",
    "in a {chef outfit|firefighter outfit|police outfit|purple wizard outfit"
    "|dress|suit|stormtrooper costume|superman costume}",
]

# usable for all subject types (objects included)
STATIC_ACTIONS = [
    "leaning {against a wall|against a tree|against a table|on a chair|on top of a car}",
    "flying {in the sky|under the sunset|in the outer space|over water|over a building}",
    "on {an airplane|a bus|a busy street|a grass|a roof|an escalator|a train}",
    "on {a boat|a bike|a roller coaster|a ski lift|a hot air balloon|a scooter}",
    "in {a car|a meeting|a class|a wedding|a dinner|a concert|a gym|a library|a park}",
    "in {a mall|a movie theater|a hotel room|Hong Kong|Tokyo|New York}",
    "at {a beach|a table|a park|a concert|a gym|a library|a mall|a movie theater"
    "|a hotel room|a theme park}",
    "next to {a friend|a tree|a car|a river|a lake|a mountain|an ocean"
    "|a playground|a statue|a panda}",
    "made of {metal|stainless steel|fractal flame|marble|rubber|bronze|ice}",
    # DreamBooth evaluation-set contexts
    "{in the jungle|in the snow|on a cobblestone street|floating on top of water"
    "|floating in an ocean of milk}",
    "on top of {pink fabric|a wooden floor|green grass with sunflowers around it"
    "|a mirror|the sidewalk in a crowded street|a dirt road|a white rug"
    "|a purple rug in a forest}",
]

STATIC_APPEARANCES = [
    "that is {red|purple|shiny|cube|wet}",
]

ALL_COMPOSITIONS = STATIC_ACTIONS + ANIMAL_ACTIONS + STATIC_APPEARANCES + ANIMAL_DRESSES
STATIC_COMPOSITIONS = STATIC_ACTIONS + STATIC_APPEARANCES

LOCATIONS = ["at the left", "at the right", "at the top", "at the bottom",
             "in the center", "in the middle", "at the upper left",
             "at the upper right", "at the lower left", "at the lower right",
             "in the background"]

COEXIST_OBJECTS = ["person", "man", "woman", "girl", "boy", "baby", "crowd",
                   "villager", "cat", "dog", "bird", "panda", "monkey",
                   "chimpanzee", "gorilla", "bear", "horse", "sheep",
                   "elephant", "lion"]

STYLES = ["cartoon style", "animation", "anime art", "comic book art",
          "steampunk art", "oil on canvas", "oil painting", "sci-fi movie",
          "sculpture", "bronze sculpture", "abyss art", "blade runner style",
          "cyberpunk art", "synthwave", "pencil sketch", "pastel colors",
          "childrens book's illustration", "pixar movie",
          "as a crochet figure", "as a 3d model", "closeup shot",
          "close view", "D&D sci-fi", "pop art", "portrait art",
          "watercolour painting", "chalk art", "concepture art",
          "bauhaus style", "photorealistic painting", "surrealism painting",
          "impressionism", "expressionism", "abstract art", "minimalism",
          "low poly", "cubism style"]

MODIFIERS = ["concept art", "realistic painting", "character design",
             "anime sketch", "trending in artstation", "hyper realistic",
             "vivid colors", "clear face", "detailed face", "semirealism",
             "hyperrealistic", "highly detailed", "octane render",
             "unreal 5", "photorealistic", "sharp focus", "digital painting",
             "illustration", "volumetric lighting", "dreamy", "cinematic",
             "surreal", "hd", "4k", "8k", "3d", "4d", "pixelate", "blur",
             "beautiful", "very beautiful", "symmetrical", "macabre",
             "at night"]

TIMES = ["futuristic", "modern", "ancient", "antique", "retro",
         "old-fashioned", "youthful"]

# "natural light" listed twice like the reference (`compositions.py:106-108`)
# — doubled sampling weight
LIGHTS = ["daylight", "moonlight", "night sky", "natural light",
          "front light", "backlight", "soft light", "hard light",
          "moody light", "dramatic light", "dynamic light", "natural light"]

# Deliberate deviation: the reference's `all_art_by` names living artists;
# generic descriptors keep the same clause structure without emulating
# specific people. (The clause fires with the same probability.)
ARTISTS = ["a fantasy illustrator", "a studio portrait photographer",
           "an anime background studio", "a classical oil painter",
           "a children's book artist", "a big animation studio"]

BACKGROUNDS = ["a beach", "a table", "a park", "a concert", "a gym",
               "a library", "a mall", "a movie theater", "a hotel room",
               "a theme park", "a city", "a mountain", "a blue house",
               "a wheat field", "a tree and autumn leaves",
               "the Eiffel Tower", "a jungle", "the snow",
               "a cobblestone street", "underwater", "an ocean of milk",
               "pink fabric", "a wooden floor",
               "green grass with sunflowers around it", "a mirror",
               "the sidewalk in a crowded street", "a dirt road",
               "a white rug", "a purple rug in a forest", "a red cube",
               "a purple cube", "a building"]


def sample_compositions(n: int, subj_type: str, is_training: bool = False,
                        rng: Optional[np.random.Generator] = None) -> List[str]:
    """n composition suffixes. subj_type: 'animal' (humans/animals: full
    bank + chance of a second object) or 'object' (static bank only)."""
    rng = rng or np.random.default_rng()
    if subj_type == "animal":
        bank = ALL_COMPOSITIONS
    elif subj_type == "object":
        bank = STATIC_COMPOSITIONS
    else:
        raise ValueError(f"unknown subject type {subj_type!r}")

    if is_training:
        option_probs = [0.75, 0.25]
        background_probs = [0.4, 0.6]
    else:
        option_probs = [0.3, 0.7]
        background_probs = option_probs

    out = []
    for _ in range(n):
        composition = expand_template(bank[rng.integers(len(bank))], rng)

        if subj_type == "animal" and rng.random() < 0.3:
            obj_loc2 = (", a " + rng.choice(COEXIST_OBJECTS) + " "
                        + rng.choice(LOCATIONS))
        else:
            obj_loc2 = ""

        def clause(items, prefix, joiner=", ", max_n=1, probs=option_probs):
            if rng.choice([0, 1], p=probs):
                k = int(rng.integers(1, max_n + 1))
                picked = rng.choice(items, size=k, replace=False)
                return prefix + joiner.join(picked)
            return ""

        style = clause(STYLES, ", in ", " and ", 2)
        style = style + " style" if style else ""
        modifier = clause(MODIFIERS, ", ", ", ", 3)
        art_by = clause(ARTISTS, ", art by ", " and ", 2)
        background = clause(BACKGROUNDS, ", with ", max_n=1,
                            probs=background_probs)
        background = background + " as background" if background else ""
        time = clause(TIMES, ", ")
        light = ", with " + rng.choice(LIGHTS)  # always on (reference `:222`)

        if is_training:
            comp = f"{composition}{modifier}{time}{style}{background}{art_by}{light}{obj_loc2}"
        else:
            image = ", " + rng.choice(["photo", "drawing", "illustration", "picture"])
            comp = (f"{modifier}{time}{style}{image} of z {composition}"
                    f"{background}{art_by}{light}{obj_loc2}")
            if comp.startswith(", "):
                comp = comp[2:]
        out.append(comp)
    return out
