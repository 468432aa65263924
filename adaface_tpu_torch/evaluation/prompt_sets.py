"""Evaluation prompt sets + `get_prompt_list` (the port's copy of
`adaface_tpu/evaluation/prompt_sets.py`, which mirrors the reference's
`evaluation/eval_utils.py:499-580` + `community_prompts.py`).
The DreamBench object/animal templates are the standard DreamBooth-paper
benchmark lists (public benchmark data, reproduced for metric parity). The
'community' set in the reference is a hand-picked grab-bag of style-heavy
prompts; here it's our own bank with the same role (challenge prompts with
style/context modifiers) and comparable size/coverage.

Template slots: {0}=z_prefix ("face portrait of"...), {1}=subject token(s),
{2}=z_suffix + background suffix — same slot contract as the reference so
prompt files stay interchangeable.
"""

from __future__ import annotations

from typing import List, Tuple

# DreamBooth benchmark — object prompts (`eval_utils.py:504-530`)
OBJECT_PROMPTS = [
    "a {0} {1}{2} in the jungle",
    "a {0} {1}{2} in the snow",
    "a {0} {1}{2} on the beach",
    "a {0} {1}{2} on a cobblestone street",
    "a {0} {1}{2} on top of pink fabric",
    "a {0} {1}{2} on top of a wooden floor",
    "a {0} {1}{2} with a city in the background",
    "a {0} {1}{2} with a mountain in the background",
    "a {0} {1}{2} with a blue house in the background",
    "a {0} {1}{2} on top of a purple rug in a forest",
    "a {0} {1}{2} with a wheat field in the background",
    "a {0} {1}{2} with a tree and autumn leaves in the background",
    "a {0} {1}{2} with the Eiffel Tower in the background",
    "a {0} {1}{2} floating on top of water",
    "a {0} {1}{2} floating in an ocean of milk",
    "a {0} {1}{2} on top of green grass with sunflowers around it",
    "a {0} {1}{2} on top of a mirror",
    "a {0} {1}{2} on top of the sidewalk in a crowded street",
    "a {0} {1}{2} on top of a dirt road",
    "a {0} {1}{2} on top of a white rug",
    "a {0} red {1}{2}",
    "a {0} purple {1}{2}",
    "a {0} shiny {1}{2}",
    "a {0} wet {1}{2}",
    "a {0} cube shaped {1}{2}",
]

# DreamBooth benchmark — live-subject prompts (`eval_utils.py:534-557`;
# drops the two floor/rug layouts that break for humans/animals)
ANIMAL_PROMPTS = [
    "a {0} {1}{2} in the jungle",
    "a {0} {1}{2} in the snow",
    "a {0} {1}{2} on the beach",
    "a {0} {1}{2} on a cobblestone street",
    "a {0} {1}{2} on top of pink fabric",
    "a {0} {1}{2} with a city in the background",
    "a {0} {1}{2} with a mountain in the background",
    "a {0} {1}{2} with a blue house in the background",
    "a {0} {1}{2} wearing a red hat",
    "a {0} {1}{2} wearing a santa hat",
    "a {0} {1}{2} wearing a rainbow scarf",
    "a {0} {1}{2} wearing a black top hat and a monocle",
    "a {0} {1}{2} in a chef outfit",
    "a {0} {1}{2} in a firefighter outfit",
    "a {0} {1}{2} in a police outfit",
    "a {0} {1}{2} wearing pink glasses",
    "a {0} {1}{2} wearing a yellow shirt",
    "a {0} {1}{2} in a purple wizard outfit",
    "a {0} red {1}{2}",
    "a {0} purple {1}{2}",
    "a {0} shiny {1}{2}",
    "a {0} wet {1}{2}",
]

# Challenge prompts with heavy style/context modifiers — same role as the
# reference's community set (`community_prompts.py`), our own bank.
COMMUNITY_PROMPTS = [
    "{0} {1}{2} as a medieval knight in ornate armor, castle courtyard, "
    "cinematic lighting, highly detailed, 8k",
    "{0} {1}{2} underwater among coral reefs and tropical fish, "
    "volumetric light rays, underwater photography",
    "{0} {1}{2} in a red robe walking through a spice market, clear face, "
    "warm golden hour light, travel photography",
    "{0} {1}{2} smelling a rose in a garden full of flowers, "
    "digital painting, concept art, sharp focus",
    "{0} {1}{2} in a green satin robe with gold embroidery, autumn leaves "
    "falling, dramatic volumetric lighting, concept art",
    "anime key visual of {0} {1}{2}, clear face, cloudy sky, lush "
    "landscape, sharp focus",
    "cute {0} {1}{2} reading in a cozy library, warm indoor lighting, "
    "detailed digital painting, cinematic",
    "{0} {1}{2} posing with a tabby cat, character design, "
    "realistic painting, trending digital art",
    "{0} {1}{2} flying in a superhero costume above a city, cute face",
    "{0} {1}{2} having a cup of coffee at a sidewalk cafe",
    "{0} {1}{2} surfing a big wave, clear face, action photography",
    "astronaut {0} {1}{2} floating in outer space, earth in background",
    "{0} {1}{2} as a wizard with hat and staff, fantasy, hdr, "
    "cinematic shot",
    "{0} {1}{2} as a jedi holding a lightsaber, dramatic dark moody "
    "lighting, concept art",
    "{0} {1}{2} in a plumber costume jumping over a pipe, video game "
    "concept art",
    "{0} {1}{2} wearing futuristic powered armor, glowing reactor, "
    "studio lighting",
    "{0} {1}{2} in a desert stillsuit, rocky dunes, from a sci-fi epic, "
    "closeup",
    "{0} {1}{2} wearing a blue silk robe with floral embroidery, clear "
    "face, fashion photography, high resolution",
    "{0} {1}{2} wearing a jeweled suit with gemstone wings and a glass "
    "crown, fashion editorial, high resolution",
    "cyberpunk {0} {1}{2} in a neon-lit street at night, face portrait, "
    "clear face, photorealistic background",
    "a cute {0} {1}{2} half submerged in a mirror-calm lake, reflections, "
    "depth of field, film grain, 105mm f1.4",
    "a crochet figure of {0} {1}{2}",
    "a marble sculpture of {0} {1}{2}",
]

# Short hard-prompt bank in the spirit of `evaluation/freeu_prompts.py`:
# dense multi-attribute scenes that stress prompt adherence.
FREEU_PROMPTS = [
    "{0} {1}{2} in a teddy bear costume on a skateboard in times square",
    "{0} {1}{2} as an astronaut riding a horse on the moon, photorealistic",
    "{0} {1}{2} piloting a wooden biplane over snow-capped mountains",
    "{0} {1}{2} playing a grand piano on a beach at sunset, waves crashing",
    "{0} {1}{2} juggling glowing orbs in a misty bamboo forest",
    "{0} {1}{2} ice skating on a frozen lake under the aurora borealis",
    "{0} {1}{2} baking bread in a rustic kitchen, flour dust in the air",
    "{0} {1}{2} conducting an orchestra of robots in a concert hall",
]


def get_prompt_list(subject_string: str, z_prefix: str, z_suffix: str,
                    background_string: str, class_token: str,
                    class_long_token: str, broad_class: int,
                    set_name: str = "all") -> Tuple[List[str], List[str], List[str]]:
    """(subject prompts, class-short prompts, class-long prompts) —
    `eval_utils.py:499-580`. broad_class: 0=object, 1=human/animal,
    2=cartoon. set_name: 'dreambench' | 'community' | 'all'."""
    if broad_class in (1, 2):
        if set_name == "community":
            base = COMMUNITY_PROMPTS
        elif set_name == "dreambench":
            base = ANIMAL_PROMPTS
        elif set_name == "all":
            base = ANIMAL_PROMPTS + COMMUNITY_PROMPTS
        else:
            raise ValueError(set_name)
    else:
        base = OBJECT_PROMPTS

    z_suffix = z_suffix + background_string
    subj = [p.format(z_prefix, subject_string, z_suffix) for p in base]
    cls_short = [p.format(z_prefix, class_token, z_suffix) for p in base]
    cls_long = [p.format(z_prefix, class_long_token, z_suffix) for p in base]
    return subj, cls_short, cls_long
