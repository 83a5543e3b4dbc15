"""The datasets' class lists, their per-class text descriptions and the
anomaly-prompt grammar: the port's own copy of what the prompts need from
the JAX package's ``aaclip_tpu/data/registry.py``.

The strings must match the reference byte for byte: they decide the text
anchors and therefore the published metrics (reference
dataset/constants.py:1-148). ``tests/test_torch_text.py`` holds them to
the JAX package's tokens for every dataset.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# dataset -> {class_name: description}, in the reference's class order
REAL_NAMES: Dict[str, Dict[str, str]] = {
    "Brain": {"Brain": "scan"},
    "Liver": {"Liver": "scan"},
    "Retina": {"Retina": "scan"},
    "Colon_clinicDB": {"Colon_clinicDB": "colon endoscopy image"},
    "Colon_colonDB": {"Colon_colonDB": "colon endoscopy image"},
    "Colon_cvc300": {"CVC-300": "colon endoscopy image"},
    "Colon_Kvasir": {"Kvasir": "colon endoscopy image"},
    "MVTec": {
        "bottle": "dark bottle",
        "cable": "top view of three cables",
        "capsule": "black and orange capsule",
        "carpet": "gray carpet",
        "grid": "metal or plastic mesh",
        "hazelnut": "single brown hazelnut",
        "leather": "brown leather",
        "metal_nut": "metal nut which has four notched edges",
        "pill": "oval white pill with small red speckles and the letters 'FF' engraved",
        "screw": "screw",
        "tile": "speckled tile surface",
        "transistor": "a three-legged transistor placed vertically",
        "toothbrush": "toothbrush head",
        "wood": "wood surface",
        "zipper": "a black zipper",
    },
    "VisA": {
        "candle": "candle",
        "pcb3": "infrared sensor pcb module",
        "capsules": "capsules",
        "pipe_fryum": "pipe-shaped fryum",
        "pcb4": "battery charging pcb module",
        "macaroni2": "scattered yellow macaroni",
        "pcb2": "integrated circuits board",
        "chewinggum": "chewing gum",
        "macaroni1": "orange macaroni",
        "cashew": "cashew nut",
        "fryum": "wheel-shaped fryum snack",
        "pcb1": "dual ultrasonic distance sensor pcb module",
    },
    "MPDD": {
        "connector": "metal clamps with black adjustment knobs",
        "tubes": "scattered metal objects",
        "metal_plate": "blue rectangular metal plate with a notch on one side",
        "bracket_white": "white, elongated triangular metal bracket with a smooth, matte finish",
        "bracket_brown": "brown L-shaped metal bracket with smooth, glossy finish and multiple mounting holes along its arms",
        "bracket_black": "black ornamental metal bracket with spiral design attached to a rectangular frame",
    },
    "BTAD": {
        "01": "Bright concentric rings in neon yellow and blue tones against a dark blue background, resembling a stylized wave or energy field radiating outward.",
        "02": "vertical fabric lines in warm, dusty pink and beige tones",
        "03": "oval concentric circular rings in gradient shades of blue and white",
    },
}

# MVTec's list keeps the reference's order, which is not alphabetical past
# "metal_nut"
CLASS_NAMES: Dict[str, List[str]] = {d: list(names)
                                     for d, names in REAL_NAMES.items()}

# Anomaly-prompt grammar (reference dataset/constants.py:135-148):
# 3 normal states x 2 templates = 6 normal sentences,
# 5 abnormal states x 2 templates = 10 abnormal sentences.
NORMAL_STATES: Tuple[str, ...] = ("{}", "a {}", "the {}")
ABNORMAL_STATES: Tuple[str, ...] = (
    "a damaged {}",
    "a broken {}",
    "a {} with flaw",
    "a {} with defect",
    "a {} with damage",
)
TEMPLATES: Tuple[str, ...] = ("{}.", "a photo of {}.")


def build_prompts(real_name: str) -> Tuple[List[str], List[str]]:
    """(normal_sentences, abnormal_sentences) for one class description."""
    normal = [t.format(s.format(real_name)) for s in NORMAL_STATES
              for t in TEMPLATES]
    abnormal = [t.format(s.format(real_name)) for s in ABNORMAL_STATES
                for t in TEMPLATES]
    return normal, abnormal


def resolve_real_name(dataset_name: str, class_name: str) -> str:
    if class_name == "object":
        return class_name
    names = REAL_NAMES[dataset_name]
    if class_name not in names:
        raise KeyError(f"class_name {class_name} not found; available: "
                       f"{list(names)}")
    return names[class_name]
