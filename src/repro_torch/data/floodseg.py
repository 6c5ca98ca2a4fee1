"""Flood-ReasonSeg-proxy (host copy of ``repro/data/floodseg.py``, numpy
only): procedural flood scenes with NL-style queries and
exact segmentation masks (DESIGN.md §6 — stands in for the paper's ~100
curated flood images, which do not exist offline).

Scenes are 32x32x3 float images: a flood waterline with water texture
below, land/building texture above, rooftop slabs, and two target classes
mirroring the paper's dataset: PERSON (3x3 cross shape, warm colour,
often on rooftops) and VEHICLE (4x3 slab, cool colour, often partially
submerged). Queries come in ReasonSeg style:
  * Insight: "segment the stranded persons" -> GT mask of that class
  * Context: "are there any persons?"        -> yes/no answer token

Token language (vocab 64): fixed ids below; queries are 8-token sequences.
Photometric augmentation (brightness/contrast/noise jitter) mirrors the
paper's augmentation pipeline (§5.1.2).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

IMG = 32
PAD, BOS, EOS = 0, 1, 2
TOK_SEGMENT, TOK_ANY, TOK_COUNT = 3, 4, 5
TOK_PERSON, TOK_VEHICLE = 6, 7
ANS_NO, ANS_YES = 8, 9          # answer tokens (also used as labels)
ANS_COUNT0 = 10                 # ANS_COUNT0 + n for counts 0..4
QUERY_LEN = 8
VOCAB = 64

CLASSES = {"person": TOK_PERSON, "vehicle": TOK_VEHICLE}

INSIGHT_PROMPTS = {
    "person": "Highlight the stranded persons who may need rescue.",
    "vehicle": "Segment the vehicles stranded by floodwater.",
}
CONTEXT_PROMPTS = {
    "person": "Are there any persons in this sector?",
    "vehicle": "Are there any stranded vehicles?",
}


@dataclass
class Scene:
    image: np.ndarray            # (32, 32, 3) float32 in [0, 1]
    masks: Dict[str, np.ndarray]  # class -> (32, 32) bool
    counts: Dict[str, int]


def _texture(rng, h, w, base, jitter):
    return np.clip(base + rng.randn(h, w, 3) * jitter, 0, 1)


def generate_scene(rng: np.random.RandomState) -> Scene:
    img = np.zeros((IMG, IMG, 3), np.float32)
    waterline = rng.randint(10, 24)
    img[waterline:] = _texture(rng, IMG - waterline, IMG,
                               np.array([0.15, 0.3, 0.55]), 0.05)
    img[:waterline] = _texture(rng, waterline, IMG,
                               np.array([0.45, 0.4, 0.35]), 0.07)
    masks = {c: np.zeros((IMG, IMG), bool) for c in CLASSES}
    counts = {c: 0 for c in CLASSES}

    # rooftops (context structures, not targets)
    for _ in range(rng.randint(1, 4)):
        y = rng.randint(0, max(1, waterline - 5))
        x = rng.randint(0, IMG - 7)
        h, w = rng.randint(3, 6), rng.randint(5, 8)
        img[y:y + h, x:x + w] = _texture(rng, h, w,
                                         np.array([0.55, 0.55, 0.58]), 0.03)

    # vehicles: 4x3 slabs near/below the waterline (partially submerged)
    for _ in range(rng.randint(0, 4)):
        y = rng.randint(max(0, waterline - 3), IMG - 4)
        x = rng.randint(0, IMG - 5)
        col = np.array([0.2, 0.5, 0.7]) + rng.randn(3) * 0.08
        img[y:y + 3, x:x + 4] = np.clip(col, 0, 1)
        masks["vehicle"][y:y + 3, x:x + 4] = True
        counts["vehicle"] += 1

    # persons: 3x3 crosses, warm colour, often on rooftops / dry land
    for _ in range(rng.randint(0, 4)):
        y = rng.randint(1, IMG - 2)
        x = rng.randint(1, IMG - 2)
        col = np.clip(np.array([0.85, 0.35, 0.25]) + rng.randn(3) * 0.06, 0, 1)
        img[y, x - 1:x + 2] = col
        img[y - 1:y + 2, x] = col
        masks["person"][y, x - 1:x + 2] = True
        masks["person"][y - 1:y + 2, x] = True
        counts["person"] += 1

    return Scene(image=img, masks=masks, counts=counts)


def photometric_augment(rng: np.random.RandomState,
                        image: np.ndarray) -> np.ndarray:
    """Brightness/contrast/noise jitter (paper §5.1.2 augmentation)."""
    b = rng.uniform(-0.08, 0.08)
    c = rng.uniform(0.85, 1.15)
    noise = rng.randn(*image.shape) * 0.02
    return np.clip((image - 0.5) * c + 0.5 + b + noise, 0, 1).astype(np.float32)


def encode_query(kind: str, cls: str) -> np.ndarray:
    verb = {"segment": TOK_SEGMENT, "any": TOK_ANY, "count": TOK_COUNT}[kind]
    q = [BOS, verb, CLASSES[cls], EOS] + [PAD] * (QUERY_LEN - 4)
    return np.array(q, np.int32)


def make_batch(rng: np.random.RandomState, batch_size: int,
               kind: str = "segment", augment: bool = True,
               cls: Optional[str] = None) -> Dict[str, np.ndarray]:
    """kind: 'segment' (Insight) | 'any' | 'count' (Context)."""
    images, queries, masks, answers = [], [], [], []
    for _ in range(batch_size):
        scene = generate_scene(rng)
        c = cls or ("person" if rng.rand() < 0.5 else "vehicle")
        img = photometric_augment(rng, scene.image) if augment else scene.image
        images.append(img)
        queries.append(encode_query(kind, c))
        masks.append(scene.masks[c])
        if kind == "any":
            answers.append(ANS_YES if scene.counts[c] > 0 else ANS_NO)
        elif kind == "count":
            answers.append(ANS_COUNT0 + min(4, scene.counts[c]))
        else:
            answers.append(ANS_YES if scene.counts[c] > 0 else ANS_NO)
    return {
        "images": np.stack(images),
        "query": np.stack(queries),
        "mask": np.stack(masks),
        "answer": np.array(answers, np.int32),
    }


def train_val_streams(seed: int, batch_size: int,
                      kind: str = "segment"
                      ) -> Tuple[Iterator[Dict], Iterator[Dict]]:
    def stream(s, augment):
        rng = np.random.RandomState(s)
        while True:
            yield make_batch(rng, batch_size, kind=kind, augment=augment)
    return stream(seed, True), stream(seed + 10_000, False)
