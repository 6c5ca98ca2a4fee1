"""Synthetic token streams for the generic-architecture training paths
(host copy of ``repro/data/lm.py``, numpy only: for one seed it gives the
reference's arrays bit for bit).

Zipf-distributed tokens with a deterministic short-range structure
(bigram coupling) so language-model training has learnable signal; plus
batch builders matching every modality's input contract
(``repro_torch/models/model.py``'s docstring). Batches are numpy arrays;
the caller moves them to the device.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Iterator

import numpy as np

if TYPE_CHECKING:   # the config module imports torch; this one stays host-only
    from repro_torch.models.config import ModelConfig


def zipf_tokens(rng: np.random.RandomState, shape, vocab: int,
                alpha: float = 1.2) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    flat = rng.choice(vocab, size=int(np.prod(shape)), p=probs)
    return flat.reshape(shape).astype(np.int32)


def lm_batch(rng: np.random.RandomState, cfg: ModelConfig, batch: int,
             seq: int) -> Dict[str, np.ndarray]:
    if cfg.modality == "audio":
        frames = rng.randn(batch, seq, cfg.frontend_dim).astype(np.float32)
        targets = zipf_tokens(rng, (batch, seq), cfg.vocab_size)
        # HuBERT-style span masking: ~8% starts, span 4
        mask = np.zeros((batch, seq), bool)
        starts = rng.rand(batch, seq) < 0.08
        for off in range(4):
            mask[:, off:] |= starts[:, :seq - off] if off else starts
        return {"frames": frames, "targets": targets, "mask_positions": mask}
    if cfg.modality == "vlm":
        tokens = zipf_tokens(rng, (batch, seq), cfg.vocab_size)
        nv = cfg.num_vision_tokens
        vis = rng.randn(batch, nv, cfg.frontend_dim).astype(np.float32)
        # M-RoPE position triples: vision tokens get (t=0, h, w) grid
        # positions; text continues with equal (t, h, w) ids.
        side = max(1, int(round(nv ** 0.5)))
        hpos = (np.arange(nv) // side).astype(np.int32)
        wpos = (np.arange(nv) % side).astype(np.int32)
        tpos = np.zeros(nv, np.int32)
        text = np.arange(seq - nv, dtype=np.int32) + side
        pos = np.stack([
            np.concatenate([tpos, text]),
            np.concatenate([hpos, text]),
            np.concatenate([wpos, text]),
        ])                                        # (3, S)
        pos = np.broadcast_to(pos[:, None, :], (3, batch, seq)).copy()
        return {"tokens": tokens, "vision_embeds": vis, "positions": pos}
    tokens = zipf_tokens(rng, (batch, seq), cfg.vocab_size)
    # inject learnable bigram structure: token 2k+1 follows 2k
    follow = rng.rand(batch, seq - 1) < 0.3
    tokens[:, 1:] = np.where(follow & (tokens[:, :-1] % 2 == 0),
                             np.minimum(tokens[:, :-1] + 1, cfg.vocab_size - 1),
                             tokens[:, 1:])
    return {"tokens": tokens}


def lm_stream(seed: int, cfg: ModelConfig, batch: int,
              seq: int) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.RandomState(seed)
    while True:
        yield lm_batch(rng, cfg, batch, seq)
