"""Synthetic LM data pipeline (offline container).

Counterpart of ``repro.data.lm_data``: the same numpy code, so the same seed
gives the same tokens and stub embeddings in both packages.

Deterministic Zipfian token stream with short-range structure (bigram copy
tendencies) so LM training loss visibly decreases; enough for e2e drivers and
convergence smoke tests. Also hosts the modality stubs: precomputed frame /
patch embeddings for the audio and vlm architectures (the one allowed stub).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


def token_batches(cfg: ModelConfig, *, batch: int, seq_len: int, seed: int = 0
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of {"tokens": [B, S]} (+ "memory" for audio/vlm)."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    # Zipf-ish unigram with a copy process: p(repeat prev token) = 0.3.
    probs = 1.0 / np.arange(1, v + 1) ** 1.1
    probs /= probs.sum()
    while True:
        base = rng.choice(v, size=(batch, seq_len), p=probs)
        copy = rng.random((batch, seq_len)) < 0.3
        tokens = base.copy()
        tokens[:, 1:][copy[:, 1:]] = tokens[:, :-1][copy[:, 1:]]
        out: Dict[str, np.ndarray] = {"tokens": tokens.astype(np.int32)}
        mem = memory_stub(cfg, batch, rng=rng)
        if mem is not None:
            out["memory"] = mem
        yield out


def memory_stub(cfg: ModelConfig, batch: int, *, rng: Optional[np.random.Generator] = None
                ) -> Optional[np.ndarray]:
    """Precomputed modality embeddings (STUB frontends — see DESIGN.md).

    audio: conv/mel frame embeddings [B, encoder_seq, d_model];
    vlm: projected patch embeddings [B, num_image_tokens, d_model].
    """
    rng = rng or np.random.default_rng(0)
    if cfg.is_encdec:
        shape = (batch, cfg.encoder_seq, cfg.d_model)
    elif cfg.cross_attn_interval:
        shape = (batch, cfg.num_image_tokens, cfg.d_model)
    else:
        return None
    return rng.normal(0.0, 1.0, size=shape).astype(np.float32)
