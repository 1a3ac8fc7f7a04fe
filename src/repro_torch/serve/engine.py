"""Batched serving engine: prefill once, decode greedily or by sampling.

Counterpart of ``repro.serve.engine``. Requests share one prompt length;
generation is ``prefill`` followed by a Python loop of ``decode_step`` (the
reference's ``lax.scan``), all under ``torch.inference_mode``. A vlm
config's image memory goes into the cache at prefill; an audio
(encoder-decoder) config's frames are encoded once at prefill, and the
encoder's output goes into the cache. Sampling
draws from an explicit ``torch.Generator``, so its tokens differ from the
reference's ``jax.random`` stream; greedy tokens do not.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.models import decoding
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class ServeEngine:
    model: Transformer
    max_len: int = 256

    @property
    def device(self) -> torch.device:
        return self.model.embed.tokens.device

    @torch.inference_mode()
    def prefill(self, prompts, memory=None) -> Tuple[torch.Tensor, decoding.Cache]:
        """prompts [B, S] (numpy or tensor) -> (last logits [B, V] f32, cache).
        ``memory``: image embeddings [B, T, d] for a vlm config, or audio
        frames [B, T, d] for an encoder-decoder config (numpy or tensor),
        moved to the device in their own dtype."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        if memory is not None:
            memory = torch.as_tensor(memory, device=self.device)
        return decoding.prefill(self.model, tokens, max_len=self.max_len, memory=memory)

    @torch.inference_mode()
    def decode(self, cache: decoding.Cache, logits: torch.Tensor, *, steps: int,
               temperature: float = 0.0, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """Tokens [B, steps]. The first fed token is the argmax of the prefill
        ``logits``; each step feeds back its own choice. ``cache`` is updated
        in place."""
        if cache["pos"] + steps > self.max_len:
            raise ValueError(f"{cache['pos']} + {steps} tokens exceed max_len "
                             f"{self.max_len}: raise max_len")
        if temperature > 0 and generator is None:
            raise ValueError("sampling (temperature > 0) needs a torch.Generator")
        token = torch.argmax(logits, dim=-1)[:, None]
        out = []
        for _ in range(steps):
            logits, cache = decoding.decode_step(self.model, cache, token)
            if temperature > 0:
                probs = torch.softmax(logits / temperature, dim=-1)
                token = torch.multinomial(probs, 1, generator=generator)
            else:
                token = torch.argmax(logits, dim=-1)[:, None]
            out.append(token)
        return torch.cat(out, dim=1)

    def generate(self, prompts: np.ndarray, *, steps: int = 32, temperature: float = 0.0,
                 memory: Optional[np.ndarray] = None, seed: int = 0) -> np.ndarray:
        """prompts: [B, S] int -> generated tokens [B, steps] (numpy int32);
        ``memory`` as in ``prefill``."""
        if prompts.shape[1] + steps > self.max_len:
            raise ValueError("prompt + steps exceed max_len: raise max_len")
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        logits, cache = self.prefill(prompts, memory)
        out = self.decode(cache, logits, steps=steps, temperature=temperature,
                          generator=gen)
        return out.cpu().numpy().astype(np.int32)
