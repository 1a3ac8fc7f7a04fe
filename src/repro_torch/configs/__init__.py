"""Architecture registry: the 10 assigned architectures + input shapes.

Counterpart of ``repro.configs`` (copies of its pure-data modules). Every
config loads; only ``arch_type == "dense"`` builds a model in this package so
far (``models.transformer.init_model`` raises for the other families).

``get_config(arch_id, variant)`` with variant "full" | "smoke".
``INPUT_SHAPES`` are the four assigned (seq_len, global_batch, kind) tuples.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "hymba-1.5b": "repro_torch.configs.hymba_1_5b",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

ARCH_IDS = tuple(_MODULES)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def get_config(arch_id: str, variant: str = "full", **overrides) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    cfg = getattr(mod, variant)()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def cut_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    """The first ``layers`` layers of ``cfg``, its per-layer window and block
    patterns cut with it (a multiple of a pattern's period keeps its mix)."""
    if not 0 < layers <= cfg.num_layers:
        raise ValueError(f"{cfg.name} has {cfg.num_layers} layers; cannot keep {layers}")
    return dataclasses.replace(cfg, num_layers=layers,
                               window_pattern=cfg.window_pattern[:layers],
                               block_pattern=cfg.block_pattern[:layers])


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k only for sub-quadratic archs (full-attn skips -> DESIGN.md)."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic and not cfg.is_encdec
    return True
