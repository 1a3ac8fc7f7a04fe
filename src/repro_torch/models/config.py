"""Model configuration covering all six assigned architecture families.

Counterpart of ``repro.models.config`` (a copy; this package imports nothing
of the reference). ``attention_impl`` is gone: the tensors' device chooses the
attention implementation (``kernels.ops.mha``). ``remat`` is honoured in
training: ``transformer.forward`` recomputes each layer group in the backward
pass (``torch.utils.checkpoint``). ``scan_layers`` is carried so that the
configs read the same; the port runs its layers one by one and ignores it.
``seq_parallel_activations`` changes only the dry-run's collectives
(``roofline.analysis``): the port runs no sequence-parallel program.

One frozen dataclass describes dense / MoE / SSM / hybrid / VLM / audio
(enc-dec) transformers. Per-layer heterogeneity (local vs global attention,
cross-attention insertion, mLSTM vs sLSTM) is encoded as data so homogeneous
stacks can be scanned:

- ``window_pattern``: per-layer sliding-window size, 0 = global attention.
  Carried into the scan as a traced per-layer array.
- ``cross_attn_interval``: VLM-style cross-attention block after every Nth
  self-attention layer (a separate stacked parameter group).
- ``block_pattern``: per-layer mixer kind for ssm/hybrid families.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 => d_model // num_heads

    # Attention details.
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q/k
    window_pattern: Tuple[int, ...] = ()  # per-layer window; () => all global
    rope_theta: float = 10000.0
    use_bias: bool = False
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"                # silu (gated) | gelu (ungated)
    logit_softcap: float = 0.0

    # MoE.
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25

    # SSM / xLSTM / hybrid.
    ssm_state: int = 0               # mamba state size (hymba)
    ssm_expand: int = 2
    block_pattern: Tuple[str, ...] = ()  # per-layer: attn|parallel|mlstm|slstm

    # VLM.
    cross_attn_interval: int = 0     # every Nth layer gets a cross-attn block
    num_image_tokens: int = 0

    # Audio / encoder-decoder.
    encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frame embeddings (stub frontend)
    max_target_positions: int = 0    # learned positional table size (whisper)

    # Numerics / implementation.
    seq_parallel_activations: bool = False  # shard residual-stream seq dim on
                                            # 'model' at layer boundaries
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True
    source: str = ""                 # citation ([arXiv:...] / [hf:...])

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.window_pattern and len(self.window_pattern) != self.num_layers:
            raise ValueError("window_pattern must have num_layers entries")
        if self.block_pattern and len(self.block_pattern) != self.num_layers:
            raise ValueError("block_pattern must have num_layers entries")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must divide evenly into kv groups")

    # -- derived properties ---------------------------------------------------

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def windows(self) -> Tuple[int, ...]:
        return self.window_pattern or (0,) * self.num_layers

    @property
    def max_window(self) -> int:
        """Largest finite window; 0 if any layer is global."""
        ws = self.windows
        return 0 if any(w == 0 for w in ws) else max(ws)

    @property
    def sub_quadratic(self) -> bool:
        """True if serve-state is o(seq²) compute AND o(seq) full-attn cache is
        avoided on every layer (long_500k eligibility)."""
        if self.arch_type in ("ssm",):
            return True
        if self.arch_type == "hybrid":
            return True  # attention heads are windowed (see hymba config)
        ws = self.windows
        if all(w > 0 for w in ws):
            return True  # every layer sliding-window (mixtral)
        # Mostly-local patterns (gemma3 5:1) are acceptable: decode is O(seq)
        # only on the sparse global layers.
        global_frac = sum(1 for w in ws if w == 0) / max(len(ws), 1)
        return global_frac <= 0.25

    def active_params(self) -> int:
        """Approximate active parameter count (MoE counts top-k experts)."""
        d, ff, v, l = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim
        attn = d * hq + 2 * d * hkv + hq * d
        if self.act == "silu":
            mlp_dense = 3 * d * ff
        else:
            mlp_dense = 2 * d * ff
        if self.is_moe:
            mlp = self.experts_per_token * mlp_dense + d * self.num_experts
        else:
            mlp = mlp_dense
        if self.arch_type == "ssm":
            attn, mlp = 0, 0
            for kind in (self.block_pattern or ("mlstm",) * l):
                di = self.ssm_expand * d
                if kind == "mlstm":
                    attn += 4 * d * di + di * d
                else:
                    attn += 8 * d * d
            body = attn
        else:
            body = l * (attn + mlp)
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encdec:
            enc = self.encoder_layers * (4 * d * d + mlp_dense)
            body += l * (2 * d * d + hq * d)  # decoder cross-attn blocks
        if self.cross_attn_interval:
            n_cross = self.num_layers // self.cross_attn_interval
            body += n_cross * (d * hq + 2 * d * hkv + hq * d)
        return body + emb + enc

    def total_params(self) -> int:
        if not self.is_moe:
            return self.active_params()
        d, ff, l = self.d_model, self.d_ff, self.num_layers
        mlp_dense = 3 * d * ff if self.act == "silu" else 2 * d * ff
        per_layer_delta = (self.num_experts - self.experts_per_token) * mlp_dense
        return self.active_params() + l * per_layer_delta
