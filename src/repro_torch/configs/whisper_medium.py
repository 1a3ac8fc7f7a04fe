"""whisper-medium [audio]: enc-dec; conv/mel frontend is a STUB — input_specs
supplies precomputed frame embeddings [B, 1500, d_model]. [arXiv:2212.04356]"""
from repro_torch.models.config import ModelConfig

ID = "whisper-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="audio", num_layers=24, d_model=1024, num_heads=16,
        num_kv_heads=16, d_ff=4096, vocab_size=51865,
        encoder_layers=24, encoder_seq=1500, max_target_positions=448,
        norm_kind="layernorm", act="gelu", use_bias=True,
        source="[arXiv:2212.04356]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="audio", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512,
        encoder_layers=2, encoder_seq=32, max_target_positions=64,
        norm_kind="layernorm", act="gelu", use_bias=True, dtype="float32",
        remat=False, source="[arXiv:2212.04356]",
    )
