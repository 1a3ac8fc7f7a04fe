"""llama-3.2-vision-11b [vlm]: gated cross-attn image layers every 5th layer.
Vision frontend (ViT + projector) is a STUB: input_specs supplies precomputed
projected patch embeddings [B, num_image_tokens, d_model]. [hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.models.config import ModelConfig

ID = "llama-3.2-vision-11b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="vlm", num_layers=40, d_model=4096, num_heads=32,
        num_kv_heads=8, d_ff=14336, vocab_size=128256,
        cross_attn_interval=5, num_image_tokens=1024, rope_theta=5e5,
        source="[hf:meta-llama/Llama-3.2-11B-Vision]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="vlm", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        cross_attn_interval=2, num_image_tokens=16, dtype="float32",
        remat=False, source="[hf:meta-llama/Llama-3.2-11B-Vision]",
    )
