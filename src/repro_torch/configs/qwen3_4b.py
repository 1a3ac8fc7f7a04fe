"""qwen3-4b [dense]: qk_norm, GQA. [hf:Qwen/Qwen3-8B]"""
from repro_torch.models.config import ModelConfig

ID = "qwen3-4b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="dense", num_layers=36, d_model=2560, num_heads=32,
        num_kv_heads=8, d_ff=9728, vocab_size=151936,
        qk_norm=True, tie_embeddings=True, rope_theta=1e6,
        source="[hf:Qwen/Qwen3-8B]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        qk_norm=True, tie_embeddings=True, dtype="float32", remat=False,
        source="[hf:Qwen/Qwen3-8B]",
    )
