"""gemma3-12b [dense]: 5:1 local:global attention, 128k context. [hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig

ID = "gemma3-12b"
_LOCAL = 1024  # sliding window of the local layers


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="dense", num_layers=48, d_model=3840, num_heads=16,
        num_kv_heads=8, d_ff=15360, vocab_size=262144,
        window_pattern=((_LOCAL,) * 5 + (0,)) * 8,   # 5 local : 1 global
        tie_embeddings=True, qk_norm=True, rope_theta=1e6,
        source="[hf:google/gemma-3-1b-pt]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="dense", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        window_pattern=(64, 0), tie_embeddings=True, qk_norm=True,
        dtype="float32", remat=False, source="[hf:google/gemma-3-1b-pt]",
    )
