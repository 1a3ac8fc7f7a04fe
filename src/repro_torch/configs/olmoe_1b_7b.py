"""olmoe-1b-7b [moe]: 64 experts top-8. [arXiv:2409.02060]"""
from repro_torch.models.config import ModelConfig

ID = "olmoe-1b-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="moe", num_layers=16, d_model=2048, num_heads=16,
        num_kv_heads=16, d_ff=1024, vocab_size=50304,
        num_experts=64, experts_per_token=8, qk_norm=True,
        source="[arXiv:2409.02060]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="moe", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=512,
        num_experts=4, experts_per_token=2, qk_norm=True, capacity_factor=2.0,
        dtype="float32", remat=False, source="[arXiv:2409.02060]",
    )
