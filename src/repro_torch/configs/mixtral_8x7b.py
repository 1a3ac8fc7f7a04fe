"""mixtral-8x7b [moe]: 8 experts top-2, sliding-window attention. [arXiv:2401.04088]"""
from repro_torch.models.config import ModelConfig

ID = "mixtral-8x7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="moe", num_layers=32, d_model=4096, num_heads=32,
        num_kv_heads=8, d_ff=14336, vocab_size=32000,
        num_experts=8, experts_per_token=2,
        window_pattern=(4096,) * 32,        # SWA on every layer
        rope_theta=1e6, source="[arXiv:2401.04088]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="moe", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512,
        num_experts=4, experts_per_token=2, window_pattern=(64,) * 2,
        capacity_factor=2.0,  # drop-free for top-2-of-4: exact prefill/forward parity
        dtype="float32", remat=False, source="[arXiv:2401.04088]",
    )
