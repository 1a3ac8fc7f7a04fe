"""hymba-1.5b [hybrid]: parallel attention + mamba heads per layer; mostly
sliding-window attention with sparse global layers. [arXiv:2411.13676]"""
from repro_torch.models.config import ModelConfig

ID = "hymba-1.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="hybrid", num_layers=32, d_model=1600, num_heads=25,
        num_kv_heads=5, d_ff=5504, vocab_size=32001,
        ssm_state=16, ssm_expand=2,
        # periodic 1 global : 15 local (the paper's 3 global layers adapted to
        # the scan-friendly period-16 pattern; noted in DESIGN.md)
        window_pattern=((0,) + (1024,) * 15) * 2,
        source="[arXiv:2411.13676]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="hybrid", num_layers=2, d_model=100,
        num_heads=5, num_kv_heads=1, d_ff=256, vocab_size=512,
        ssm_state=8, ssm_expand=2, window_pattern=(0, 64), dtype="float32",
        remat=False, source="[arXiv:2411.13676]",
    )
