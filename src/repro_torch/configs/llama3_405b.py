"""llama3-405b [dense]: GQA, 128k vocab-ish embedding table. [arXiv:2407.21783]"""
from repro_torch.models.config import ModelConfig

ID = "llama3-405b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="dense", num_layers=126, d_model=16384,
        num_heads=128, num_kv_heads=8, d_ff=53248, vocab_size=128256,
        rope_theta=5e5, source="[arXiv:2407.21783]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="dense", num_layers=2, d_model=256,
        num_heads=8, num_kv_heads=2, d_ff=512, vocab_size=512,
        dtype="float32", remat=False, source="[arXiv:2407.21783]",
    )
