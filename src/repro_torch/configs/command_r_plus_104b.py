"""command-r-plus-104b [dense]: GQA, no-bias, 256k vocab. [hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig

ID = "command-r-plus-104b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="dense", num_layers=64, d_model=12288, num_heads=96,
        num_kv_heads=8, d_ff=33792, vocab_size=256000,
        norm_kind="layernorm", rope_theta=75e6, use_bias=False,
        source="[hf:CohereForAI/c4ai-command-r-v01]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="dense", num_layers=2, d_model=192,
        num_heads=6, num_kv_heads=2, d_ff=384, vocab_size=512,
        norm_kind="layernorm", dtype="float32", remat=False,
        source="[hf:CohereForAI/c4ai-command-r-v01]",
    )
