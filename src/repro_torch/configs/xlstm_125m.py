"""xlstm-125m [ssm]: mLSTM + sLSTM blocks (≈5:1). [arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig

ID = "xlstm-125m"


def _pattern(n, slstm_at=(3, 9)):
    return tuple("slstm" if i in slstm_at else "mlstm" for i in range(n))


def full() -> ModelConfig:
    return ModelConfig(
        name=ID, arch_type="ssm", num_layers=12, d_model=768, num_heads=4,
        num_kv_heads=4, d_ff=0, vocab_size=50304,
        block_pattern=_pattern(12), ssm_expand=2, tie_embeddings=True,
        source="[arXiv:2405.04517]",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ID + "-smoke", arch_type="ssm", num_layers=2, d_model=128,
        num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=512,
        block_pattern=("mlstm", "slstm"), ssm_expand=2, tie_embeddings=True,
        dtype="float32", remat=False, source="[arXiv:2405.04517]",
    )
