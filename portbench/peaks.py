"""Published peaks of one NVIDIA H100 SXM5 80 GB (NVIDIA data sheet, dense
rates without sparsity, at its 700 W power limit)."""

TF32_FLOPS = 495e12   # dense TF32 on the tensor cores: the card's highest f32-input rate
BF16_FLOPS = 989e12   # dense bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
