"""NVIDIA H100 SXM5 80 GB constants, per card, for the port's roofline model.

Counterpart of ``repro.roofline.hw``, whose constants are a TPU v5e's; none of
those appear here. The card's rates are NVIDIA's H100 data sheet (SXM part,
dense, at its 700 W power limit); the fabric is that of an HGX H100 node
(eight cards joined by NVLink through NVSwitch) in a DGX H100 cluster (one
ConnectX-7 InfiniBand NDR adapter per card).
"""

NAME = "NVIDIA H100 SXM5 80GB (700 W)"

PEAK_FLOPS_BF16 = 989e12     # dense bf16 on the tensor cores, FLOP/s (data sheet)
PEAK_FLOPS_TF32 = 495e12     # dense TF32 on the tensor cores, FLOP/s (data sheet)
PEAK_FLOPS_F32 = 67e12       # float32 on the CUDA cores, FLOP/s (data sheet)
HBM_BW = 3.35e12             # HBM3, bytes/s (data sheet)
HBM_BYTES = 80e9             # HBM3 capacity, bytes (data sheet)

NVLINK_BW = 450e9            # NVLink 4 among a node's 8 cards, bytes/s each way (900 GB/s total)
IB_BW = 50e9                 # InfiniBand NDR, 400 Gb/s each way per card (DGX H100)

GPUS_PER_NODE = 8            # HGX H100
CHIPS_SINGLE_POD = 256
CHIPS_MULTI_POD = 512
