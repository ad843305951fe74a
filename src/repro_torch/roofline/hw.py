"""NVIDIA H100 SXM5 80GB constants: the card the port runs on.

The reference's ``hw.py`` holds TPU v5e's; these take their places, each
beside the datasheet line it comes from.  ``MXU_DIM`` (the TPU's 128-wide
systolic tile) has no counterpart: the H100's tensor cores take warpgroup
MMA shapes that the kernels choose per call (``kernels/posit_matmul.py``'s
``matmul_plan``), so no one tile edge describes the card.
"""

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 column: BF16 tensor core
# 1979 TFLOP/s with sparsity, 989 TFLOP/s dense
PEAK_BF16_FLOPS = 989e12
# the same datasheet: FP32 67 TFLOP/s (the CUDA cores)
PEAK_F32_FLOPS = 67e12
# the same datasheet: GPU memory 80 GB, bandwidth 3.35 TB/s
HBM_BW = 3.35e12
HBM_BYTES = 80e9
# NVIDIA H100 (Hopper) architecture whitepaper: up to 228 KB of shared
# memory per SM, of which one thread block may take 227 KB
SMEM_BYTES = 227 * 1024
# The slowest link of a 256- or 512-device mesh: it spans 32 (64)
# eight-GPU nodes, joined by one 400 Gb/s NDR InfiniBand port a GPU
# (the NVIDIA DGX H100 system documentation: eight ConnectX-7 400 Gb/s
# ports), 50e9 B/s each way.  The reference's ``ICI_LINK_BW`` is its
# counterpart.
IB_NDR_LINK_BW = 50e9
# For reference: NVLink 4 within a node, 900 GB/s a GPU in all (datasheet),
# 450e9 B/s each way
NVLINK4_BW = 450e9
