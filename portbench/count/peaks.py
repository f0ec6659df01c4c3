"""Frozen peaks of one NVIDIA H100 SXM (data sheet; dense rates, no
sparsity; at the full 700 W power limit, which the run line states beside
every share)."""

#: bf16 and fp16 tensor-core operations a second.
BF16_FLOPS = 989e12
#: HBM3 bytes a second.
HBM_BYTES = 3.35e12
