"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit).  A share is stated against these
with the card's power limit printed beside it."""

#: bf16 / fp16 tensor-core operations per second.
BF16_TENSOR_FLOPS = 989e12
#: float32 operations per second outside the tensor cores.
F32_FLOPS = 67e12
#: HBM3 bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Device memory in bytes.
HBM_BYTES = 80e9
