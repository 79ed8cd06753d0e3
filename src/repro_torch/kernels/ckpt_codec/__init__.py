"""int8 block quantization of checkpoint leaves: the CUDA kernel, its launch
wrapper and its plain PyTorch version."""
