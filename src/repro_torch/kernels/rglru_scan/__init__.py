"""RG-LRU scan (RecurrentGemma): the CUDA kernel, its launch wrapper and its
plain PyTorch version."""
