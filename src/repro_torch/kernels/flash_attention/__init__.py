"""Forward flash attention (causal / sliding window, GQA): the CUDA kernel,
its launch wrapper and its plain PyTorch versions."""
