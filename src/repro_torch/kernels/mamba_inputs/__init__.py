"""The Mamba-1 scan's inputs dtA and dBx: the CUDA kernel that forms them in
one pass, its launch wrapper and its plain PyTorch version."""
