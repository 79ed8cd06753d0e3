"""Mamba-1 selective scan: the CUDA kernel, its launch wrapper and its plain
PyTorch version."""
