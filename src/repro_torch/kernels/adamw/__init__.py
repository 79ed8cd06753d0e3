"""AdamW's update of a leaf and a gradient's sum of squares: the CUDA kernels,
their launch wrapper and their plain PyTorch versions."""
