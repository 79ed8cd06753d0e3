"""The plain reference of the benchmark's models: straightforward float32
PyTorch (TF32 off), one file per family, written from the equations of the
model the configuration file states.  It imports nothing of the program or of
JAX and takes nothing the program made: the harness hands it the same
parameter tensors and token ids it hands the program.

``precision="fp8"`` runs every weight product with both operands rounded to
float8 (e4m3 forward, e5m2 gradients, one scale per row / column): the
control that a comparison has to fail.
"""
