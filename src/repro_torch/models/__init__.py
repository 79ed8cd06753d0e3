"""Models of the port: the serving path (prefill + greedy decode) of the
dense, hybrid (RG-LRU + local attention) and Mamba-1 families.

Parameters are the JAX package's pytree as a plain dict of tensors (the same
names, shapes and dtypes), and every layer is a plain function over
``(config, params, activations)``, as in :mod:`repro.models`.
"""
