"""repro_torch: the §VII checkpointing-scheme study on PyTorch and CUDA.

The PyTorch port of :mod:`repro`'s simulation main path.  It keeps
``repro``'s layout and names (``core``, ``engine``, ``kernels``, ``obs``) so
each module's counterpart is easy to find, but it imports neither ``jax`` nor
any ``repro`` module: what it needs of the NumPy host code it keeps as its
own copy.

Entry points run on the GPU unless the caller passes ``device="cpu"``, and
they raise when no GPU is present instead of carrying on on the CPU::

    from repro_torch.engine import BID_LIMITED_SCHEMES, Scenario, run

    sc = Scenario.grid(work_s=24 * 3600.0, bids=[0.5, 0.55], schemes=BID_LIMITED_SCHEMES,
                       seeds=(0,), bid_fractions=True)
    res = run(sc)                  # the hand-written CUDA sweep kernel
    res = run(sc, device="cpu")    # the plain PyTorch version, on the CPU
"""
