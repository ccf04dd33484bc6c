"""PyTorch and CUDA port of the truly sparse SET-MLP system (``repro``).

The JAX package ``repro`` is the reference; every module here has a twin
at the same path there. The port imports ``torch``, never ``jax`` and
nothing of ``repro``. Hand-written CUDA kernels live in ``csrc/``.
"""
