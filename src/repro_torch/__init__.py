"""PyTorch/CUDA port of the SpreadFGL system.

Counterpart of the JAX package ``repro``: every module here carries the name
of the reference module it ports. The package imports ``torch`` and never
``jax``; its hot kernels are hand-written CUDA for Hopper (``kernels/csrc``),
and every entry point runs on the CUDA device unless the caller asks for the
CPU, where the kernels' plain PyTorch versions run instead.
"""
