"""PyTorch/CUDA port of the CARE load-balancing system.

Sits beside the JAX package ``repro`` and mirrors its tree
(``core/care/*``, ``kernels/*``); it imports ``torch`` and numpy and nothing
of ``jax`` or ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``.  The Hopper kernels live in ``csrc/`` and
are built with ``nvcc`` at first use (``kernels/_build.py``).
"""
