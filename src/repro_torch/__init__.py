"""repro_torch — the PyTorch and CUDA port of the ACA Neural-ODE solver.

The JAX package ``repro`` is the reference; this package mirrors its
module layout (``core/``, ``kernels/``, ``models/``, ``configs/``) and is
held against it on identical inputs by ``tests/test_torch_*.py``.
"""
