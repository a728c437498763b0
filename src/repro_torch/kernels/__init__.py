"""Hand-written Hopper kernels of the port, with their plain versions.

``rk_stage`` holds K1/K2 (CUDA source in ``csrc/rk_stage.cu``), ``ops``
their autograd dispatch, ``build`` the nvcc build at first use.
"""
