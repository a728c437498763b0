"""Hand-written Hopper kernels of the port, with their plain versions.

``rk_stage`` holds K1-K6 (CUDA source in ``csrc/rk_stage.cu``),
``rmsnorm`` K7, ``flash_attention`` K8, ``ssd_scan`` K9 and ``rg_lru``
K10 (one source each in ``csrc/``); ``ops`` is the entry point (autograd
dispatch of the RK kernels, the serving kernels, the launch counters),
``build`` the nvcc build at first use.
"""
