"""Port benchmarks: the paper's experiments on the port's solver.

``toy_gradient`` is paper Fig. 6 (the counterpart of the reference's
``benchmarks/bench_toy_gradient.py``).
"""
