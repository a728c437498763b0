"""Port benchmarks: the paper's experiments on the port's solver.

Each module is the counterpart of the reference's ``benchmarks/bench_*``
of the same name, prints its row names and has ``run(quick, device)``:
``toy_gradient`` (Fig. 6), ``reverse_error`` (Fig. 4/5), ``method_costs``
(Table 1), ``classification`` (Table 2), ``reliability`` (Table 3),
``solver_robustness`` (Tables 6/7), ``timeseries`` (Table 4) and
``threebody`` (Table 5), and the beyond-paper ones (``node_lm``,
``memory``, ``dense_eval``, ``mali_memory``, ``failure_overhead``,
``batched_solve``, ``serve_node``); ``run`` drives them all.
"""
