"""The port's checkers: ``solver_lint`` (the AST lint CLI), ``check_docs``
(the README's port section) and ``check_bench_schema`` (the port's
``BENCH_*.json`` artifacts). Run each as ``python -m
repro_torch.tools.<name>``."""
